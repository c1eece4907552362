"""The per-frame step (port of botsort_tpu/pipeline/frame_step.py).

  uint8 frames -> cv2-style bilinear resize (kernel K7) -> YOLOX -> NMS ->
  rescale -> box hierarchy -> ReID crops (K7) -> body and face encoders ->
  association cascade (kernel K1 at one stream, K2 at B on the card) ->
  track store update

``frame_step_batched`` steps B independent streams at once, every stage
batched over the stream axis; ``frame_step`` and the single-frame stage
functions are its one-stream case. ``frame_step_batched_temporal`` takes T
consecutive frames per stream: perception over the B x T frames as one
batch, then T chained cascades (``frame_step_temporal`` is one stream's).
All per-frame shapes are fixed (padded slots + masks), as in the JAX
package. Between the frames coming in and the FrameResult going out a
step only enqueues work on the device: no stage reads a value back (the
JAX package's step is one jitted program), so a step can be captured in a
CUDA graph and replayed (pipeline/graphed.py). The ReID encoders run at a
static bucket: the first ``bucket`` body slots of every stream are
embedded and the rest are zeros, which is exact whenever the bucket covers
each stream's live detections (the host facades guarantee that by
re-running a step that overflows its bucket); or, with None buckets
(``PipelineConfig.host_bucket_dispatch=False``), at the bucket the live
count picks on the device, as the JAX package's ``lax.switch`` does
(pipeline/switch.py: conditional graph nodes on the card).

The stages call ``utils/profiling.py::stage_mark`` at their boundaries
(the step's start, then after detect, nms, hierarchy, embed and track),
and ``part_mark("body_encoder")`` before and after the body crops and the
body encoder, outside any switch branch; the marks record timing events
only while a traced facade enqueues the step, and are no-ops otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.models.facereid import FaceReID
from botsort_tpu_torch.models.fastreid import preprocess
from botsort_tpu_torch.models.yolox import YOLOX
from botsort_tpu_torch.ops import hierarchy, nms
from botsort_tpu_torch.ops.crop import _crop
from botsort_tpu_torch.ops.crop import crop_and_resize  # noqa: F401
from botsort_tpu_torch.pipeline import switch
from botsort_tpu_torch.track.cascade import (
    TrackOutputs,
    tracker_update_batched,
)
from botsort_tpu_torch.track.state import TrackStore
from botsort_tpu_torch.utils.consts import const
from botsort_tpu_torch.utils.profiling import part_mark, stage_mark

BODIES, HEADS, HANDS, FACES = 0, 1, 2, 3


class FrameResult(NamedTuple):
    """Everything the host reads per frame. Detections are per-class
    padded slots (0 body, 1 head, 2 hand, 3 face) in source-image integer
    pixel coordinates."""

    det_boxes: torch.Tensor      # [C, K, 4] float32 (integer-valued)
    det_scores: torch.Tensor     # [C, K]
    det_valid: torch.Tensor      # [C, K] bool
    head_for_body: torch.Tensor  # [K] int32 head det slot or -1
    face_for_head: torch.Tensor  # [K] int32 face det slot or -1
    hand1_for_body: torch.Tensor  # [K] int32
    hand2_for_body: torch.Tensor  # [K] int32
    nms_clipped: torch.Tensor    # [C] bool — NMS pre-top-k saturated
    # [] bool — the NMS fixpoint was reached: always, since it runs to its
    # end (ops/nms.py); kept for the packed layout.
    nms_converged: torch.Tensor
    tracks: TrackOutputs


@dataclasses.dataclass
class ModelBundle:
    """The three networks (eval mode, on one device). The body encoder is
    any of the body families (models/fastreid.py::FastReIDSBS,
    models/transreid.py::TransReID): crops [N, H, W, 3] as ``preprocess``
    makes them -> [N, feature_dim] L2-normalised."""

    detector: YOLOX
    body_encoder: nn.Module
    face_encoder: FaceReID

    @property
    def device(self) -> torch.device:
        return next(self.detector.parameters()).device


def _det_width(tracker_cfg: TrackerConfig, nms_cfg: NMSConfig) -> int:
    """Body-detection slots embedded and associated per frame."""
    return min(tracker_cfg.max_dets, nms_cfg.max_boxes_per_class)


def reid_bucket_set(tracker_cfg: TrackerConfig, nms_cfg: NMSConfig,
                    pipe_cfg: PipelineConfig) -> List[int]:
    """The static ReID bucket sizes, ascending: none, the small batch, a
    mid step and the det width ({0, 16, 32, 50} at the defaults)."""
    d = _det_width(tracker_cfg, nms_cfg)
    r = pipe_cfg.max_reid_batch
    return sorted({0, min(r, d), min(2 * r, d), d})


def _pad_slots(arr: torch.Tensor, dp: int, fill=0) -> torch.Tensor:
    """Pad (or slice) dim 1, the slot axis of [B, K, ...], to dp slots."""
    k = arr.shape[1]
    if k >= dp:
        return arr[:, :dp]
    pad = torch.full((arr.shape[0], dp - k) + tuple(arr.shape[2:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=1)


def _encode_bucket(encode: Callable[[torch.Tensor], torch.Tensor],
                   tlbr: torch.Tensor, bucket: int,
                   out_dim: int) -> torch.Tensor:
    """Embed the first ``bucket`` slots of every frame's tlbr [B, Dp, 4]
    (one encoder batch of B x bucket crops); later slots are zeros (every
    consumer of a det feature masks by det validity)."""
    bsz, dp = tlbr.shape[0], tlbr.shape[1]
    b = min(bucket, dp)
    if b <= 0:
        return torch.zeros((bsz, dp, out_dim), dtype=torch.float32,
                           device=tlbr.device)
    return F.pad(encode(tlbr[:, :b]).float(), (0, 0, 0, dp - b))


def _encode_switch(encode, tlbr: torch.Tensor, n_live: torch.Tensor,
                   chunk: int, out_dim: int) -> torch.Tensor:
    """The JAX ``_encode_chunked_axis1`` without a static bucket: tlbr
    [B, Dp, 4]; the live count n_live (int32 [], on the device) picks no
    crop, the first ``chunk`` slots of every frame or all Dp
    (pipeline/switch.py); the slots beyond the taken branch are zeros."""
    bsz, dp = tlbr.shape[0], tlbr.shape[1]
    out = torch.zeros((bsz, dp, out_dim), dtype=torch.float32,
                      device=tlbr.device)
    switch.bucket_switch(n_live, switch.bucket_branches(encode, dp, chunk),
                         (tlbr,), out)
    return out


def _encode_faces(encode, face_tlbr: torch.Tensor, has_face: torch.Tensor,
                  bucket: Optional[int], out_dim: int,
                  n_live: Optional[torch.Tensor] = None,
                  chunk: int = 0) -> torch.Tensor:
    """Face embeddings with real-face compaction, per frame of [B, Dp]:
    real faces sort to a prefix so the bucket tracks the face count (one
    bucket for all frames, sized by the largest face count); every
    faceless body gets encoder(zero crop), read from its frame's first
    zero-crop slot in the bucket (exact iff bucket >= faces + 1 when a
    faceless live body exists). ``bucket`` None: the in-program switch on
    the largest face count + 1 (0 where ``n_live``, the live body count,
    is 0), as the JAX ``_encode_faces_axis1``."""
    dp = face_tlbr.shape[1]
    order = torch.argsort((~has_face).to(torch.int32), dim=1, stable=True)
    inv = torch.argsort(order, dim=1)
    n_face = has_face.sum(dim=1)                                  # [B]
    sorted_tlbr = torch.gather(face_tlbr, 1,
                               order[..., None].expand(-1, -1, 4))
    if bucket is None:
        # +1 keeps one zero-crop slot (the encoder(0) source) inside the
        # taken branch; no live body, no crop.
        n_eff = torch.where(n_live > 0, n_face.max() + 1,
                            torch.zeros_like(n_face[0])).to(torch.int32)
        feats = _encode_switch(encode, sorted_tlbr, n_eff, chunk, out_dim)
        zcap = dp - 1
    else:
        feats = _encode_bucket(encode, sorted_tlbr, bucket, out_dim)
        zcap = max(min(bucket, dp) - 1, 0)
    frame = torch.arange(feats.shape[0], device=feats.device)
    zero_feat = feats[frame, torch.clamp(n_face, max=zcap)]       # [B, out]
    live = torch.arange(dp, device=feats.device) < n_face[:, None]
    feats = torch.where(live[..., None], feats, zero_feat[:, None, :])
    return torch.gather(feats, 1, inv[..., None].expand(-1, -1, out_dim))


def _rescale_to_source(boxes: torch.Tensor, in_hw, src_hw) -> torch.Tensor:
    """Detector-input coords -> source-image integer coords: clamp to the
    input window, scale, truncate."""
    in_h, in_w = in_hw
    src_h, src_w = src_hw
    x1 = torch.floor(torch.clamp(boxes[..., 0], min=0.0) * (src_w / in_w))
    y1 = torch.floor(torch.clamp(boxes[..., 1], min=0.0) * (src_h / in_h))
    x2 = torch.floor(torch.clamp(boxes[..., 2], max=in_w) * (src_w / in_w))
    y2 = torch.floor(torch.clamp(boxes[..., 3], max=in_h) * (src_h / in_h))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _first(result):
    """Frame 0 of a batched tuple of tensors, in the same tuple type."""
    return type(result)(*(x[0] for x in result))


def stream_result(result: FrameResult, s: int) -> FrameResult:
    """Stream s of a batched FrameResult (tensors or numpy arrays)."""
    tracks = TrackOutputs(*(x[s] for x in result.tracks))
    return FrameResult(*(x[s] for x in result[:-1]), tracks)


def postprocess_detections_batched(cand_boxes: torch.Tensor,
                                   cand_scores: torch.Tensor, src_hw,
                                   tracker_cfg: TrackerConfig,
                                   nms_cfg: NMSConfig,
                                   pipe_cfg: PipelineConfig):
    """Candidates [B, A, 4] / [B, A, C] in detector-input pixels ->
    (Detections [B, ...], det_boxes [B, C, K, 4] in source pixels,
    det_valid [B, C, K]): class-aware NMS over all frames and classes at
    once (the suppression fixpoint: kernel K8 on the card), the truncating
    rescale and the detector's score filter."""
    dets = nms.multiclass_nms_dense_batched(
        cand_boxes, cand_scores,
        iou_threshold=nms_cfg.iou_threshold,
        score_threshold=nms_cfg.score_threshold,
        max_per_class=nms_cfg.max_boxes_per_class,
        pre_nms_top_k=nms_cfg.pre_nms_top_k)
    det_boxes = _rescale_to_source(dets.boxes, pipe_cfg.detector_input_hw,
                                   src_hw)
    det_valid = dets.valid & (dets.scores > tracker_cfg.det_score_threshold)
    return dets, det_boxes, det_valid


def postprocess_detections(cand_boxes: torch.Tensor,
                           cand_scores: torch.Tensor, src_hw,
                           tracker_cfg: TrackerConfig, nms_cfg: NMSConfig,
                           pipe_cfg: PipelineConfig):
    """One frame: candidates [A, 4] / [A, C] -> (Detections, det_boxes
    [C, K, 4], det_valid [C, K])."""
    dets, det_boxes, det_valid = postprocess_detections_batched(
        cand_boxes[None], cand_scores[None], src_hw, tracker_cfg, nms_cfg,
        pipe_cfg)
    return _first(dets), det_boxes[0], det_valid[0]


def attach_hierarchy_batched(det_boxes: torch.Tensor,
                             det_valid: torch.Tensor):
    """(face_for_head, head_for_body, hand1_for_body, hand2_for_body),
    each [B, K], for det_boxes [B, C, K, 4]: faces -> heads, heads ->
    bodies, hands -> bodies (two per body). The 3B problems run as one
    lockstep batch."""
    problems = []
    for s in range(det_boxes.shape[0]):
        boxes, valid = det_boxes[s], det_valid[s]
        problems += [
            (boxes[HEADS], valid[HEADS], boxes[FACES], valid[FACES], 1),
            (boxes[BODIES], valid[BODIES], boxes[HEADS], valid[HEADS], 1),
            (boxes[BODIES], valid[BODIES], boxes[HANDS], valid[HANDS], 2),
        ]
    res = hierarchy.greedy_assign_batch(problems)
    return tuple(torch.stack(picks) for picks in (
        [r[0] for r in res[0::3]], [r[0] for r in res[1::3]],
        [r[0] for r in res[2::3]], [r[1] for r in res[2::3]]))


def attach_hierarchy(det_boxes: torch.Tensor, det_valid: torch.Tensor):
    """One frame's (face_for_head, head_for_body, hand1_for_body,
    hand2_for_body) for det_boxes [C, K, 4]."""
    return tuple(x[0] for x in attach_hierarchy_batched(det_boxes[None],
                                                        det_valid[None]))


def embed_batched(bundle: ModelBundle, frames_bgr: torch.Tensor,
                  det_boxes: torch.Tensor, face_for_head: torch.Tensor,
                  head_for_body: torch.Tensor, tracker_cfg: TrackerConfig,
                  nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
                  reid_bucket: Optional[int], face_bucket: Optional[int],
                  det_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(body_feats [B, D, Db], face_feats [B, D, Df]) for the D tracker
    body slots of B frames: body crops through FastReID, and per body its
    head's face crop (an all-zero crop when it has none) through the face
    encoder. Each encoder runs once, on the crops of all B frames. A None
    bucket switches on the device between no crop, ``max_reid_batch``
    slots and the padded width (pipeline/switch.py), by the largest live
    body count over the frames, which needs ``det_valid`` [B, C, K]."""
    d = _det_width(tracker_cfg, nms_cfg)
    r = pipe_cfg.max_reid_batch
    dp = -(-d // r) * r
    bsz = frames_bgr.shape[0]

    def encoded(encoder, prep, hw):
        def run(tlbr):                                            # [B, k, 4]
            crops = _crop(frames_bgr, tlbr, hw, pipe_cfg)
            feats = encoder(prep(crops.flatten(0, 1)))
            return feats.reshape(bsz, tlbr.shape[1], -1)
        return run

    n_live = None
    if reid_bucket is None or face_bucket is None:
        n_live = det_valid[:, BODIES, :d].sum(dim=1).max().to(torch.int32)
    encode_body = encoded(bundle.body_encoder, preprocess,
                          pipe_cfg.body_reid_input_hw)
    body_tlbr = _pad_slots(det_boxes[:, BODIES], dp)
    part_mark("body_encoder")
    if reid_bucket is None:
        body_feats = _encode_switch(encode_body, body_tlbr, n_live, r,
                                    tracker_cfg.body_feature_dim)
    else:
        body_feats = _encode_bucket(encode_body, body_tlbr, reid_bucket,
                                    tracker_cfg.body_feature_dim)
    part_mark("body_encoder")
    body_feats = body_feats[:, :d]

    hb = _pad_slots(head_for_body, dp, fill=-1).long()
    fb = torch.where(hb >= 0,
                     torch.gather(face_for_head.long(), 1, hb.clamp(min=0)),
                     -1)
    has_face = fb >= 0
    faces = torch.gather(det_boxes[:, FACES], 1,
                         fb.clamp(min=0)[..., None].expand(-1, -1, 4))
    face_tlbr = torch.where(has_face[..., None], faces, 0.0)
    face_feats = _encode_faces(
        encoded(bundle.face_encoder, lambda x: x,
                pipe_cfg.face_reid_input_hw),
        face_tlbr, has_face, face_bucket, tracker_cfg.face_feature_dim,
        n_live, r)[:, :d]
    return body_feats, face_feats


def embed(bundle: ModelBundle, frame_bgr: torch.Tensor,
          det_boxes: torch.Tensor, face_for_head: torch.Tensor,
          head_for_body: torch.Tensor, tracker_cfg: TrackerConfig,
          nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
          reid_bucket: Optional[int], face_bucket: Optional[int],
          det_valid: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's (body_feats [D, Db], face_feats [D, Df])."""
    body, face = embed_batched(
        bundle, frame_bgr[None], det_boxes[None], face_for_head[None],
        head_for_body[None], tracker_cfg, nms_cfg, pipe_cfg, reid_bucket,
        face_bucket, None if det_valid is None else det_valid[None])
    return body[0], face[0]


class Perception(NamedTuple):
    """Everything a step computes before the cascade, for G frames."""

    dets: nms.Detections         # [G, ...] NMS output, detector pixels
    det_boxes: torch.Tensor      # [G, C, K, 4] source pixels
    det_valid: torch.Tensor      # [G, C, K]
    face_for_head: torch.Tensor  # [G, K]
    head_for_body: torch.Tensor
    hand1_for_body: torch.Tensor
    hand2_for_body: torch.Tensor
    body_feats: torch.Tensor     # [G, D, Db]
    face_feats: torch.Tensor     # [G, D, Df]


def _perception_batched(bundle: ModelBundle, frames_bgr: torch.Tensor,
                        tracker_cfg: TrackerConfig, nms_cfg: NMSConfig,
                        pipe_cfg: PipelineConfig, reid_bucket: Optional[int],
                        face_bucket: Optional[int]) -> Perception:
    """The stages before the cascade, batched over the G frames of
    frames_bgr [G, H, W, 3]: resize, detector, NMS, hierarchy and both
    encoders (the JAX package's ``_perception_batched``). A None bucket is
    the in-program switch on the largest live count over the G frames; a
    None face bucket takes the body bucket, as in JAX."""
    g = frames_bgr.shape[0]
    src_hw = (frames_bgr.shape[1], frames_bgr.shape[2])
    if face_bucket is None:
        face_bucket = reid_bucket
    stage_mark("start")
    full = const((0.0, 0.0, float(src_hw[1]), float(src_hw[0])),
                 torch.float32, frames_bgr.device).expand(g, 1, 4)
    det_in = _crop(frames_bgr, full, pipe_cfg.detector_input_hw,
                   pipe_cfg)[:, 0]
    cand_boxes, cand_scores = bundle.detector(det_in)
    stage_mark("detect")
    dets, det_boxes, det_valid = postprocess_detections_batched(
        cand_boxes, cand_scores, src_hw, tracker_cfg, nms_cfg, pipe_cfg)
    stage_mark("nms")
    face_for_head, head_for_body, hand1_for_body, hand2_for_body = \
        attach_hierarchy_batched(det_boxes, det_valid)
    stage_mark("hierarchy")
    body_feats, face_feats = embed_batched(
        bundle, frames_bgr, det_boxes, face_for_head, head_for_body,
        tracker_cfg, nms_cfg, pipe_cfg, reid_bucket, face_bucket, det_valid)
    stage_mark("embed")
    return Perception(dets, det_boxes, det_valid, face_for_head,
                      head_for_body, hand1_for_body, hand2_for_body,
                      body_feats, face_feats)


def _frame_result(p: Perception, tracks: TrackOutputs, shape=None
                  ) -> FrameResult:
    """The FrameResult of a perception and its tracks; ``shape`` = (B, T)
    folds the perception's leading B*T into [B, T]."""
    fold = (lambda x: x) if shape is None else (
        lambda x: x.reshape(shape + tuple(x.shape[1:])))
    return FrameResult(
        det_boxes=fold(p.det_boxes),
        det_scores=fold(p.dets.scores),
        det_valid=fold(p.det_valid),
        head_for_body=fold(p.head_for_body),
        face_for_head=fold(p.face_for_head),
        hand1_for_body=fold(p.hand1_for_body),
        hand2_for_body=fold(p.hand2_for_body),
        nms_clipped=fold(p.dets.clipped),
        nms_converged=fold(p.dets.converged),
        tracks=tracks,
    )


def switch_values(res: FrameResult, tracker_cfg: TrackerConfig,
                  nms_cfg: NMSConfig, pipe_cfg: PipelineConfig
                  ) -> Tuple[int, int]:
    """The values of a None-bucket step's two switches, the body's then the
    face's, recomputed on the host from its FrameResult (numpy arrays, any
    leading frame dimensions) exactly as the step computed them on the
    device: the largest live body count n_live, and the largest face count
    over the padded slots plus one (0 where n_live is 0)."""
    d = _det_width(tracker_cfg, nms_cfg)
    r = pipe_cfg.max_reid_batch
    dp = -(-d // r) * r
    valid = np.asarray(res.det_valid)[..., BODIES, :d]
    n_live = int(valid.sum(axis=-1).max())
    hb = np.asarray(res.head_for_body)[..., :dp]
    if hb.shape[-1] < dp:
        hb = np.concatenate([hb, np.full(hb.shape[:-1] + (
            dp - hb.shape[-1],), -1, hb.dtype)], axis=-1)
    ffh = np.asarray(res.face_for_head)
    fb = np.where(hb >= 0, np.take_along_axis(ffh, np.clip(hb, 0, None),
                                              axis=-1), -1)
    n_face = int((fb >= 0).sum(axis=-1).max())
    return n_live, (n_face + 1 if n_live > 0 else 0)


@torch.no_grad()
def frame_step_batched(bundle: ModelBundle, stores: TrackStore,
                       frames_bgr: torch.Tensor, tracker_cfg: TrackerConfig,
                       nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
                       gmc_affines: Optional[torch.Tensor] = None,
                       reid_bucket: Optional[int] = None,
                       face_bucket: Optional[int] = None
                       ) -> Tuple[TrackStore, FrameResult]:
    """B independent streams through one step: frames_bgr [B, H, W, 3]
    uint8 on the bundle's device, one frame per stream; stores carries a
    leading [B] on every field (track.state.empty_stores). Returns the new
    stores and a FrameResult whose every field has a leading [B];
    ``stores`` itself is not modified.

    Perception runs batched over the streams (the detector at batch B,
    NMS over B x C problems, the hierarchy as 3B lockstep problems, each
    encoder once on the crops of all frames), then the B cascades run as
    one ``tracker_update_batched`` (one launch of kernel K2 on the card).
    reid_bucket: body crops embedded per stream (None = the bucket the
    largest live count picks on the device, as the JAX package's in-program
    switch; exact either way while the bucket covers the live bodies);
    face_bucket: face crops per stream (defaults to reid_bucket).
    gmc_affines: optional [B, 2, 3] per-stream camera motion. The NMS
    fixpoint runs to its end (kernel K8 on the card). The detector input
    and the crops interpolate as ``PipelineConfig.compute_dtype`` and
    ``crop_int8`` say (ops/crop.py, kernel K7 on the card); the networks
    run in the bundle's dtype.
    """
    d = _det_width(tracker_cfg, nms_cfg)
    p = _perception_batched(bundle, frames_bgr, tracker_cfg, nms_cfg,
                            pipe_cfg, reid_bucket, face_bucket)
    stores, tracks = tracker_update_batched(
        stores, p.det_boxes[:, BODIES, :d], p.dets.scores[:, BODIES, :d],
        p.det_valid[:, BODIES, :d], p.body_feats, p.face_feats, tracker_cfg,
        gmc_affines)
    result = _frame_result(p, tracks)
    stage_mark("track")
    return stores, result


def frame_step(bundle: ModelBundle, store: TrackStore,
               frame_bgr: torch.Tensor, tracker_cfg: TrackerConfig,
               nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
               gmc_affine: Optional[torch.Tensor] = None,
               reid_bucket: Optional[int] = None,
               face_bucket: Optional[int] = None
               ) -> Tuple[TrackStore, FrameResult]:
    """One stream's step: frame_bgr [H, W, 3] uint8 on the bundle's
    device, a store without the stream dimension, gmc_affine [2, 3] or
    None. ``frame_step_batched`` at B = 1."""
    stores, result = frame_step_batched(
        bundle, store.map(lambda x: x[None]), frame_bgr[None], tracker_cfg,
        nms_cfg, pipe_cfg, None if gmc_affine is None else gmc_affine[None],
        reid_bucket, face_bucket)
    return stores.map(lambda x: x[0]), stream_result(result, 0)


@torch.no_grad()
def frame_step_batched_temporal(bundle: ModelBundle, stores: TrackStore,
                                frames_bgr: torch.Tensor,
                                tracker_cfg: TrackerConfig,
                                nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
                                gmc_affines: Optional[torch.Tensor] = None,
                                reid_bucket: Optional[int] = None,
                                face_bucket: Optional[int] = None
                                ) -> Tuple[TrackStore, FrameResult]:
    """B streams x T consecutive frames each in one step: frames_bgr
    [B, T, H, W, 3] uint8, stores with a leading [B], gmc_affines
    [B, T, 2, 3] or None. Perception runs batched over all B x T frames
    (the detector at batch B*T, each encoder once on every frame's crops);
    then the cascades run as T chained ``tracker_update_batched`` calls
    through the stores (T launches of kernel K2 on the card). Returns the
    stores after the last frame and a FrameResult whose every field has a
    leading [B, T]. Equal to T ``frame_step_batched`` calls on perception
    of the same batch size; a stream waits T - 1 frames longer for its
    first result."""
    b, t = frames_bgr.shape[0], frames_bgr.shape[1]
    d = _det_width(tracker_cfg, nms_cfg)
    p = _perception_batched(bundle, frames_bgr.flatten(0, 1), tracker_cfg,
                            nms_cfg, pipe_cfg, reid_bucket, face_bucket)

    def at(x, tt):  # [B*T, ...] -> frame tt of every stream, [B, ...]
        return x.reshape((b, t) + tuple(x.shape[1:]))[:, tt]

    outs = []
    for tt in range(t):
        stores, tracks = tracker_update_batched(
            stores, at(p.det_boxes, tt)[:, BODIES, :d],
            at(p.dets.scores, tt)[:, BODIES, :d],
            at(p.det_valid, tt)[:, BODIES, :d], at(p.body_feats, tt),
            at(p.face_feats, tt), tracker_cfg,
            None if gmc_affines is None else gmc_affines[:, tt])
        outs.append(tracks)
    tracks = TrackOutputs(*(torch.stack(xs, dim=1) for xs in zip(*outs)))
    result = _frame_result(p, tracks, (b, t))
    stage_mark("track")
    return stores, result


def frame_step_temporal(bundle: ModelBundle, store: TrackStore,
                        frames_bgr: torch.Tensor, tracker_cfg: TrackerConfig,
                        nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
                        reid_bucket: Optional[int] = None,
                        face_bucket: Optional[int] = None
                        ) -> Tuple[TrackStore, FrameResult]:
    """T consecutive frames [T, H, W, 3] of one stream in one step: the
    FrameResult's fields carry a leading [T].
    ``frame_step_batched_temporal`` at B = 1."""
    stores, result = frame_step_batched_temporal(
        bundle, store.map(lambda x: x[None]), frames_bgr[None], tracker_cfg,
        nms_cfg, pipe_cfg, None, reid_bucket, face_bucket)
    return stores.map(lambda x: x[0]), stream_result(result, 0)
