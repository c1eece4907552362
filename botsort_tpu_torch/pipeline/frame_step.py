"""The per-frame step (port of botsort_tpu/pipeline/frame_step.py).

  uint8 frame -> cv2-exact bilinear resize -> YOLOX -> NMS -> rescale ->
  box hierarchy -> ReID crops -> body and face encoders -> association
  cascade (kernel K1 on the card) -> track store update

All per-frame shapes are fixed (padded slots + masks), as in the JAX
package. The ReID encoders run at a static bucket: the first ``bucket``
body slots are embedded and the rest are zeros, which is exact whenever
the bucket covers the live detections (the host facade guarantees that
by re-running a frame that overflows its bucket).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.models.facereid import FaceReID
from botsort_tpu_torch.models.fastreid import FastReIDSBS, preprocess
from botsort_tpu_torch.models.yolox import YOLOX
from botsort_tpu_torch.ops import hierarchy, nms
from botsort_tpu_torch.ops.crop import crop_and_resize
from botsort_tpu_torch.track.cascade import TrackOutputs, tracker_update
from botsort_tpu_torch.track.state import TrackStore

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
    tracks: TrackOutputs


@dataclasses.dataclass
class ModelBundle:
    """The three networks (eval mode, on one device)."""

    detector: YOLOX
    body_encoder: FastReIDSBS
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
    """Pad (or slice) dim 0 to dp slots."""
    k = arr.shape[0]
    if k >= dp:
        return arr[:dp]
    pad = torch.full((dp - k,) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def _encode_bucket(encode: Callable[[torch.Tensor], torch.Tensor],
                   tlbr: torch.Tensor, bucket: int,
                   out_dim: int) -> torch.Tensor:
    """Embed the first ``bucket`` of tlbr [Dp, 4]; later slots are zeros
    (every consumer of a det feature masks by det validity)."""
    dp = tlbr.shape[0]
    b = min(bucket, dp)
    if b <= 0:
        return torch.zeros((dp, out_dim), dtype=torch.float32,
                           device=tlbr.device)
    return F.pad(encode(tlbr[:b]).float(), (0, 0, 0, dp - b))


def _encode_faces(encode, face_tlbr: torch.Tensor, has_face: torch.Tensor,
                  bucket: int, out_dim: int) -> torch.Tensor:
    """Face embeddings with real-face compaction: real faces sort to a
    prefix so the bucket tracks the face count; every faceless body gets
    encoder(zero crop), read from the first zero-crop slot in the bucket
    (exact iff bucket >= faces + 1 when a faceless live body exists)."""
    dp = face_tlbr.shape[0]
    order = torch.argsort((~has_face).to(torch.int32), stable=True)
    inv = torch.argsort(order)
    n_face = has_face.sum()
    feats = _encode_bucket(encode, face_tlbr[order], bucket, out_dim)
    zcap = max(min(bucket, dp) - 1, 0)
    zero_feat = feats[torch.clamp(n_face, max=zcap)]
    live = (torch.arange(dp, device=feats.device) < n_face)[:, None]
    return torch.where(live, feats, zero_feat[None, :])[inv]


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


def postprocess_detections(cand_boxes: torch.Tensor,
                           cand_scores: torch.Tensor, src_hw,
                           tracker_cfg: TrackerConfig, nms_cfg: NMSConfig,
                           pipe_cfg: PipelineConfig):
    """Candidates [A, 4] / [A, C] in detector-input pixels -> (Detections,
    det_boxes [C, K, 4] in source pixels, det_valid [C, K]): class-aware
    NMS, the truncating rescale and the detector's score filter."""
    dets = nms.multiclass_nms_dense(
        cand_boxes, cand_scores,
        iou_threshold=nms_cfg.iou_threshold,
        score_threshold=nms_cfg.score_threshold,
        max_per_class=nms_cfg.max_boxes_per_class,
        pre_nms_top_k=nms_cfg.pre_nms_top_k)
    det_boxes = _rescale_to_source(dets.boxes, pipe_cfg.detector_input_hw,
                                   src_hw)
    det_valid = dets.valid & (dets.scores > tracker_cfg.det_score_threshold)
    return dets, det_boxes, det_valid


def attach_hierarchy(det_boxes: torch.Tensor, det_valid: torch.Tensor):
    """(face_for_head, head_for_body, hand1_for_body, hand2_for_body):
    faces -> heads, heads -> bodies, hands -> bodies (two per body)."""
    results = hierarchy.greedy_assign_batch([
        (det_boxes[HEADS], det_valid[HEADS],
         det_boxes[FACES], det_valid[FACES], 1),
        (det_boxes[BODIES], det_valid[BODIES],
         det_boxes[HEADS], det_valid[HEADS], 1),
        (det_boxes[BODIES], det_valid[BODIES],
         det_boxes[HANDS], det_valid[HANDS], 2),
    ])
    return results[0][0], results[1][0], results[2][0], results[2][1]


def embed(bundle: ModelBundle, frame_bgr: torch.Tensor,
          det_boxes: torch.Tensor, face_for_head: torch.Tensor,
          head_for_body: torch.Tensor, tracker_cfg: TrackerConfig,
          nms_cfg: NMSConfig, pipe_cfg: PipelineConfig, reid_bucket: int,
          face_bucket: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(body_feats [D, Db], face_feats [D, Df]) for the D tracker body
    slots: body crops through FastReID, and per body its head's face crop
    (an all-zero crop when it has none) through the face encoder."""
    d = _det_width(tracker_cfg, nms_cfg)
    r = pipe_cfg.max_reid_batch
    dp = -(-d // r) * r

    def encode_body(tlbr):
        crops = crop_and_resize(frame_bgr, tlbr, pipe_cfg.body_reid_input_hw)
        return bundle.body_encoder(preprocess(crops))

    body_feats = _encode_bucket(
        encode_body, _pad_slots(det_boxes[BODIES], dp), reid_bucket,
        tracker_cfg.body_feature_dim)[:d]

    hb = _pad_slots(head_for_body, dp, fill=-1).long()
    fb = torch.where(hb >= 0, face_for_head.long()[hb.clamp(min=0)], -1)
    has_face = fb >= 0
    face_tlbr = torch.where(has_face[:, None],
                            det_boxes[FACES][fb.clamp(min=0)], 0.0)

    def encode_face(tlbr):
        crops = crop_and_resize(frame_bgr, tlbr, pipe_cfg.face_reid_input_hw)
        return bundle.face_encoder(crops)

    face_feats = _encode_faces(encode_face, face_tlbr, has_face,
                               face_bucket,
                               tracker_cfg.face_feature_dim)[:d]
    return body_feats, face_feats


@torch.no_grad()
def frame_step(bundle: ModelBundle, store: TrackStore,
               frame_bgr: torch.Tensor, tracker_cfg: TrackerConfig,
               nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
               gmc_affine: Optional[torch.Tensor] = None,
               reid_bucket: Optional[int] = None,
               face_bucket: Optional[int] = None
               ) -> Tuple[TrackStore, FrameResult]:
    """frame_bgr: [H, W, 3] uint8 on the bundle's device. Returns the new
    store and the frame's readback; ``store`` itself is not modified.

    reid_bucket: body crops embedded (None = the full det width, always
    exact). face_bucket: face crops embedded (defaults to reid_bucket).
    ``PipelineConfig.crop_int8`` and ``compute_dtype`` are TPU lowerings
    and are not read: crops interpolate in float32 and the networks run
    in the bundle's dtype.
    """
    src_hw = (frame_bgr.shape[0], frame_bgr.shape[1])
    d = _det_width(tracker_cfg, nms_cfg)
    if reid_bucket is None:
        reid_bucket = d
    if face_bucket is None:
        face_bucket = reid_bucket

    full = torch.tensor([[0.0, 0.0, float(src_hw[1]), float(src_hw[0])]],
                        device=frame_bgr.device)
    det_in = crop_and_resize(frame_bgr, full, pipe_cfg.detector_input_hw)
    cand_boxes, cand_scores = bundle.detector(det_in)
    dets, det_boxes, det_valid = postprocess_detections(
        cand_boxes[0], cand_scores[0], src_hw, tracker_cfg, nms_cfg,
        pipe_cfg)
    face_for_head, head_for_body, hand1_for_body, hand2_for_body = \
        attach_hierarchy(det_boxes, det_valid)
    body_feats, face_feats = embed(
        bundle, frame_bgr, det_boxes, face_for_head, head_for_body,
        tracker_cfg, nms_cfg, pipe_cfg, reid_bucket, face_bucket)
    store, tracks = tracker_update(
        store, det_boxes[BODIES][:d], dets.scores[BODIES][:d],
        det_valid[BODIES][:d], body_feats, face_feats, tracker_cfg,
        gmc_affine)
    result = FrameResult(
        det_boxes=det_boxes,
        det_scores=dets.scores,
        det_valid=det_valid,
        head_for_body=head_for_body,
        face_for_head=face_for_head,
        hand1_for_body=hand1_for_body,
        hand2_for_body=hand2_for_body,
        nms_clipped=dets.clipped,
        tracks=tracks,
    )
    return store, result
