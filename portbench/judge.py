"""Decides ``correct``: the program's own outputs from the measured window,
held stage by stage against the plain reference (portbench/reference/).

For each sampled update the run keeps the frames it took (their index in
the frame pool), the program's track store before it, the FrameResult it
read back and the store after it. The reference then works from the
frames and the pre-update store alone:

1. ``det_gap``: the detector and its decode in float32 on the same
   frames, every anchor's candidate rescaled to source pixels. Each NMS
   survivor the program reports must be one of them: a candidate of its
   class with every coordinate within 2 pixels, and the score gap to it
   (1 where there is none), the worst survivor. The survivors are not
   compared one for one with the reference's: random weights give
   hundreds of anchors nearly equal scores, and their order, hence the
   top-k and the survivors, follows the last bits. Instead NMS is held to
   what it guarantees, on the reference's float32 boxes (in the
   detector's input pixels) of the candidates the survivors matched:
   ``nms_overlap``, how far the largest IoU of two survivors of a class
   lies above the IoU threshold (two survivors of one candidate read 1);
   ``nms_uncovered``, the share of the threshold by which the best IoU
   with a survivor falls short of it (1: no overlap) for the candidate that is covered least among those that
   the reference scores clearly above the program's last survivor of the
   class (above the score threshold where fewer than the most survivors
   are reported) and above its own ``pre_nms_top_k``-th score: each of
   those is a survivor (IoU 1) or suppressed by one. "Clearly" is by
   BAND_TIMES the class's widest score gap of a survivor to its
   candidate, so that the order of the rest is the program's as well;
   ``nms_count_gap``, the survivors a class the program reports against
   the reference's count.
2. ``hier_mismatch``: the box hierarchy, recomputed on the program's own
   detections, must give the same claims (an exact comparison).
3. ``body_cos_gap`` / ``face_cos_gap``: the float32 embeddings of the
   program's own body boxes and their faces, against the program's
   embeddings, which the store after the update holds in every track that
   took a detection (``det_index >= 0``): 1 - cosine, the worst track.
4. ``track_mismatch`` / ``track_gap``: the tracker, one step from the
   program's pre-update store with the program's detections and
   embeddings (the reference's own embeddings for the detections no track
   took), against the program's store and track outputs: the count of
   integer entries that differ (ids, states, matches, frame counters), and
   the largest float gap relative to max(1, |reference|).

Stages 2-4 follow the program from its own state and detections: the
tracker's association of near-equal random-weight embeddings is a
discrete choice that a last-bit difference upstream can flip, so a whole
run of the reference from the first frame would not track the program's
run even when both are right. Stage 1 and the start (the first update of
the window, from an empty store) check what that skips.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from portbench.reference import ops, pipeline, tracker

# A survivor matches a candidate whose every coordinate lies within this
# many source pixels: the rescale's floor turns a coordinate's rounding
# difference into a pixel, at 3 source pixels a detector pixel.
MATCH_PX = 2.0
# The candidates NMS must cover score above the program's last survivor
# by this many times the class's widest score gap of a survivor to its
# candidate. A candidate the program left out wrongly within that band
# would need a score gap three times the widest of the class's survivors'.
BAND_TIMES = 4.0
RESULT_KEYS = ("det_boxes", "det_scores", "det_valid", "face_for_head",
               "head_for_body", "hand1_for_body", "hand2_for_body",
               "tracks.valid", "tracks.tlbr", "tracks.track_id",
               "tracks.score", "tracks.det_index", "tracks.dropped_new")
HIERARCHY = ("face_for_head", "head_for_body", "hand1_for_body",
             "hand2_for_body")
STORE_INT = ("state", "is_activated", "track_id", "frame_id",
             "start_frame", "tracklet_len", "det_index", "next_id",
             "frame_count")
STORE_FLOAT = ("score", "mean", "cov", "body_feat", "body_smooth",
               "face_feat", "face_smooth")
TRACK_INT = ("tracks.valid", "tracks.track_id", "tracks.det_index",
             "tracks.dropped_new")
TRACK_FLOAT = ("tracks.tlbr", "tracks.score")
NUMBERS = ("det_gap", "nms_overlap", "nms_uncovered", "nms_count_gap",
           "hier_mismatch", "body_cos_gap", "face_cos_gap", "track_mismatch",
           "track_gap")
# Not compared; they say how much the NMS numbers saw, over a sample's
# classes and streams: the fewest candidates ``nms_uncovered`` held in a
# class, the narrowest span from the best candidate's score to the
# program's last survivor's, and the candidates the reference's own NMS
# suppressed above its last survivor, in all.
INFO = ("nms_held", "score_span", "ref_suppressed")


def as_store(store, device, batched: bool) -> tracker.TrackStore:
    """Any object with the track store's fields (the program's or the
    reference's) as a reference TrackStore on ``device`` with a leading
    stream dimension."""
    fields = {}
    for name in tracker.TrackStore.__dataclass_fields__:
        value = getattr(store, name, None)
        if value is None:
            fields[name] = None
            continue
        value = torch.as_tensor(value).to(device)
        fields[name] = value if batched else value[None]
    return tracker.TrackStore(**fields)


def as_result(result: Dict[str, np.ndarray], device, batched: bool
              ) -> Dict[str, torch.Tensor]:
    out = {}
    for k in RESULT_KEYS:
        v = torch.as_tensor(np.asarray(result[k])).to(device)
        out[k] = v if batched else v[None]
    return out


def _detections(prog, ref, st: int, c: int, s: pipeline.Settings):
    """({det_gap, nms_overlap, nms_uncovered, nms_count_gap}, and the
    INFO readings) of class ``c`` of stream ``st``'s frame."""
    thr = s.iou_threshold
    keep = prog["det_scores"][st, c] > 0.0
    pb = prog["det_boxes"][st, c][keep]                           # [P, 4]
    ps = prog["det_scores"][st, c][keep]
    cand = ref["cand_scores"][st, :, c]                           # [A]
    boxes_in = ref["cand_boxes_in"][st]                           # [A, 4]
    out = dict.fromkeys(NUMBERS[:4], 0.0)
    mine = boxes_in[:0]
    band = 0.0
    if pb.shape[0]:
        near = (pb[:, None, :] - ref["cand_boxes"][st][None]).abs() \
            .amax(dim=-1) <= MATCH_PX                              # [P, A]
        gap = torch.where(near, (ps[:, None] - cand[None]).abs(),
                          float("inf"))
        best, idx = gap.min(dim=1)
        out["det_gap"] = float(best.clamp(max=1.0).max())
        band = BAND_TIMES * out["det_gap"]
        mine = boxes_in[idx[torch.isfinite(best)]]                # [M, 4]
    if mine.shape[0] > 1:
        iou = ops.iou_matrix(mine, mine)
        iou.fill_diagonal_(0.0)
        out["nms_overlap"] = max(0.0, float(iou.max()) - thr)
    n_ref = int(ref["nms_valid"][st, c].sum())
    out["nms_count_gap"] = float(abs(int(keep.sum()) - n_ref))
    floor = (float(ps.min()) if ps.shape[0] >= s.max_boxes_per_class
             else s.score_threshold)
    top = min(s.pre_nms_top_k, cand.shape[0])
    floor = max(floor, float(torch.topk(cand, top).values[-1]))
    held = cand > floor + band
    if bool(held.any()):
        cover = (ops.iou_matrix(boxes_in[held], mine).amax(dim=1)
                 if mine.shape[0] else torch.zeros_like(cand[held]))
        out["nms_uncovered"] = max(0.0, 1.0 - float(cover.min()) / thr)
    ref_scores = ref["det_scores"][st, c][ref["nms_valid"][st, c]]
    suppressed = (int((cand >= ref_scores.min()).sum()) - n_ref
                  if n_ref else 0)
    span = float(cand.max()) - (float(ps.min()) if ps.shape[0] else 0.0)
    return out, int(held.sum()), span, suppressed


def _cos_gap(prog_feats, ref_feats) -> Optional[float]:
    """The largest 1 - cosine of the row pairs. A zero row (the encoders'
    output for an all-zero crop under zero biases) matches only a zero
    row: gap 0 where both are zero, 1 where one is."""
    if prog_feats.shape[0] == 0:
        return None
    pz = prog_feats.norm(dim=-1) == 0
    rz = ref_feats.norm(dim=-1) == 0
    cos = torch.nn.functional.cosine_similarity(prog_feats, ref_feats, dim=-1)
    gap = torch.where(pz & rz, 0.0, torch.where(pz | rz, 1.0, 1.0 - cos))
    return float(gap.max())


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    if want.numel() == 0:
        return 0.0
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def judge_sample(networks, frames: torch.Tensor, pre, result, post,
                 s: pipeline.Settings) -> Dict[str, Optional[float]]:
    """The numbers of one sampled update: frames [B, H, W, 3] uint8, pre /
    post reference TrackStores and the result dict, all with a leading
    stream dimension, on the reference's device."""
    detector, body_encoder, face_encoder = networks
    b = frames.shape[0]
    d = s.det_width
    out: Dict[str, Optional[float]] = {k: 0.0 for k in NUMBERS}
    out["body_cos_gap"] = out["face_cos_gap"] = None

    ref = pipeline.detect(detector, frames, s)
    held, spans, suppressed = [], [], 0
    for st in range(b):
        for c in range(result["det_scores"].shape[1]):
            nums, n_held, span, n_sup = _detections(result, ref, st, c, s)
            for k, v in nums.items():
                out[k] = max(out[k], v)
            held.append(n_held)
            spans.append(span)
            suppressed += n_sup
    out["nms_held"] = float(min(held))
    out["score_span"] = min(spans)
    out["ref_suppressed"] = float(suppressed)

    claims = pipeline.hierarchy(result["det_boxes"], result["det_valid"])
    out["hier_mismatch"] = float(sum(
        int((want.to(torch.int64) != result[k].to(torch.int64)).sum())
        for k, want in zip(HIERARCHY, claims)))

    body_ref, face_ref = pipeline.embed(
        body_encoder, face_encoder, frames, result["det_boxes"],
        result["face_for_head"], result["head_for_body"], s)
    took = post.det_index >= 0                                    # [B, N]
    rows = took.nonzero(as_tuple=True)
    slot = post.det_index[rows].long()
    for key, prog_all, ref_all in (("body_cos_gap", post.body_feat, body_ref),
                                   ("face_cos_gap", post.face_feat, face_ref)):
        out[key] = _cos_gap(prog_all[rows].float(),
                            ref_all[rows[0], slot].float())

    # The tracker on the program's detections and embeddings.
    body_in, face_in = body_ref.clone(), face_ref.clone()
    body_in[rows[0], slot] = post.body_feat[rows].float()
    face_in[rows[0], slot] = post.face_feat[rows].float()
    dets = {"det_boxes": result["det_boxes"],
            "det_scores": result["det_scores"],
            "det_valid": result["det_valid"]}
    want_store, want_tracks = pipeline.track(pre, dets, body_in[:, :d],
                                             face_in[:, :d], s)
    want = {f"tracks.{k}": v for k, v in want_tracks._asdict().items()}
    mismatch = 0
    gap = 0.0
    for name in STORE_INT:
        mismatch += int((getattr(post, name).to(torch.int64)
                         != getattr(want_store, name).to(torch.int64)).sum())
    for name in TRACK_INT:
        mismatch += int((result[name].to(torch.int64)
                         != want[name].to(torch.int64)).sum())
    for name in STORE_FLOAT:
        gap = max(gap, _rel_gap(getattr(post, name), getattr(want_store,
                                                              name)))
    for name in TRACK_FLOAT:
        gap = max(gap, _rel_gap(result[name], want[name]))
    out["track_mismatch"] = float(mismatch)
    out["track_gap"] = gap
    return out


def combine(per_sample: Sequence[Dict[str, Optional[float]]]
            ) -> Dict[str, Optional[float]]:
    """The worst reading of each number over the samples (None where no
    sample had anything to compare)."""
    out: Dict[str, Optional[float]] = {}
    for k in NUMBERS:
        vals = [r[k] for r in per_sample if r.get(k) is not None]
        out[k] = max(vals) if vals else None
    return out


def info(per_sample: Sequence[Dict[str, Optional[float]]]
         ) -> Dict[str, list]:
    """[least, most] of each INFO count over the samples."""
    return {k: [min(r[k] for r in per_sample), max(r[k] for r in per_sample)]
            for k in INFO if per_sample}


def checks(readings: Dict[str, Optional[float]], limits: Dict[str, float],
           failed: int):
    """[(name, value, limit)] for every limited number, ``failed`` first;
    and whether all hold. A limited number with no reading fails."""
    rows = [("failed", float(failed), 0.0)]
    rows += [(k, readings.get(k), float(v)) for k, v in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return rows, ok
