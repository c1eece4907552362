"""Fixed-shape class-aware NMS (port of botsort_tpu/ops/nms.py).

Per class: the top ``pre_nms_top_k`` candidates by score, their IoU
matrix, greedy suppression as a fixpoint (keep[j] = valid[j] and no kept
higher-ranked box with IoU > threshold), then the first ``max_outputs``
survivors compacted into fixed slots — ONNX NonMaxSuppression semantics.
All classes of all frames run together as one batch.

The fixpoint runs a fixed number of iterations and never asks the host
whether it is done (the JAX package's is a device-side ``while_loop``):
``Detections.converged`` says per frame whether the last iteration changed
nothing, and travels to the host with the rest of the frame's result. The
fixpoint is unique and iteration i settles every box of rank <= i, so a
converged frame holds exactly the greedy result; the host re-runs a frame
that did not converge with ``iters`` = ``pre_nms_top_k``, which always
does. ``FIXPOINT_ITERS`` iterations settle every suppression chain of up
to that many boxes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from botsort_tpu_torch.ops.boxes import iou_matrix

# Iterations of the suppression fixpoint per frame. Chains (a box kept
# because its suppressor was itself suppressed, and so on) are short in
# real scenes; a longer one clears ``converged`` and the frame is re-run.
FIXPOINT_ITERS = 16


class Detections(NamedTuple):
    """boxes [..., C, K, 4] tlbr; scores [..., C, K]; valid [..., C, K]
    bool; clipped [..., C] bool (more than pre_nms_top_k candidates
    cleared the threshold); converged [...] bool (the suppression
    fixpoint was reached in every class: the result is exact). The
    leading dimension, where present, is the frame."""

    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor
    clipped: torch.Tensor
    converged: torch.Tensor


def _nms_batched(boxes_tlbr: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, iou_threshold: float,
                 score_threshold: float, max_outputs: int,
                 pre_nms_top_k: int, iters: Optional[int] = None
                 ) -> Detections:
    """G frames x C classes as one batch: boxes [G, N, 4], each frame's
    shared by its classes; scores/valid [G, C, N]. The suppression
    fixpoint runs ``iters`` iterations (FIXPOINT_ITERS by default, at most
    the candidate count, which always converges) for all G x C problems at
    once, with no readback."""
    g, c, n = scores.shape
    k = max_outputs
    dev = scores.device
    neg = -1.0
    above = valid & (scores > score_threshold)
    s = torch.where(above, scores, torch.full_like(scores, neg))
    p = min(pre_nms_top_k, n)
    clipped = above.sum(dim=-1) > p
    # jax.lax.top_k order: descending, lower index first on equal scores.
    # A stable descending sort gives exactly that; torch.topk does not
    # promise it.
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices[
        ..., :p]
    top_s = torch.gather(s, -1, order)                       # [G, C, P]
    frame = torch.arange(g, device=dev)[:, None, None]
    top_boxes = boxes_tlbr[frame, order]                     # [G, C, P, 4]
    top_valid = top_s > neg

    iou = iou_matrix(top_boxes, top_boxes)                   # [G, C, P, P]
    rank = torch.arange(p, device=dev)
    dominates = ((iou > iou_threshold)
                 & (rank[:, None] < rank[None, :])
                 & top_valid[..., :, None] & top_valid[..., None, :])
    # Greedy NMS as a fixpoint: iteration i settles every box of rank
    # <= i, so the unique greedy result is reached within (longest
    # suppression chain) iterations and p - 1 always suffice; a converged
    # problem stays fixed while the others finish.
    n_iters = max(1, min(FIXPOINT_ITERS if iters is None else iters, p))
    keep = prev = top_valid
    for _ in range(n_iters):
        prev = keep
        keep = top_valid & ~(dominates & keep[..., :, None]).any(dim=-2)
    converged = (keep == prev).flatten(1).all(dim=1)             # [G]

    rank_kept = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    dest = torch.where(keep & (rank_kept < k), rank_kept,
                       torch.full_like(rank_kept, k))
    out_boxes = torch.zeros((g, c, k + 1, 4), dtype=top_boxes.dtype,
                            device=dev)
    out_boxes.scatter_(2, dest[..., None].expand(-1, -1, -1, 4), top_boxes)
    out_scores = torch.zeros((g, c, k + 1), dtype=top_s.dtype, device=dev)
    out_scores.scatter_(2, dest, torch.where(keep, top_s,
                                             torch.zeros_like(top_s)))
    n_keep = keep.sum(dim=-1, keepdim=True)
    out_valid = torch.arange(k, device=dev) < torch.clamp(n_keep, max=k)
    return Detections(out_boxes[..., :k, :], out_scores[..., :k], out_valid,
                      clipped, converged)


def nms_single_class(boxes_tlbr: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float,
                     score_threshold: float, max_outputs: int,
                     pre_nms_top_k: int = 512, iters: Optional[int] = None):
    """One class: boxes [N, 4], scores [N], valid [N] -> (boxes [K, 4],
    scores [K], valid [K], clipped [], converged []) in descending score
    order."""
    det = _nms_batched(boxes_tlbr[None], scores[None, None],
                       valid[None, None], iou_threshold, score_threshold,
                       max_outputs, pre_nms_top_k, iters)
    return det.boxes[0, 0], det.scores[0, 0], det.valid[0, 0], \
        det.clipped[0, 0], det.converged[0]


def multiclass_nms_dense_batched(boxes_tlbr: torch.Tensor,
                                 class_scores: torch.Tensor,
                                 iou_threshold: float,
                                 score_threshold: float, max_per_class: int,
                                 pre_nms_top_k: int = 512,
                                 iters: Optional[int] = None) -> Detections:
    """B frames, every anchor scored for every class: boxes [B, A, 4],
    class_scores [B, A, C] -> Detections with [B, C, K] slots."""
    scores = class_scores.transpose(-1, -2)
    valid = torch.ones_like(scores, dtype=torch.bool)
    return _nms_batched(boxes_tlbr, scores, valid, iou_threshold,
                        score_threshold, max_per_class, pre_nms_top_k, iters)


def multiclass_nms_dense(boxes_tlbr: torch.Tensor,
                         class_scores: torch.Tensor, iou_threshold: float,
                         score_threshold: float, max_per_class: int,
                         pre_nms_top_k: int = 512,
                         iters: Optional[int] = None) -> Detections:
    """One frame: boxes [A, 4], class_scores [A, C] -> Detections with K =
    max_per_class slots per class (``multiclass_nms_dense_batched`` at
    B = 1)."""
    det = multiclass_nms_dense_batched(
        boxes_tlbr[None], class_scores[None], iou_threshold,
        score_threshold, max_per_class, pre_nms_top_k, iters)
    return Detections(*(x[0] for x in det))
