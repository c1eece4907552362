"""Fixed-shape class-aware NMS (port of botsort_tpu/ops/nms.py).

Per class: the top ``pre_nms_top_k`` candidates by score, their IoU
matrix, greedy suppression as a fixpoint (keep[j] = valid[j] and no kept
higher-ranked box with IoU > threshold), then the first ``max_outputs``
survivors compacted into fixed slots — ONNX NonMaxSuppression semantics.
All classes run together as one batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from botsort_tpu_torch.ops.boxes import iou_matrix


class Detections(NamedTuple):
    """boxes [C, K, 4] tlbr; scores [C, K]; valid [C, K] bool; clipped [C]
    bool (more than pre_nms_top_k candidates cleared the threshold)."""

    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor
    clipped: torch.Tensor


def _nms_batched(boxes_tlbr: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, iou_threshold: float,
                 score_threshold: float, max_outputs: int,
                 pre_nms_top_k: int) -> Detections:
    """boxes [N, 4] shared by every class; scores/valid [C, N]."""
    c, n = scores.shape
    k = max_outputs
    neg = -1.0
    above = valid & (scores > score_threshold)
    s = torch.where(above, scores, torch.full_like(scores, neg))
    p = min(pre_nms_top_k, n)
    clipped = above.sum(dim=1) > p
    # jax.lax.top_k order: descending, lower index first on equal scores.
    # A stable descending sort gives exactly that; torch.topk does not
    # promise it.
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :p]
    top_s = torch.gather(s, 1, order)                        # [C, P]
    top_boxes = boxes_tlbr[order]                            # [C, P, 4]
    top_valid = top_s > neg

    iou = iou_matrix(top_boxes, top_boxes)                   # [C, P, P]
    rank = torch.arange(p, device=scores.device)
    dominates = ((iou > iou_threshold)
                 & (rank[:, None] < rank[None, :])
                 & top_valid[:, :, None] & top_valid[:, None, :])
    # Greedy NMS as a fixpoint: converges to the unique greedy result
    # within (longest suppression chain) iterations.
    keep = top_valid
    for _ in range(p):
        new = top_valid & ~(dominates & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new

    rank_kept = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep & (rank_kept < k), rank_kept,
                       torch.full_like(rank_kept, k))
    out_boxes = torch.zeros((c, k + 1, 4), dtype=top_boxes.dtype,
                            device=scores.device)
    out_boxes.scatter_(1, dest[..., None].expand(-1, -1, 4), top_boxes)
    out_scores = torch.zeros((c, k + 1), dtype=top_s.dtype,
                             device=scores.device)
    out_scores.scatter_(1, dest, torch.where(keep, top_s,
                                             torch.zeros_like(top_s)))
    n_keep = keep.sum(dim=1, keepdim=True)
    out_valid = torch.arange(k, device=scores.device)[None] < torch.clamp(
        n_keep, max=k)
    return Detections(out_boxes[:, :k], out_scores[:, :k], out_valid,
                      clipped)


def nms_single_class(boxes_tlbr: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float,
                     score_threshold: float, max_outputs: int,
                     pre_nms_top_k: int = 512):
    """One class: boxes [N, 4], scores [N], valid [N] -> (boxes [K, 4],
    scores [K], valid [K], clipped []) in descending score order."""
    det = _nms_batched(boxes_tlbr, scores[None], valid[None], iou_threshold,
                       score_threshold, max_outputs, pre_nms_top_k)
    return det.boxes[0], det.scores[0], det.valid[0], det.clipped[0]


def multiclass_nms_dense(boxes_tlbr: torch.Tensor,
                         class_scores: torch.Tensor, iou_threshold: float,
                         score_threshold: float, max_per_class: int,
                         pre_nms_top_k: int = 512) -> Detections:
    """Every anchor scored for every class: boxes [A, 4], class_scores
    [A, C] -> Detections with K = max_per_class slots per class."""
    scores = class_scores.T
    valid = torch.ones_like(scores, dtype=torch.bool)
    return _nms_batched(boxes_tlbr, scores, valid, iou_threshold,
                        score_threshold, max_per_class, pre_nms_top_k)
