"""Box geometry over padded tensors (port of botsort_tpu/ops/boxes.py).

Formats (float32): tlbr (x1, y1, x2, y2); tlwh (x1, y1, w, h);
xywh (cx, cy, w, h) — the Kalman state layout. The math is total: padded
all-zero rows give IoU 0, never NaN.
"""

from __future__ import annotations

import torch


def tlwh_to_tlbr(tlwh: torch.Tensor) -> torch.Tensor:
    xy = tlwh[..., :2]
    return torch.cat([xy, xy + tlwh[..., 2:4]], dim=-1)


def tlbr_to_tlwh(tlbr: torch.Tensor) -> torch.Tensor:
    xy = tlbr[..., :2]
    return torch.cat([xy, tlbr[..., 2:4] - xy], dim=-1)


def tlwh_to_xywh(tlwh: torch.Tensor) -> torch.Tensor:
    c = tlwh[..., :2] + tlwh[..., 2:4] / 2.0
    return torch.cat([c, tlwh[..., 2:4]], dim=-1)


def xywh_to_tlwh(xywh: torch.Tensor) -> torch.Tensor:
    tl = xywh[..., :2] - xywh[..., 2:4] / 2.0
    return torch.cat([tl, xywh[..., 2:4]], dim=-1)


def xywh_to_tlbr(xywh: torch.Tensor) -> torch.Tensor:
    half = xywh[..., 2:4] / 2.0
    c = xywh[..., :2]
    return torch.cat([c - half, c + half], dim=-1)


def iou_matrix(a_tlbr: torch.Tensor, b_tlbr: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., A, 4] x [..., B, 4] -> [..., A, B]; touching boxes
    (no positive overlap on an axis) have IoU 0."""
    a = a_tlbr[..., :, None, :]
    b = b_tlbr[..., None, :, :]
    inter_min = torch.maximum(a[..., :2], b[..., :2])
    inter_max = torch.minimum(a[..., 2:4], b[..., 2:4])
    inter_wh = inter_max - inter_min
    overlap = (inter_wh > 0.0).all(dim=-1)
    inter_area = inter_wh[..., 0] * inter_wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    denom = area_a + area_b - inter_area
    iou = torch.where(denom > 0.0,
                      inter_area / torch.clamp(denom, min=1e-12),
                      torch.zeros_like(denom))
    return torch.where(overlap, iou, torch.zeros_like(iou)).to(torch.float32)


def iou_distance(a_tlbr: torch.Tensor, b_tlbr: torch.Tensor) -> torch.Tensor:
    """1 - IoU cost matrix."""
    return 1.0 - iou_matrix(a_tlbr, b_tlbr)
