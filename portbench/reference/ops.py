"""Boxes, crop-resize, NMS and the box hierarchy in plain PyTorch.

Frozen copies of the port's plain versions (its ``ops/boxes.py``,
``ops/crop.py::crop_resize_plain``, ``ops/nms.py::nms_fixpoint_plain``
with the sort and compaction around it, ``ops/hierarchy.py::
greedy_scan_plain`` with its inputs), with no kernel and no dispatch: the
benchmark's reference for the detector's post-process, the crops the
encoders see and the hierarchy's claims. The crop keeps the port's three
numerics (``float32``, ``bfloat16``, ``int8``), which the pipeline
configuration names; the rest is float32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


def const(value, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


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


def _recip(n: int) -> float:
    """1 / n rounded to float32 (a Python float that float32 holds
    exactly)."""
    return float(np.float32(1.0) / np.float32(n))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as an FMA gives it."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _sample_grid(img_hw: Tuple[int, int], boxes_tlbr: torch.Tensor,
                 out_hw: Tuple[int, int]):
    """(y0, x0, y1i, x1i, wy, wx, good): two integer taps per output
    row/col [..., N, out], their fractional weights, and the per-box
    validity (w and h >= 1), for boxes [..., N, 4]."""
    img_h, img_w = img_hw
    out_h, out_w = out_hw
    boxes = boxes_tlbr.to(torch.float32)
    x1 = boxes[..., 0, None]
    y1 = boxes[..., 1, None]
    w = boxes[..., 2, None] - x1
    h = boxes[..., 3, None] - y1
    good = (w[..., 0] >= 1.0) & (h[..., 0] >= 1.0)
    dev = boxes.device
    gy = torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5
    gx = torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
    # ``y1 + gy * (h / out_h)`` as XLA compiles it in the JAX package's
    # jitted steps: the division by a constant becomes a product with its
    # float32 reciprocal, and the product and the sum contract into one
    # FMA. Emulated in float64, where the float32 product is exact.
    sy = _fma(gy, h * _recip(out_h), y1) - 0.5
    sx = _fma(gx, w * _recip(out_w), x1) - 0.5
    # cv2 clamps sampling to the cropped region, then to the image.
    sy = torch.minimum(torch.maximum(sy, y1), y1 + h - 1.0)
    sx = torch.minimum(torch.maximum(sx, x1), x1 + w - 1.0)
    sy = torch.clamp(sy, 0.0, img_h - 1.0)
    sx = torch.clamp(sx, 0.0, img_w - 1.0)
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    wy = sy - y0f
    wx = sx - x0f
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1i = torch.clamp(y0 + 1, max=img_h - 1)
    x1i = torch.clamp(x0 + 1, max=img_w - 1)
    return y0, x0, y1i, x1i, wy, wx, good


def _taps(images, y0, x0, y1i, x1i):
    """The four source taps of every output pixel, [B, N, oh, ow, 3] in
    the frames' dtype: (p00, p01, p10, p11), row first."""
    frame = torch.arange(images.shape[0],
                         device=images.device)[:, None, None, None]
    rows = (y0[..., :, None], y1i[..., :, None])
    cols = (x0[..., None, :], x1i[..., None, :])
    return tuple(images[frame, r, c] for r in rows for c in cols)


def crop_and_resize_batched(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                            out_hw: Tuple[int, int]) -> torch.Tensor:
    """The float32 mode's plain version. B frames at once, each with its
    own boxes: images [B, H, W, 3] (any dtype); boxes [B, N, 4] tlbr pixel
    corners -> [B, N, out_h, out_w, 3] float32. Each output pixel lerps
    along x on both tap rows, then along y."""
    y0, x0, y1i, x1i, wy, wx, good = _sample_grid(
        (images.shape[1], images.shape[2]), boxes_tlbr, out_hw)
    p00, p01, p10, p11 = (p.to(torch.float32)
                          for p in _taps(images, y0, x0, y1i, x1i))
    wx_c = wx[..., None, :, None]
    wy_c = wy[..., :, None, None]
    top = p00 + wx_c * (p01 - p00)
    bot = p10 + wx_c * (p11 - p10)
    out = top + wy_c * (bot - top)
    return torch.where(good[..., None, None, None], out,
                       torch.zeros_like(out))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _pair_weights(w, edge):
    """The bfloat16 weights (of tap 0, of tap 1) of one axis, as float32:
    bf16(1-w) and bf16(w), or bf16((1-w)+w) and 0 where the two taps are
    one pixel."""
    w0 = 1.0 - w
    return (_bf16(torch.where(edge, w0 + w, w0)),
            _bf16(torch.where(edge, torch.zeros_like(w), w)))


def _crop_low(images, boxes_tlbr, out_hw, mode):
    """The bfloat16 and int8 modes' plain version (see the module
    docstring): the same float32 and integer operations as kernel K7, in
    the same order."""
    y0, x0, y1i, x1i, wy, wx, good = _sample_grid(
        (images.shape[1], images.shape[2]), boxes_tlbr, out_hw)
    p00, p01, p10, p11 = _taps(images, y0, x0, y1i, x1i)
    edge_x = x0 == x1i
    if mode == "int8":
        q = torch.round(wx * 127.0).to(torch.int32)
        w0 = torch.where(edge_x, 127, 127 - q)[..., None, :, None]
        w1 = torch.where(edge_x, 0, q)[..., None, :, None]
        # A tensor divisor: a CUDA division by a host scalar multiplies by
        # its reciprocal, which rounds differently.
        d127 = const(127.0, torch.float32, images.device)

        def x_phase(p0, p1):
            acc = w0 * (p0.to(torch.int32) - 128) + \
                w1 * (p1.to(torch.int32) - 128)
            return _bf16((acc.to(torch.float32) + 16256.0) / d127)
    else:
        a0, a1 = (a[..., None, :, None] for a in _pair_weights(wx, edge_x))

        def x_phase(p0, p1):
            return _bf16(a0 * _bf16(p0.to(torch.float32))
                         + a1 * _bf16(p1.to(torch.float32)))
    t0 = x_phase(p00, p01)
    t1 = x_phase(p10, p11)
    b0, b1 = (b[..., :, None, None] for b in _pair_weights(wy, y0 == y1i))
    out = b0 * t0 + b1 * t1
    return torch.where(good[..., None, None, None], out,
                       torch.zeros_like(out))


def crop_resize_plain(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                      out_hw: Tuple[int, int], mode: str = "float32"
                      ) -> torch.Tensor:
    """K7's plain version: images [B, H, W, 3], boxes [B, N, 4] ->
    [B, N, out_h, out_w, 3] float32 in ``mode`` (``MODES``)."""
    if mode == "float32":
        return crop_and_resize_batched(images, boxes_tlbr, out_hw)
    return _crop_low(images, boxes_tlbr, out_hw, mode)


class Detections(NamedTuple):
    """boxes [..., C, K, 4] tlbr; scores [..., C, K]; valid [..., C, K]
    bool; clipped [..., C] bool (more than pre_nms_top_k candidates
    cleared the threshold); converged [...] bool (the suppression
    fixpoint was reached: always true, the fixpoint runs to its end). The
    leading dimension, where present, is the frame."""

    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor
    clipped: torch.Tensor
    converged: torch.Tensor


def nms_fixpoint_plain(top_boxes: torch.Tensor, top_valid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """K8's plain version: top_boxes [..., P, 4] tlbr in rank order,
    top_valid [..., P] bool -> keep [..., P] bool, the greedy suppression's
    fixpoint. Builds the [..., P, P] dominance matrix and iterates the
    masked reduction until nothing changes, capped at P iterations as the
    JAX ``fix_cond`` is (iteration t settles every box whose chain of
    dominators is at most t long, so the cap is never what stops it)."""
    p = top_valid.shape[-1]
    iou = iou_matrix(top_boxes, top_boxes)                   # [..., P, P]
    rank = torch.arange(p, device=top_valid.device)
    dominates = ((iou > iou_threshold)
                 & (rank[:, None] < rank[None, :])
                 & top_valid[..., :, None] & top_valid[..., None, :])
    keep = top_valid.clone()  # a fresh tensor: the op's output aliases none
    for _ in range(p):
        new = top_valid & ~(dominates & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def top_candidates(boxes_tlbr: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, score_threshold: float,
                   pre_nms_top_k: int):
    """The suppression's input for G frames x C classes: boxes [G, N, 4]
    (each frame's shared by its classes), scores/valid [G, C, N] ->
    (top_boxes [G, C, P, 4] and top_s [G, C, P] in rank order, top_valid
    [G, C, P], clipped [G, C]), P = min(pre_nms_top_k, N)."""
    g, c, n = scores.shape
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
    frame = torch.arange(g, device=scores.device)[:, None, None]
    top_boxes = boxes_tlbr[frame, order]                     # [G, C, P, 4]
    return top_boxes, top_s, top_s > neg, clipped


def _nms_batched(boxes_tlbr: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, iou_threshold: float,
                 score_threshold: float, max_outputs: int,
                 pre_nms_top_k: int) -> Detections:
    """G frames x C classes as one batch: boxes [G, N, 4], each frame's
    shared by its classes; scores/valid [G, C, N]. The suppression
    fixpoint of all G x C problems is one ``nms_fixpoint`` call, with no
    readback."""
    g, c, _ = scores.shape
    k = max_outputs
    dev = scores.device
    top_boxes, top_s, top_valid, clipped = top_candidates(
        boxes_tlbr, scores, valid, score_threshold, pre_nms_top_k)
    keep = nms_fixpoint_plain(top_boxes, top_valid, iou_threshold)
    converged = torch.ones((g,), dtype=torch.bool, device=dev)

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


def multiclass_nms_dense_batched(boxes_tlbr: torch.Tensor,
                                 class_scores: torch.Tensor,
                                 iou_threshold: float,
                                 score_threshold: float, max_per_class: int,
                                 pre_nms_top_k: int = 512) -> Detections:
    """B frames, every anchor scored for every class: boxes [B, A, 4],
    class_scores [B, A, C] -> Detections with [B, C, K] slots."""
    scores = class_scores.transpose(-1, -2)
    valid = torch.ones_like(scores, dtype=torch.bool)
    return _nms_batched(boxes_tlbr, scores, valid, iou_threshold,
                        score_threshold, max_per_class, pre_nms_top_k)


def scan_inputs(problems: Sequence[tuple]):
    """The claims' inputs for problems (base_tlbr [B, 4], base_valid [B],
    target_tlbr [T, 4], target_valid [T], rounds) with identical B and T:
    (iou [P, B, T] masked by both validities, dist [P, B, T] between the
    centers, used0 [P, T] = ~target_valid, round_active [P, R]: round r
    claims for problem p, R the most rounds)."""
    max_rounds = max(pr[4] for pr in problems)
    base = torch.stack([pr[0] for pr in problems])            # [P, B, 4]
    base_valid = torch.stack([pr[1] for pr in problems])      # [P, B]
    target = torch.stack([pr[2] for pr in problems])          # [P, T, 4]
    target_valid = torch.stack([pr[3] for pr in problems])    # [P, T]
    round_active = const(
        [[r < pr[4] for r in range(max_rounds)] for pr in problems],
        torch.bool, base.device)                              # [P, R]
    iou = iou_matrix(base, target)                            # [P, B, T]
    iou = torch.where(base_valid[:, :, None] & target_valid[:, None, :],
                      iou, torch.zeros_like(iou))
    bc = (base[..., :2] + base[..., 2:4]) / 2.0
    tc = (target[..., :2] + target[..., 2:4]) / 2.0
    dist = torch.linalg.norm(bc[:, :, None, :] - tc[:, None, :, :], dim=-1)
    return iou, dist, ~target_valid, round_active


def greedy_scan_plain(iou: torch.Tensor, dist: torch.Tensor,
                      used0: torch.Tensor,
                      round_active: torch.Tensor) -> torch.Tensor:
    """K10's plain version: iou, dist [P, B, T], used0 [P, T] bool,
    round_active [P, R] bool -> picks [B, P, R] int32, the target each
    base claims in each round (or -1). Base by base, round by round, every
    problem at once: the row's highest IoU among unused targets, the
    smallest distance among the targets at it (the lowest index at equal
    distances, as ``torch.argmin``), nothing where that IoU is not above
    0 or the round is not the problem's."""
    p, b, t = iou.shape
    dev = iou.device
    t_idx = torch.arange(t, device=dev)[None, :]
    used = used0
    picks = torch.empty((b, p, round_active.shape[1]), dtype=torch.int32,
                        device=dev)
    zero = torch.zeros((), dtype=iou.dtype, device=dev)
    inf = const(float("inf"), dist.dtype, dev)
    for bi in range(b):
        for r in range(round_active.shape[1]):
            row_iou = torch.where(used, zero, iou[:, bi, :])  # [P, T]
            best_iou = row_iou.amax(dim=-1, keepdim=True)
            cand = (row_iou == best_iou) & (best_iou > 0.0)
            row_d = torch.where(cand, dist[:, bi, :], inf)
            choice = torch.argmin(row_d, dim=-1)
            found = (best_iou[:, 0] > 0.0) & round_active[:, r]
            choice = torch.where(found, choice, torch.full_like(choice, -1))
            used = used | ((t_idx == choice[:, None]) & found[:, None])
            picks[bi, :, r] = choice.to(torch.int32)
    return picks


def greedy_assign_batch(problems: Sequence[tuple]) -> List[tuple]:
    """Run independent greedy problems in lockstep.

    problems: (base_tlbr [B, 4], base_valid [B], target_tlbr [T, 4],
    target_valid [T], rounds) with identical B and T; ``rounds`` targets
    are claimed per base back to back (2 for hands -> body). Returns, per
    problem, a tuple of ``rounds`` int32 arrays [B]: target index or -1.
    """
    picks = greedy_scan_plain(*scan_inputs(problems))               # [B, P, R]
    return [tuple(picks[:, pi, r] for r in range(pr[4]))
            for pi, pr in enumerate(problems)]
