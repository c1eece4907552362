"""Fixed-shape class-aware NMS (port of botsort_tpu/ops/nms.py).

Per class: the top ``pre_nms_top_k`` candidates by score, greedy
suppression as a fixpoint (keep[j] = valid[j] and no kept higher-ranked
box with IoU > threshold), then the first ``max_outputs`` survivors
compacted into fixed slots — ONNX NonMaxSuppression semantics. All
classes of all frames run together as one batch.

The fixpoint runs until nothing changes, as the JAX package's
``lax.while_loop`` does, and never asks the host whether it is done: on
the card it is kernel K8 (csrc/nms_fixpoint.cu, ``nms_fixpoint_cuda``),
one thread-block cluster per (frame, class) problem whose blocks compute
its IoUs themselves, gather the dominance bits in the leader block (in a
device scratch buffer above SMEM_CANDIDATES candidates) and leave it to
iterate (``cluster_size`` picks the cluster); on the CPU it is
``nms_fixpoint_plain``. Both take any candidate count. The stable sort,
the gathers and the compaction stay in PyTorch. The fixpoint is unique, so
``Detections.converged`` is true by construction (the field keeps the
FrameResult's layout).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from botsort_tpu_torch.ops.boxes import iou_matrix
from botsort_tpu_torch.runtime import kernels
from botsort_tpu_torch.utils.consts import tracing

# The most candidates whose dominance bits (P x P / 8 bytes: 128 KB at
# 1024) K8 gathers in the leader block's shared memory; above, they go to
# a scratch buffer the wrapper allocates on the current stream
# (``nms_fixpoint_scratch_bytes``: 4.96 MB a problem at 6,300).
SMEM_CANDIDATES = 1024
# K8's largest cluster (16 blocks: a non-portable size, which the H100
# schedules) and its block size, the one the card ran fastest at the
# steps' candidates with ``cluster_size``'s clusters (chip_smoke.py's K8
# phase also times 256 and 512).
MAX_CLUSTER = 16
THREADS = 1024


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


def _lib() -> ctypes.CDLL:
    lib = kernels.load("nms_fixpoint")
    fn = lib.nms_fixpoint_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.nms_fixpoint_smem_bytes.argtypes = [ctypes.c_int]
        lib.nms_fixpoint_smem_bytes.restype = ctypes.c_size_t
        lib.nms_fixpoint_scratch_bytes.argtypes = [ctypes.c_int] * 2
        lib.nms_fixpoint_scratch_bytes.restype = ctypes.c_size_t
        lib.nms_fixpoint_max_active_clusters.argtypes = [
            ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.nms_fixpoint_max_active_clusters.restype = ctypes.c_int
    return lib


def cluster_size(problems: int, sm_count: int,
                 active_clusters: Callable[[int], int]) -> int:
    """K8's cluster size for ``problems`` problems on a card of
    ``sm_count`` SMs: the largest c <= MAX_CLUSTER with problems x c <=
    sm_count (1 where none is), lowered while the card cannot hold every
    problem's cluster of c blocks at once (``active_clusters(c)``, how
    many it can, below ``problems``): on the H100 a second wave of
    clusters cost more than a smaller cluster."""
    c = max(1, min(MAX_CLUSTER, sm_count // problems))
    while c > 1 and active_clusters(c) < problems:
        c -= 1
    return c


def max_active_clusters(cluster: int, p: int, device: torch.device) -> int:
    """How many clusters of ``cluster`` K8 blocks (``p`` candidates)
    ``device`` can run at once (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().nms_fixpoint_max_active_clusters(
            p, cluster, THREADS, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"nms_fixpoint occupancy query failed: CUDA "
                           f"error {rc}")
    return n.value


_CLUSTERS: Dict[tuple, int] = {}


def launch_shape(problems: int, p: int, device: torch.device) -> int:
    """The cluster size K8 launches ``problems`` problems of ``p``
    candidates with on ``device`` (``cluster_size`` with the card's SM
    count and occupancy), cached per shape."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (index, problems, p)
    c = _CLUSTERS.get(key)
    if c is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        c = _CLUSTERS[key] = cluster_size(
            problems, sms, lambda size: max_active_clusters(size, p, index))
    return c


def nms_fixpoint_cuda(top_boxes: torch.Tensor, top_valid: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """K8: ``nms_fixpoint_plain`` on the card, one launch on the current
    stream for every problem of the leading dimensions (a cluster of
    ``launch_shape`` blocks of THREADS threads each); nothing is
    synchronised. top_boxes [..., P, 4] float32 and top_valid [..., P]
    bool on one CUDA device, any P; above SMEM_CANDIDATES the dominance
    words go to a scratch tensor (``torch.empty`` on the current stream,
    so a graph capture takes it from the graph's pool). ``launches``
    counts launches."""
    if not top_boxes.is_cuda:
        raise ValueError("nms_fixpoint_cuda takes CUDA tensors; the plain "
                         "version is nms_fixpoint_plain")
    p = top_valid.shape[-1] if top_valid.dim() else 0
    if top_boxes.dtype != torch.float32 or top_valid.dtype != torch.bool \
            or top_boxes.shape[:-1] != top_valid.shape or \
            top_boxes.shape[-1:] != (4,) or \
            top_valid.device != top_boxes.device:
        raise ValueError(
            f"expected float32 boxes [..., P, 4] and bool valid [..., P] on "
            f"one device, got {tuple(top_boxes.shape)} {top_boxes.dtype}, "
            f"{tuple(top_valid.shape)} {top_valid.dtype}")
    keep = torch.empty_like(top_valid)
    problems = top_valid.numel() // max(p, 1)
    if keep.numel() == 0:
        return keep
    boxes = top_boxes.contiguous()
    valid = top_valid.contiguous()
    with torch.cuda.device(boxes.device):
        cluster = launch_shape(problems, p, boxes.device)
        lib = _lib()
        n_scratch = lib.nms_fixpoint_scratch_bytes(problems, p)
        scratch = torch.empty(n_scratch, dtype=torch.uint8,
                              device=boxes.device) if n_scratch else None
        rc = lib.nms_fixpoint_launch(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(), problems, p,
            float(np.float32(iou_threshold)), cluster, THREADS,
            kernels.current_stream(boxes.device))
    if rc != 0:
        raise RuntimeError(f"nms_fixpoint launch failed: CUDA error {rc}")
    nms_fixpoint_cuda.launches += 1
    return keep


nms_fixpoint_cuda.launches = 0


@torch.library.custom_op("botsort_tpu_torch::nms_fixpoint", mutates_args=(),
                        device_types="cpu")
def nms_fixpoint_op(top_boxes: torch.Tensor, top_valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """K8 as a custom op: the plain version on the CPU, the kernel on the
    card (registered below)."""
    return nms_fixpoint_plain(top_boxes, top_valid, iou_threshold)


@nms_fixpoint_op.register_kernel("cuda")
def _nms_fixpoint_op_cuda(top_boxes, top_valid, iou_threshold):
    return nms_fixpoint_cuda(top_boxes, top_valid, iou_threshold)


@nms_fixpoint_op.register_fake
def _nms_fixpoint_op_fake(top_boxes, top_valid, iou_threshold):
    return torch.empty_like(top_valid)


def nms_fixpoint(top_boxes: torch.Tensor, top_valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """The suppression fixpoint: CUDA tensors launch K8, CPU tensors take
    the plain version, any other device raises; under a trace, the custom
    op."""
    if tracing():
        return nms_fixpoint_op(top_boxes, top_valid, float(iou_threshold))
    if top_boxes.is_cuda:
        return nms_fixpoint_cuda(top_boxes, top_valid, iou_threshold)
    if top_boxes.device.type != "cpu":
        raise ValueError(f"nms_fixpoint: no kernel for device "
                         f"{top_boxes.device}")
    return nms_fixpoint_plain(top_boxes, top_valid, iou_threshold)


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
    keep = nms_fixpoint(top_boxes, top_valid, iou_threshold)
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


def nms_single_class(boxes_tlbr: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float,
                     score_threshold: float, max_outputs: int,
                     pre_nms_top_k: int = 512):
    """One class: boxes [N, 4], scores [N], valid [N] -> (boxes [K, 4],
    scores [K], valid [K], clipped [], converged []) in descending score
    order."""
    det = _nms_batched(boxes_tlbr[None], scores[None, None],
                       valid[None, None], iou_threshold, score_threshold,
                       max_outputs, pre_nms_top_k)
    return det.boxes[0, 0], det.scores[0, 0], det.valid[0, 0], \
        det.clipped[0, 0], det.converged[0]


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


def multiclass_nms_dense(boxes_tlbr: torch.Tensor,
                         class_scores: torch.Tensor, iou_threshold: float,
                         score_threshold: float, max_per_class: int,
                         pre_nms_top_k: int = 512) -> Detections:
    """One frame: boxes [A, 4], class_scores [A, C] -> Detections with K =
    max_per_class slots per class (``multiclass_nms_dense_batched`` at
    B = 1)."""
    det = multiclass_nms_dense_batched(
        boxes_tlbr[None], class_scores[None], iou_threshold,
        score_threshold, max_per_class, pre_nms_top_k)
    return Detections(*(x[0] for x in det))
