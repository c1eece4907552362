"""Greedy box-hierarchy association (port of botsort_tpu/ops/hierarchy.py).

Each base box, in base order, claims its best unused target: the highest
IoU, tie-broken by the smaller center distance (true geometric centers),
the lowest target index at equal distances. The claims are sequential
over bases, and all problems of a step advance in lockstep, as the JAX
package's ``lax.scan`` does inside its jitted step.

The IoU and the distances are PyTorch ops (``scan_inputs``), as the JAX
package computes them outside its scan. The sequential claims are
``greedy_scan``: on the card kernel K10 (csrc/hierarchy_scan.cu,
``greedy_scan_cuda``), every problem in one launch, one warp a problem up
to WARP_TARGETS targets and a block a problem above; on the CPU
``greedy_scan_plain``, the claims as a loop of tensor ops. Both take any
number of bases, targets and rounds.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from botsort_tpu_torch.ops.boxes import iou_matrix
from botsort_tpu_torch.runtime import kernels
from botsort_tpu_torch.utils.consts import const, tracing

# The most targets of K10's warp-a-problem form: a lane keeps the used
# bits of its targets (lane, lane + 32, ...) in one 32-bit word and their
# keys in registers. Above, a block of 1,024 threads takes a problem, with
# the keys and used bits in a scratch buffer the wrapper allocates.
WARP_TARGETS = 1024


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


def _lib() -> ctypes.CDLL:
    lib = kernels.load("hierarchy_scan")
    fn = lib.hierarchy_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.hierarchy_scan_scratch_bytes.argtypes = [ctypes.c_int] * 2
        lib.hierarchy_scan_scratch_bytes.restype = ctypes.c_size_t
    return lib


def greedy_scan_cuda(iou: torch.Tensor, dist: torch.Tensor,
                     used0: torch.Tensor,
                     round_active: torch.Tensor) -> torch.Tensor:
    """K10: ``greedy_scan_plain`` on the card, one launch on the current
    stream for every problem (a warp each, a block each above
    WARP_TARGETS targets); nothing is synchronised. iou, dist [P, B, T]
    float32, used0 [P, T] bool, round_active [P, R] bool on one CUDA
    device, any B, T and R; above WARP_TARGETS the keys and used bits go
    to a scratch tensor (``torch.empty`` on the current stream, so a graph
    capture takes it from the graph's pool)."""
    if not iou.is_cuda:
        raise ValueError("greedy_scan_cuda takes CUDA tensors; the plain "
                         "version is greedy_scan_plain")
    if iou.dim() != 3 or iou.dtype != torch.float32 or \
            dist.dtype != torch.float32 or dist.shape != iou.shape or \
            used0.dtype != torch.bool or round_active.dtype != torch.bool \
            or used0.shape != (iou.shape[0], iou.shape[2]) or \
            round_active.dim() != 2 or \
            round_active.shape[0] != iou.shape[0] or \
            any(x.device != iou.device for x in (dist, used0, round_active)):
        raise ValueError(
            f"expected float32 iou and dist [P, B, T], bool used0 [P, T] "
            f"and bool round_active [P, R] on one device, got "
            f"{tuple(iou.shape)} {iou.dtype}, {tuple(dist.shape)} "
            f"{dist.dtype}, {tuple(used0.shape)} {used0.dtype}, "
            f"{tuple(round_active.shape)} {round_active.dtype}")
    p, b, t = iou.shape
    rounds = round_active.shape[1]
    picks = torch.empty((b, p, rounds), dtype=torch.int32,
                        device=iou.device)
    if picks.numel() == 0:
        return picks
    iou, dist = iou.contiguous(), dist.contiguous()
    used0, round_active = used0.contiguous(), round_active.contiguous()
    with torch.cuda.device(iou.device):
        lib = _lib()
        n_scratch = lib.hierarchy_scan_scratch_bytes(p, t)
        scratch = torch.empty(n_scratch, dtype=torch.uint8,
                              device=iou.device) if n_scratch else None
        rc = lib.hierarchy_scan_launch(
            iou.data_ptr(), dist.data_ptr(), used0.data_ptr(),
            round_active.data_ptr(), picks.data_ptr(),
            None if scratch is None else scratch.data_ptr(), p, b, t,
            rounds, kernels.current_stream(iou.device))
    if rc != 0:
        raise RuntimeError(f"hierarchy_scan launch failed: CUDA error {rc}")
    return picks


@torch.library.custom_op("botsort_tpu_torch::hierarchy_scan",
                        mutates_args=(), device_types="cpu")
def greedy_scan_op(iou: torch.Tensor, dist: torch.Tensor,
                   used0: torch.Tensor,
                   round_active: torch.Tensor) -> torch.Tensor:
    """K10 as a custom op: the plain version on the CPU, the kernel on the
    card (registered below)."""
    return greedy_scan_plain(iou, dist, used0, round_active)


@greedy_scan_op.register_kernel("cuda")
def _greedy_scan_op_cuda(iou, dist, used0, round_active):
    return greedy_scan_cuda(iou, dist, used0, round_active)


@greedy_scan_op.register_fake
def _greedy_scan_op_fake(iou, dist, used0, round_active):
    return iou.new_empty((iou.shape[1], iou.shape[0], round_active.shape[1]),
                         dtype=torch.int32)


def greedy_scan(iou: torch.Tensor, dist: torch.Tensor, used0: torch.Tensor,
                round_active: torch.Tensor) -> torch.Tensor:
    """The sequential claims: CUDA tensors launch K10, CPU tensors take the
    plain version, any other device raises; under a trace, the custom
    op."""
    if tracing():
        return greedy_scan_op(iou, dist, used0, round_active)
    if iou.is_cuda:
        return greedy_scan_cuda(iou, dist, used0, round_active)
    if iou.device.type != "cpu":
        raise ValueError(f"greedy_scan: no kernel for device {iou.device}")
    return greedy_scan_plain(iou, dist, used0, round_active)


def greedy_assign_batch(problems: Sequence[tuple]) -> List[tuple]:
    """Run independent greedy problems in lockstep.

    problems: (base_tlbr [B, 4], base_valid [B], target_tlbr [T, 4],
    target_valid [T], rounds) with identical B and T; ``rounds`` targets
    are claimed per base back to back (2 for hands -> body). Returns, per
    problem, a tuple of ``rounds`` int32 arrays [B]: target index or -1.
    """
    picks = greedy_scan(*scan_inputs(problems))               # [B, P, R]
    return [tuple(picks[:, pi, r] for r in range(pr[4]))
            for pi, pr in enumerate(problems)]


def greedy_assign(base_tlbr: torch.Tensor, base_valid: torch.Tensor,
                  target_tlbr: torch.Tensor, target_valid: torch.Tensor,
                  rounds: int = 1) -> Tuple[torch.Tensor, ...]:
    """One problem: each base claims ``rounds`` targets; returns
    ``rounds`` int32 arrays [B] (target index or -1)."""
    return greedy_assign_batch(
        [(base_tlbr, base_valid, target_tlbr, target_valid, rounds)])[0]
