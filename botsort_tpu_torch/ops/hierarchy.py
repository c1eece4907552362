"""Greedy box-hierarchy association (port of botsort_tpu/ops/hierarchy.py).

Each base box, in base order, claims its best unused target: the highest
IoU, tie-broken by the smaller center distance (true geometric centers).
The claims are sequential over bases; each step is vector work over the
target slots.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from botsort_tpu_torch.ops.boxes import iou_matrix
from botsort_tpu_torch.utils.consts import const


def greedy_assign_batch(problems: Sequence[tuple]) -> List[tuple]:
    """Run independent greedy problems in lockstep.

    problems: (base_tlbr [B, 4], base_valid [B], target_tlbr [T, 4],
    target_valid [T], rounds) with identical B and T; ``rounds`` targets
    are claimed per base back to back (2 for hands -> body). Returns, per
    problem, a tuple of ``rounds`` int32 arrays [B]: target index or -1.
    """
    b = problems[0][0].shape[0]
    max_rounds = max(pr[4] for pr in problems)
    base = torch.stack([pr[0] for pr in problems])            # [P, B, 4]
    base_valid = torch.stack([pr[1] for pr in problems])      # [P, B]
    target = torch.stack([pr[2] for pr in problems])          # [P, T, 4]
    target_valid = torch.stack([pr[3] for pr in problems])    # [P, T]
    dev = base.device
    round_active = const(
        [[r < pr[4] for r in range(max_rounds)] for pr in problems],
        torch.bool, dev)                                      # [P, R]

    iou = iou_matrix(base, target)                            # [P, B, T]
    iou = torch.where(base_valid[:, :, None] & target_valid[:, None, :],
                      iou, torch.zeros_like(iou))
    bc = (base[..., :2] + base[..., 2:4]) / 2.0
    tc = (target[..., :2] + target[..., 2:4]) / 2.0
    dist = torch.linalg.norm(bc[:, :, None, :] - tc[:, None, :, :], dim=-1)

    t_idx = torch.arange(target.shape[1], device=dev)[None, :]
    used = ~target_valid
    picks = torch.empty((b, len(problems), max_rounds), dtype=torch.int32,
                        device=dev)
    zero = torch.zeros((), dtype=iou.dtype, device=dev)
    inf = const(float("inf"), dist.dtype, dev)
    for bi in range(b):
        for r in range(max_rounds):
            row_iou = torch.where(used, zero, iou[:, bi, :])  # [P, T]
            best_iou = row_iou.amax(dim=-1, keepdim=True)
            cand = (row_iou == best_iou) & (best_iou > 0.0)
            row_d = torch.where(cand, dist[:, bi, :], inf)
            choice = torch.argmin(row_d, dim=-1)
            found = (best_iou[:, 0] > 0.0) & round_active[:, r]
            choice = torch.where(found, choice, torch.full_like(choice, -1))
            used = used | ((t_idx == choice[:, None]) & found[:, None])
            picks[bi, :, r] = choice.to(torch.int32)
    return [tuple(picks[:, pi, r] for r in range(pr[4]))
            for pi, pr in enumerate(problems)]


def greedy_assign(base_tlbr: torch.Tensor, base_valid: torch.Tensor,
                  target_tlbr: torch.Tensor, target_valid: torch.Tensor,
                  rounds: int = 1) -> Tuple[torch.Tensor, ...]:
    """One problem: each base claims ``rounds`` targets; returns
    ``rounds`` int32 arrays [B] (target index or -1)."""
    return greedy_assign_batch(
        [(base_tlbr, base_valid, target_tlbr, target_valid, rounds)])[0]
