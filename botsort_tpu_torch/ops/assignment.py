"""Thresholded linear assignment (lap.lapjv extend_cost/cost_limit).

Port of botsort_tpu/ops/assignment.py. An n x m problem with limit L is
embedded in the (n+m) x (n+m) extended problem

    [ C            L/2 * ones ]
    [ L/2 * ones   0          ]

and solved exactly with Jonker-Volgenant shortest augmenting paths; row i
is matched iff its partner is a real column. Invalid rows/columns are
pre-matched to designated dummies (row i owns dummy column m+i, dummy row
n+j owns column j) at zero duals, so only live rows are augmented, in
ascending index order.

``solve_cascade_masked`` is the tracker's entry point: the cascade's three
chained solves. For CUDA tensors it launches kernel K1
(ops/assignment_cuda.py, csrc/cascade_lap.cu); for CPU tensors it runs
``cascade_solve_plain``, the plain PyTorch version of the same function,
which performs the kernel's float32 operations in the kernel's order and
is the oracle the kernel is checked against. Both share ``prepare_cascade``
(one ``big`` over all three passes, feasibility pre-parking per pass), so
their matchings are equal, ties included.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# The reference solver's "unreached" value (a float, not a tensor, so
# importing this module allocates nothing).
_INF = 1e30
MAX_ITERS = 4096


class AssignmentResult(NamedTuple):
    """col_for_row [N] / row_for_col [D] int32, -1 where unmatched."""

    col_for_row: torch.Tensor
    row_for_col: torch.Tensor


def half_limit(limit: float) -> float:
    """The dummy-region price L/2, rounded as float32(L) / 2."""
    return float(np.float32(limit) / np.float32(2.0))


def _ext_matrix(cost: torch.Tensor, rv: torch.Tensor, cv: torch.Tensor,
                half: float, big: torch.Tensor) -> torch.Tensor:
    """Materialised extended matrix [n+d, n+d] (the kernel builds each row
    on the fly instead; entries are identical)."""
    n, d = cost.shape
    dev = cost.device
    f32 = torch.float32
    half_t = torch.tensor(half, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    big = big.to(f32)
    ext = torch.zeros((n + d, n + d), dtype=f32, device=dev)
    live = torch.where(cv[None, :], cost, big)
    ext[:n, :d] = torch.where(rv[:, None], live, big)
    ext[:n, d:] = torch.where(rv[:, None], half_t, zero).expand(n, n)
    ext[n:, :d] = torch.where(cv[None, :], half_t, zero).expand(d, d)
    return ext


def _jv_extended(cost: torch.Tensor, rv: torch.Tensor, cv: torch.Tensor,
                 half: float, big: torch.Tensor,
                 max_iters: int = MAX_ITERS) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Exact solve of the extended problem for live rows rv [n] / cols
    cv [d] (bool). Returns (cfr [n], rfc [d]) int32."""
    n, d = cost.shape
    s = n + d
    dev = cost.device
    ext = _ext_matrix(cost, rv, cv, half, big)
    rv_l = rv.tolist()
    cv_l = cv.tolist()
    # p[j] = owner row of column j (-1 free); kept on the host because the
    # augmenting loop branches on it every pop.
    p: List[int] = ([-1 if cv_l[j] else n + j for j in range(d)]
                    + [-1 if rv_l[i] else i for i in range(n)])
    live_rows = ([i for i in range(n) if rv_l[i]]
                 + [n + j for j in range(d) if cv_l[j]])
    u = torch.zeros(s, dtype=torch.float32, device=dev)
    v = torch.zeros(s, dtype=torch.float32, device=dev)
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    for i in live_rows:
        minv = torch.full((s,), _INF, dtype=torch.float32, device=dev)
        way = torch.full((s,), s, dtype=torch.int64, device=dev)
        used = torch.zeros(s, dtype=torch.bool, device=dev)
        on_path = torch.zeros(s, dtype=torch.bool, device=dev)
        cur, j_from, done, it = i, s, False, 0
        while not done and it < max_iters:
            on_path[cur] = True
            reduced = ext[cur] - u[cur] - v
            upd = ~used & (reduced < minv)
            minv = torch.where(upd, reduced, minv)
            way = torch.where(upd, j_from, way)
            masked = torch.where(used, inf, minv)
            j1 = int(torch.argmin(masked))
            delta = masked[j1]
            u = torch.where(on_path, u + delta, u)
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            used[j1] = True
            nxt = p[j1]
            done = nxt < 0
            if not done:
                cur = nxt
            j_from = j1
            it += 1
        way_l = way.tolist()
        j0, it = j_from, 0
        while j0 < s and it < max_iters:
            j1 = way_l[j0]
            p[j0] = i if j1 >= s else p[j1]
            j0 = j1
            it += 1
    rfc = [o if (cv_l[j] and 0 <= o < n and rv_l[o]) else -1
           for j, o in enumerate(p[:d])]
    cfr = [-1] * n
    for j, o in enumerate(rfc):
        if o >= 0:
            cfr[o] = j
    as_t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return as_t(cfr), as_t(rfc)


def solve_masked(cost: torch.Tensor, row_valid: torch.Tensor,
                 col_valid: torch.Tensor, cost_limit: float,
                 max_iters: int = MAX_ITERS) -> AssignmentResult:
    """One thresholded LAP over a padded cost [N, D] with validity masks
    (botsort_tpu.ops.assignment.solve_masked): feasibility pre-parking,
    ``big`` from this problem's valid entries, then the exact solve."""
    cost = cost.to(torch.float32)
    limit = torch.tensor(cost_limit, dtype=torch.float32, device=cost.device)
    valid_pair = row_valid[:, None] & col_valid[None, :]
    feasible = valid_pair & (cost <= limit)
    row_valid = row_valid & feasible.any(dim=1)
    col_valid = col_valid & feasible.any(dim=0)
    pair = row_valid[:, None] & col_valid[None, :]
    finite_max = torch.where(pair, cost.abs(), 0.0).amax()
    big = finite_max + limit.abs() + 1.0
    cfr, rfc = _jv_extended(cost, row_valid, col_valid,
                            half_limit(cost_limit), big, max_iters)
    return AssignmentResult(cfr, rfc)


def prepare_cascade(dists1, iou_d, dists3, pool_m, tracked_m, unconf_m,
                    high_m, low_m, limits: Sequence[float]):
    """Shared host-side prep of the fused cascade solve (the TPU path's
    cascade_solve_pallas prep): NaN/inf-free costs, one ``big`` over all
    three passes, and per-pass feasibility pre-parking — an endpoint with
    no entry <= the pass limit is unmatched in every optimal solution, so
    it enters parked. Pass-2 rows and pass-3 columns depend on pass 1's
    matching and are pre-parked on their superset masks (tracked / high);
    the solver intersects them with pass 1's outcome.

    Returns costs [3, N, D] f32, masks [3N+3D] int32 (pool, tracked,
    unconf, high1, high3, low) and big [] f32.
    """
    f32 = torch.float32
    lim = [torch.tensor(x, dtype=f32, device=dists1.device) for x in limits]
    costs = torch.stack([dists1, iou_d, dists3]).to(f32)
    costs = torch.nan_to_num(costs, posinf=1e9, neginf=-1e9)
    big = costs.abs().amax() + max(abs(float(x)) for x in limits) + 1.0

    f1 = pool_m[:, None] & high_m[None, :] & (dists1.to(f32) <= lim[0])
    f2 = tracked_m[:, None] & low_m[None, :] & (iou_d.to(f32) <= lim[1])
    f3 = unconf_m[:, None] & high_m[None, :] & (dists3.to(f32) <= lim[2])
    masks = torch.cat([
        pool_m & f1.any(dim=1),
        tracked_m & f2.any(dim=1),
        unconf_m & f3.any(dim=1),
        high_m & f1.any(dim=0),
        high_m & f3.any(dim=0),
        low_m & f2.any(dim=0),
    ]).to(torch.int32)
    return costs.contiguous(), masks, big.to(f32)


def cascade_solve_plain(costs: torch.Tensor, masks: torch.Tensor,
                        big: torch.Tensor, limits: Sequence[float],
                        max_iters: int = MAX_ITERS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K1 on ``prepare_cascade``'s output.

    costs [B, 3, N, D]; masks [B, 3N+3D]; big [B] -> (cfr [B, 3, N],
    rfc [B, 3, D]) int32. Pass 1: pool x high1; pass 2: (tracked & pass-1
    unmatched) x low over IoU; pass 3: unconf x (high3 & pass-1 unmatched).
    """
    bsz, _, n, d = costs.shape
    cfr_all, rfc_all = [], []
    for b in range(bsz):
        m = masks[b].bool()
        pool, tracked, unconf = m[:n], m[n:2 * n], m[2 * n:3 * n]
        high1 = m[3 * n:3 * n + d]
        high3 = m[3 * n + d:3 * n + 2 * d]
        low = m[3 * n + 2 * d:]
        c1, r1 = _jv_extended(costs[b, 0], pool, high1,
                              half_limit(limits[0]), big[b], max_iters)
        c2, r2 = _jv_extended(costs[b, 1], tracked & (c1 < 0), low,
                              half_limit(limits[1]), big[b], max_iters)
        c3, r3 = _jv_extended(costs[b, 2], unconf, high3 & (r1 < 0),
                              half_limit(limits[2]), big[b], max_iters)
        cfr_all.append(torch.stack([c1, c2, c3]))
        rfc_all.append(torch.stack([r1, r2, r3]))
    return torch.stack(cfr_all), torch.stack(rfc_all)


def solve_cascade_masked(dists1, iou_d, dists3, pool_m, tracked_m, unconf_m,
                         high_m, low_m, limits: Sequence[float],
                         max_iters: int = MAX_ITERS):
    """The association cascade's three chained thresholded LAPs.

    Pass 1: pool_m x high_m over dists1 (limit limits[0]).
    Pass 2: (tracked_m & pass-1-row-unmatched) x low_m over iou_d.
    Pass 3: unconf_m x (high_m & pass-1-col-unmatched) over dists3.
    Returns (res1, res2, res3) AssignmentResults.

    CUDA tensors launch kernel K1; CPU tensors take the plain version.
    There is no fallback between the two: a kernel that fails to build or
    launch raises.
    """
    costs, masks, big = prepare_cascade(dists1, iou_d, dists3, pool_m,
                                        tracked_m, unconf_m, high_m, low_m,
                                        limits)
    if costs.is_cuda:
        from botsort_tpu_torch.ops.assignment_cuda import cascade_solve_cuda

        cfr, rfc = cascade_solve_cuda(costs[None], masks[None], big[None],
                                      limits, max_iters)
    elif costs.device.type == "cpu":
        cfr, rfc = cascade_solve_plain(costs[None], masks[None], big[None],
                                       limits, max_iters)
    else:
        raise ValueError(f"no cascade solver for device {costs.device}")
    return tuple(AssignmentResult(cfr[0, k], rfc[0, k]) for k in range(3))
