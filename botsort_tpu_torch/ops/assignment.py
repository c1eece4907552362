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
chained solves, for one stream or for B streams at once. For CUDA tensors
it launches the cascade kernel (ops/assignment_cuda.py, csrc/
cascade_lap.cu: K1 at one stream, K2 at B); for CPU tensors it runs
``cascade_solve_plain``, the plain PyTorch version of the same function,
which performs the kernel's float32 operations in the kernel's order and
is the oracle the kernel is checked against. Both share ``prepare_cascade``
(one ``big`` over all three passes, feasibility pre-parking per pass), so
their matchings are equal, ties included.

``solve_masked`` is one thresholded LAP. It dispatches the same way: CUDA
tensors launch kernel K3 (csrc/jv_lap.cu) on the materialised square
problem, CPU tensors take ``jv_solve_plain`` — the loop K1's plain version
runs too, so the card has a second solver to hold K1 and K2 against.

Each solver is also a custom op, ``torch.ops.botsort_tpu_torch.cascade_solve``
(K1/K2) and ``torch.ops.botsort_tpu_torch.jv_solve`` (K3), with the kernel
as its CUDA and the plain version as its CPU implementation: a trace
(``torch.export``) reaches the solvers only through them, and sees their
output shapes only. Eager calls skip the dispatcher.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from botsort_tpu_torch.utils.consts import const, tracing

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
    half_t = const(half, f32, dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    big = big.to(f32)
    ext = torch.zeros((n + d, n + d), dtype=f32, device=dev)
    live = torch.where(cv[None, :], cost, big)
    ext[:n, :d] = torch.where(rv[:, None], live, big)
    ext[:n, d:] = torch.where(rv[:, None], half_t, zero).expand(n, n)
    ext[n:, :d] = torch.where(cv[None, :], half_t, zero).expand(d, d)
    return ext


def _parking(rv: torch.Tensor, cv: torch.Tensor):
    """Designated parking of the extended problem for live rows rv [n] /
    cols cv [d]: (p0 [S], live_order [S], n_live []) int32, S = n + d.
    p0 is each column's pre-matched owner (-1 free): dummy row n+j owns
    parked column j, parked row i owns dummy column d+i. live_order lists
    the live extended rows (real, then dummy) ascending, then S."""
    n, d = rv.shape[0], cv.shape[0]
    s = n + d
    dev = rv.device
    p0 = torch.cat([torch.where(cv, -1, n + torch.arange(d, device=dev)),
                    torch.where(rv, -1, torch.arange(n, device=dev))])
    live = torch.cat([rv, cv])
    live_order = torch.sort(torch.where(
        live, torch.arange(s, device=dev), s)).values
    i32 = torch.int32
    return p0.to(i32), live_order.to(i32), live.sum().to(i32)


def _extract(owner: torch.Tensor, rv: torch.Tensor, cv: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cfr [n], rfc [d]) int32 from the extended problem's column owners
    [S]: column j's live real owner row, and its inverse."""
    n, d = rv.shape[0], cv.shape[0]
    o = owner[:d].long()
    real = cv & (o >= 0) & (o < n) & rv[o.clamp(0, max(n - 1, 0))]
    rfc = torch.where(real, o, -1)
    cfr = torch.full((n + 1,), -1, dtype=torch.int64, device=owner.device)
    cfr[torch.where(real, o, n)] = torch.arange(d, device=owner.device)
    return cfr[:n].to(torch.int32), rfc.to(torch.int32)


def jv_solve_plain(ext: torch.Tensor, p0: torch.Tensor,
                   live_order: torch.Tensor, n_live: torch.Tensor,
                   max_iters: int = MAX_ITERS) -> torch.Tensor:
    """Plain PyTorch version of kernel K3 (csrc/jv_lap.cu), and the loop
    K1's plain version runs: exact Jonker-Volgenant solves of square
    extended problems.

    ext [B, S, S] f32; p0 [B, S] int32 (pre-matched owner of each column,
    -1 free); live_order [B, S] int32 (rows to augment, ascending, then
    the sentinel S); n_live [B] int32 -> owner [B, S] int32, the row that
    owns each column. Each live row is augmented by a shortest augmenting
    path with dual potentials; the float32 operations are the kernel's,
    in its order. ``jv_solve_plain.pops`` counts the Dijkstra pops of every
    call (the kernels' sequential steps; the count depends only on the
    data).
    """
    bsz, s, _ = ext.shape
    dev = ext.device
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    owners = []
    for b in range(bsz):
        e = ext[b]
        # p[j] = owner row of column j (-1 free); kept on the host because
        # the augmenting loop branches on it every pop.
        p: List[int] = p0[b].tolist()
        u = torch.zeros(s, dtype=torch.float32, device=dev)
        v = torch.zeros(s, dtype=torch.float32, device=dev)
        for i in live_order[b, :int(n_live[b])].tolist():
            minv = torch.full((s,), _INF, dtype=torch.float32, device=dev)
            way = torch.full((s,), s, dtype=torch.int64, device=dev)
            used = torch.zeros(s, dtype=torch.bool, device=dev)
            on_path = torch.zeros(s, dtype=torch.bool, device=dev)
            cur, j_from, done, it = i, s, False, 0
            while not done and it < max_iters:
                on_path[cur] = True
                reduced = e[cur] - u[cur] - v
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
            jv_solve_plain.pops += it
            way_l = way.tolist()
            j0, it = j_from, 0
            while j0 < s and it < max_iters:
                j1 = way_l[j0]
                p[j0] = i if j1 >= s else p[j1]
                j0 = j1
                it += 1
        owners.append(p)
    return torch.tensor(owners, dtype=torch.int32,
                        device=dev).reshape(bsz, s)


jv_solve_plain.pops = 0


@torch.library.custom_op("botsort_tpu_torch::jv_solve", mutates_args=(),
                         device_types="cpu")
def jv_solve_op(ext: torch.Tensor, p0: torch.Tensor,
                live_order: torch.Tensor, n_live: torch.Tensor,
                max_iters: int) -> torch.Tensor:
    """K3 as a custom op: ``jv_solve_plain`` on the CPU, the kernel on the
    card (registered below)."""
    return jv_solve_plain(ext, p0, live_order, n_live, max_iters)


@jv_solve_op.register_kernel("cuda")
def _jv_solve_op_cuda(ext, p0, live_order, n_live, max_iters):
    from botsort_tpu_torch.ops.assignment_cuda import jv_solve_cuda

    return jv_solve_cuda(ext, p0, live_order, n_live, max_iters)


@jv_solve_op.register_fake
def _jv_solve_op_fake(ext, p0, live_order, n_live, max_iters):
    return ext.new_empty(tuple(p0.shape), dtype=torch.int32)


def _jv_extended(cost: torch.Tensor, rv: torch.Tensor, cv: torch.Tensor,
                 half: float, big: torch.Tensor,
                 max_iters: int = MAX_ITERS) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Exact solve of the extended problem for live rows rv [n] / cols
    cv [d] (bool) with the plain solver. Returns (cfr [n], rfc [d])
    int32."""
    ext = _ext_matrix(cost, rv, cv, half, big)
    p0, live_order, n_live = _parking(rv, cv)
    owner = jv_solve_plain(ext[None], p0[None], live_order[None],
                           n_live[None], max_iters)
    return _extract(owner[0], rv, cv)


def masked_problem(cost: torch.Tensor, row_valid: torch.Tensor,
                   col_valid: torch.Tensor, cost_limit: float):
    """``solve_masked``'s square problem: feasibility pre-parking, ``big``
    from the problem's valid entries, the extended matrix and its
    parking. Returns (ext [S, S], p0 [S], live_order [S], n_live [],
    row_valid, col_valid) with the pre-parked masks."""
    cost = cost.to(torch.float32)
    limit = const(cost_limit, torch.float32, cost.device)
    valid_pair = row_valid[:, None] & col_valid[None, :]
    feasible = valid_pair & (cost <= limit)
    row_valid = row_valid & feasible.any(dim=1)
    col_valid = col_valid & feasible.any(dim=0)
    pair = row_valid[:, None] & col_valid[None, :]
    finite_max = torch.where(pair, cost.abs(), 0.0).amax()
    big = finite_max + limit.abs() + 1.0
    ext = _ext_matrix(cost, row_valid, col_valid, half_limit(cost_limit),
                      big)
    return (ext, *_parking(row_valid, col_valid), row_valid, col_valid)


def solve_masked(cost: torch.Tensor, row_valid: torch.Tensor,
                 col_valid: torch.Tensor, cost_limit: float,
                 max_iters: int = MAX_ITERS) -> AssignmentResult:
    """One thresholded LAP over a padded cost [N, D] with validity masks
    (botsort_tpu.ops.assignment.solve_masked).

    CUDA tensors launch kernel K3 (ops/assignment_cuda.py,
    csrc/jv_lap.cu); CPU tensors take its plain version; any other device
    raises.
    """
    ext, p0, live_order, n_live, rv, cv = masked_problem(
        cost, row_valid, col_valid, cost_limit)
    args = (ext[None], p0[None], live_order[None], n_live[None], max_iters)
    if tracing():
        owner = jv_solve_op(*args)
    elif ext.is_cuda:
        from botsort_tpu_torch.ops.assignment_cuda import jv_solve_cuda

        owner = jv_solve_cuda(*args)
    elif ext.device.type == "cpu":
        owner = jv_solve_plain(*args)
    else:
        raise ValueError(f"no assignment solver for device {ext.device}")
    return AssignmentResult(*_extract(owner[0], rv, cv))


def prepare_cascade(dists1, iou_d, dists3, pool_m, tracked_m, unconf_m,
                    high_m, low_m, limits: Sequence[float]):
    """Shared host-side prep of the fused cascade solve (the TPU path's
    cascade_solve_pallas prep): NaN/inf-free costs, one ``big`` over all
    three passes, and per-pass feasibility pre-parking — an endpoint with
    no entry <= the pass limit is unmatched in every optimal solution, so
    it enters parked. Pass-2 rows and pass-3 columns depend on pass 1's
    matching and are pre-parked on their superset masks (tracked / high);
    the solver intersects them with pass 1's outcome.

    Costs [..., N, D], row masks [..., N], column masks [..., D], with any
    leading stream dimensions (each stream keeps its own ``big``).
    Returns costs [..., 3, N, D] f32, masks [..., 3N+3D] int32 (pool,
    tracked, unconf, high1, high3, low) and big [...] f32.
    """
    f32 = torch.float32
    lim = [const(x, f32, dists1.device) for x in limits]
    costs = torch.stack([dists1, iou_d, dists3], dim=-3).to(f32)
    costs = torch.nan_to_num(costs, posinf=1e9, neginf=-1e9)
    big = (costs.abs().amax(dim=(-3, -2, -1))
           + max(abs(float(x)) for x in limits) + 1.0)

    def feasible(rows, cols, cost, limit):
        fits = cost.to(f32) <= limit
        return rows[..., :, None] & cols[..., None, :] & fits

    f1 = feasible(pool_m, high_m, dists1, lim[0])
    f2 = feasible(tracked_m, low_m, iou_d, lim[1])
    f3 = feasible(unconf_m, high_m, dists3, lim[2])
    masks = torch.cat([
        pool_m & f1.any(dim=-1),
        tracked_m & f2.any(dim=-1),
        unconf_m & f3.any(dim=-1),
        high_m & f1.any(dim=-2),
        high_m & f3.any(dim=-2),
        low_m & f2.any(dim=-2),
    ], dim=-1).to(torch.int32)
    return costs.contiguous(), masks, big.to(f32)


def cascade_solve_plain(costs: torch.Tensor, masks: torch.Tensor,
                        big: torch.Tensor, limits: Sequence[float],
                        max_iters: int = MAX_ITERS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernels K1 and K2 on ``prepare_cascade``'s
    output.

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


@torch.library.custom_op("botsort_tpu_torch::cascade_solve", mutates_args=(),
                         device_types="cpu")
def cascade_solve_op(costs: torch.Tensor, masks: torch.Tensor,
                     big: torch.Tensor, limits: List[float],
                     max_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (B = 1) and K2 (B > 1) as a custom op on ``prepare_cascade``'s
    output: ``cascade_solve_plain`` on the CPU, the kernel on the card
    (registered below)."""
    return cascade_solve_plain(costs, masks, big, limits, max_iters)


@cascade_solve_op.register_kernel("cuda")
def _cascade_solve_op_cuda(costs, masks, big, limits, max_iters):
    from botsort_tpu_torch.ops.assignment_cuda import cascade_solve_cuda

    return cascade_solve_cuda(costs, masks, big, limits, max_iters)


@cascade_solve_op.register_fake
def _cascade_solve_op_fake(costs, masks, big, limits, max_iters):
    bsz, _, n, d = costs.shape
    return (costs.new_empty((bsz, 3, n), dtype=torch.int32),
            costs.new_empty((bsz, 3, d), dtype=torch.int32))


def solve_cascade_masked(dists1, iou_d, dists3, pool_m, tracked_m, unconf_m,
                         high_m, low_m, limits: Sequence[float],
                         max_iters: int = MAX_ITERS):
    """The association cascade's three chained thresholded LAPs.

    Pass 1: pool_m x high_m over dists1 (limit limits[0]).
    Pass 2: (tracked_m & pass-1-row-unmatched) x low_m over iou_d.
    Pass 3: unconf_m x (high_m & pass-1-col-unmatched) over dists3.
    Returns (res1, res2, res3) AssignmentResults.

    Costs [N, D] with masks [N] / [D] are one stream's cascade; costs
    [B, N, D] with masks [B, N] / [B, D] are B streams' cascades, solved
    together, and the results carry the leading [B].

    CUDA tensors launch the cascade kernel once for all streams (K1 at one
    stream, K2 at B); CPU tensors take the plain version; any other device
    raises. There is no fallback between the two: a kernel that fails to
    build or launch raises. Under a trace, the custom op.
    """
    costs, masks, big = prepare_cascade(dists1, iou_d, dists3, pool_m,
                                        tracked_m, unconf_m, high_m, low_m,
                                        limits)
    single = costs.dim() == 3
    if single:
        costs, masks, big = costs[None], masks[None], big[None]
    if tracing():
        cfr, rfc = cascade_solve_op(costs, masks, big,
                                    [float(x) for x in limits], max_iters)
    elif costs.is_cuda:
        from botsort_tpu_torch.ops.assignment_cuda import cascade_solve_cuda

        cfr, rfc = cascade_solve_cuda(costs, masks, big, limits, max_iters)
    elif costs.device.type == "cpu":
        cfr, rfc = cascade_solve_plain(costs, masks, big, limits, max_iters)
    else:
        raise ValueError(f"no cascade solver for device {costs.device}")
    if single:
        cfr, rfc = cfr[0], rfc[0]
    return tuple(AssignmentResult(cfr[..., k, :], rfc[..., k, :])
                 for k in range(3))
