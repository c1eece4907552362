"""The BoT-SORT tracker in plain PyTorch: the slot store, the Kalman
filter, the three thresholded assignments and the track lifecycle.

Frozen copies of the port's ``track/state.py``, ``ops/kalman.py``,
``track/cascade.py`` and the plain cascade solver of ``ops/assignment.py``
(``cascade_solve_plain``: Jonker-Volgenant shortest augmenting paths on the
lap.lapjv extended problem, ties broken as the port's kernels K1 / K2
break them), with no kernel. ``cfg`` is any object with the
``TrackerConfig`` fields (the benchmark passes its own).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.ops import (
    const,
    iou_distance,
    tlbr_to_tlwh,
    tlwh_to_xywh,
    xywh_to_tlbr,
)


FREE = 0


TRACKED = 1


LOST = 2


@dataclasses.dataclass
class TrackStore:
    state: torch.Tensor          # [N] int32
    is_activated: torch.Tensor   # [N] bool
    track_id: torch.Tensor       # [N] int32
    score: torch.Tensor          # [N] f32
    frame_id: torch.Tensor       # [N] int32 — frame of last update
    start_frame: torch.Tensor    # [N] int32
    tracklet_len: torch.Tensor   # [N] int32
    mean: torch.Tensor           # [N, 8] f32 — cx, cy, w, h and velocities
    cov: torch.Tensor            # [N, 4, 3] f32 — per-coordinate 2x2 blocks
    body_feat: torch.Tensor      # [N, Db] f32 — last raw feature
    body_smooth: torch.Tensor    # [N, Db] f32 — EMA-smoothed, normalized
    face_feat: torch.Tensor      # [N, Df] f32
    face_smooth: torch.Tensor    # [N, Df] f32
    det_index: torch.Tensor      # [N] int32 — det slot this frame, or -1
    next_id: torch.Tensor        # [] int32
    frame_count: torch.Tensor    # [] int32
    body_hist: Optional[torch.Tensor] = None  # [N, H, Db] ring buffer
    face_hist: Optional[torch.Tensor] = None  # [N, H, Df]
    hist_pos: Optional[torch.Tensor] = None   # [N] int32 write cursor

    def replace(self, **changes) -> "TrackStore":
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "TrackStore":
        """The store with fn applied to every field that is present."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})


def empty_store(cfg, device=None) -> TrackStore:
    n = cfg.max_tracks
    db = cfg.body_feature_dim
    df = cfg.face_feature_dim
    h = cfg.feature_history
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackStore(
        state=torch.zeros((n,), **i32),
        is_activated=torch.zeros((n,), dtype=torch.bool, device=device),
        track_id=torch.zeros((n,), **i32),
        score=torch.zeros((n,), **f32),
        frame_id=torch.zeros((n,), **i32),
        start_frame=torch.zeros((n,), **i32),
        tracklet_len=torch.zeros((n,), **i32),
        mean=torch.zeros((n, 8), **f32),
        cov=torch.zeros((n, 4, 3), **f32),
        body_feat=torch.zeros((n, db), **f32),
        body_smooth=torch.zeros((n, db), **f32),
        face_feat=torch.zeros((n, df), **f32),
        face_smooth=torch.zeros((n, df), **f32),
        det_index=torch.full((n,), -1, **i32),
        next_id=torch.zeros((), **i32),
        frame_count=torch.zeros((), **i32),
        body_hist=torch.zeros((n, h, db), **f32) if h > 0 else None,
        face_hist=torch.zeros((n, h, df), **f32) if h > 0 else None,
        hist_pos=torch.zeros((n,), **i32) if h > 0 else None,
    )


def empty_stores(cfg, b: int, device=None) -> TrackStore:
    """B empty stores as one, every field with a leading [B]."""
    return empty_store(cfg, device).map(
        lambda x: x.unsqueeze(0).repeat((b,) + (1,) * x.dim()))


STD_WEIGHT_POSITION = 1.0 / 20


STD_WEIGHT_VELOCITY = 1.0 / 160


def _noise_scales(wh: torch.Tensor) -> torch.Tensor:
    """(w, h, w, h) for (cx, cy, w, h): [..., 2] -> [..., 4]."""
    w = wh[..., 0]
    h = wh[..., 1]
    return torch.stack([w, h, w, h], dim=-1)


def initiate(measurement_xywh: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 4] -> (mean [..., 8], cov [..., 4, 3]): zero velocity,
    diagonal covariance with stds 2*w_p*scale and 10*w_v*scale."""
    pos = measurement_xywh
    mean = torch.cat([pos, torch.zeros_like(pos)], dim=-1)
    s = _noise_scales(measurement_xywh[..., 2:4])
    std_p = 2.0 * STD_WEIGHT_POSITION * s
    std_v = 10.0 * STD_WEIGHT_VELOCITY * s
    a = std_p * std_p
    c = std_v * std_v
    cov = torch.stack([a, torch.zeros_like(a), c], dim=-1)
    return mean, cov


def predict(mean: torch.Tensor, cov: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p' = p + v; a' = a + 2b + c + q_p, b' = b + c, c' = c + q_v with
    the noise evaluated at the previous mean's (w, h)."""
    pos = mean[..., :4]
    vel = mean[..., 4:8]
    new_mean = torch.cat([pos + vel, vel], dim=-1)
    s = _noise_scales(mean[..., 2:4])
    q_p = torch.square(STD_WEIGHT_POSITION * s)
    q_v = torch.square(STD_WEIGHT_VELOCITY * s)
    a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
    new_cov = torch.stack([a + 2.0 * b + c + q_p, b + c, c + q_v], dim=-1)
    return new_mean, new_cov


def project(mean: torch.Tensor, cov: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(measurement mean [..., 4], innovation variance S [..., 4])."""
    s = _noise_scales(mean[..., 2:4])
    r = torch.square(STD_WEIGHT_POSITION * s)
    return mean[..., :4], cov[..., 0] + r


def update(mean: torch.Tensor, cov: torch.Tensor,
           measurement_xywh: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form correction: K_p = a/S, K_v = b/S; a+ = a - a^2/S,
    b+ = b - ab/S, c+ = c - b^2/S. S is floored at 1e-12 so a degenerate
    zero-size track updates to a no-op instead of NaN."""
    z_pred, s_innov = project(mean, cov)
    e = measurement_xywh - z_pred
    a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
    inv_s = 1.0 / torch.clamp(s_innov, min=1e-12)
    k_p = a * inv_s
    k_v = b * inv_s
    new_mean = torch.cat([mean[..., :4] + k_p * e, mean[..., 4:8] + k_v * e],
                         dim=-1)
    new_cov = torch.stack(
        [a - a * a * inv_s, b - a * b * inv_s, c - b * b * inv_s], dim=-1)
    return new_mean, new_cov


def apply_affine(mean: torch.Tensor, cov: torch.Tensor,
                 affine_2x3: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-motion compensation with a [..., 2, 3] affine (one per
    leading index of mean [..., N, 8] / cov [..., N, 4, 3]): R applied to
    all four (x, y) state pairs plus t on the position; the covariance
    takes the similarity scale s^2 = |det R| per block (the x/y-mixing
    rotation terms are dropped — the block form cannot hold them)."""
    r = affine_2x3[..., :, :2]
    t = affine_2x3[..., None, :, 2]
    s = torch.sqrt(torch.abs(r[..., 0, 0] * r[..., 1, 1]
                             - r[..., 0, 1] * r[..., 1, 0]))
    rt = r.transpose(-1, -2)
    new_mean = torch.cat([mean[..., 0:2] @ rt + t, mean[..., 2:4] @ rt,
                          mean[..., 4:6] @ rt, mean[..., 6:8] @ rt], dim=-1)
    return new_mean, cov * (s * s)[..., None, None, None]


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


def _augment(e: torch.Tensor, i: int, p: List[int], u: torch.Tensor,
             v: torch.Tensor, max_iters: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augments live row i of the square problem e [S, S] by a shortest
    augmenting path (Dijkstra over the columns with dual updates, then the
    unwind): p (each column's owner row, -1 free) is updated in place, the
    new duals (u, v) are returned. The float32 operations are the kernels'
    (csrc/lap_common.cuh::augment), in their order; argmin ties go to the
    lowest column. Adds the pops to ``jv_solve_plain.pops``."""
    s = e.shape[0]
    dev = e.device
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
        masked = torch.where(used, _INF, minv)
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
    return u, v


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


def _rank_pair(q: torch.Tensor, p: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """Pairs the k-th of ``rows`` with the k-th of ``cols`` (both ascending
    extended indices) while both last: q[row] = col, p[col] = row. Returns
    the rows paired."""
    k = min(rows.numel(), cols.numel())
    q[rows[:k]] = cols[:k]
    p[cols[:k]] = rows[:k]
    return rows[:k]


def _reduce_and_resolve(cost: torch.Tensor, rv: torch.Tensor,
                        cv: torch.Tensor, half: float):
    """What the TPU kernel ``_cascade_kernel`` does to one pass before its
    Dijkstra pops, step for step: live rows rv [n] x live columns cv [d]
    (bool) of cost [n, d] -> (p, q, u, v), each [n + d].

    Extended indices: rows 0..n-1 real, n+j the dummy row of column j;
    columns 0..d-1 real, d+i the escape column of row i. p is each
    column's row, q each row's column (-1: unassigned), u and v the duals.
    The steps: designated parking; the LAPJV column reduction (each live
    column to its lowest minimum live row if that minimum is below half,
    one column per row, v = min(colmin, half)); the won columns' dummy rows
    rank-paired with the escape columns; then ``_post_reduction_resolve``:
    (a) rows whose least reduced cost is >= half take a free escape by
    rank, u = half; (b) two free-column claim rounds (lowest row wins,
    u = its least reduced cost); (c) the dummy rows still unassigned
    rank-paired with the free escapes. Duals stay feasible and every pair
    is tight, so augmenting the rows left from these u and v is exact.
    Every minimum, argmin and rank runs over live entries only, which is
    why the TPU kernel's pad lanes never take part in them.
    """
    n, d = cost.shape
    dev = cost.device
    f32 = torch.float32
    rows = torch.arange(n, device=dev)
    cols = torch.arange(d, device=dev)

    # Column reduction.
    live_cell = rv[:, None] & cv[None, :]
    cost_live = torch.where(live_cell, cost, _INF)
    colmin = cost_live.amin(dim=0)
    rowarg = torch.where(cost_live == colmin, rows[:, None], n).amin(dim=0)
    claim = cv & (colmin < half)
    claimed = (rows[:, None] == rowarg[None, :]) & claim[None, :]
    firstj = torch.where(claimed, cols[None, :], d).amin(dim=1)
    won_col = claim & (firstj[rowarg] == cols)
    p = torch.cat([torch.where(won_col, rowarg,
                               torch.where(claim, -1, n + cols)),
                   torch.where(rv, -1, rows)])
    q = torch.cat([torch.where(firstj < d, firstj,
                               torch.where(rv, -1, d + rows)),
                   torch.where(claim, -1, cols)])
    v = torch.cat([torch.where(cv, colmin.clamp(max=half), 0.0),
                   torch.zeros(n, dtype=f32, device=dev)])
    u = torch.zeros(n + d, dtype=f32, device=dev)
    _rank_pair(q, p, n + cols[won_col], d + rows[rv])

    # (a) The escape fast path.
    reduced = cost - v[:d]
    rowmin = torch.where(live_cell, reduced, _INF).amin(dim=1)
    qual = rv & (q[:n] < 0) & (rowmin >= half)
    took = _rank_pair(q, p, rows[qual], d + rows[rv & (p[d:] < 0)])
    u[took] = half
    # (b) Two free-column claim rounds.
    for _ in range(2):
        free = cv & (p[:d] < 0)
        red_free = torch.where(live_cell & free[None, :], reduced, _INF)
        freemin = red_free.amin(dim=1)
        ok = rv & (q[:n] < 0) & (freemin <= rowmin) & (freemin <= half)
        argj = torch.where(red_free == freemin[:, None], cols[None, :],
                           d).amin(dim=1)
        winrow = torch.where(ok[:, None] & (cols[None, :] == argj[:, None]),
                             rows[:, None], n).amin(dim=0)
        won = ok & (winrow[argj.clamp(max=d - 1)] == rows)
        q[:n] = torch.where(won, argj, q[:n])
        p[:d] = torch.where(winrow < n, winrow, p[:d])
        u[:n] = torch.where(won, rowmin, u[:n])
    # (c) Dummy-row completion.
    _rank_pair(q, p, n + cols[cv & (q[n:] < 0)], d + rows[rv & (p[d:] < 0)])
    return p, q, u, v


def _cascade_pass(cost: torch.Tensor, rv: torch.Tensor, cv: torch.Tensor,
                  half: float, big: torch.Tensor, max_iters: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass of the TPU kernel ``_cascade_kernel``: the reduction and
    resolve (``_reduce_and_resolve``), then a Dijkstra augmentation of each
    row still unassigned, real rows then dummy rows, in ascending order,
    from those duals. Returns (cfr [n], rfc [d]) int32."""
    p, q, u, v = _reduce_and_resolve(cost, rv, cv, half)
    e = _ext_matrix(cost, rv, cv, half, big)
    p_l: List[int] = p.tolist()
    active = torch.cat([rv, cv]) & (q < 0)
    for i in torch.nonzero(active).flatten().tolist():
        u, v = _augment(e, i, p_l, u, v, max_iters)
    owner = torch.tensor(p_l, dtype=torch.int32, device=cost.device)
    return _extract(owner, rv, cv)


def cascade_solve_plain(costs: torch.Tensor, masks: torch.Tensor,
                        big: torch.Tensor, limits: Sequence[float],
                        max_iters: int = MAX_ITERS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernels K1 and K2 on ``prepare_cascade``'s
    output: the TPU kernels ``_cascade_kernel`` / ``_cascade_kernel_ls``
    pass by pass (``_cascade_pass``), so the matchings equal theirs, ties
    included.

    costs [B, 3, N, D]; masks [B, 3N+3D]; big [B] -> (cfr [B, 3, N],
    rfc [B, 3, D]) int32. Pass 1: pool x high1; pass 2: (tracked & pass-1
    unmatched) x low over IoU; pass 3: unconf x (high3 & pass-1 unmatched).
    Each stream keeps its own ``big``; it enters only the parked entries
    of the Dijkstra rows, so the lockstep kernel's one ``big`` (the
    maximum over streams) gives the same matchings.
    """
    bsz, _, n, d = costs.shape
    halves = [half_limit(x) for x in limits]
    cfr_all, rfc_all = [], []
    for b in range(bsz):
        m = masks[b].bool()
        pool, tracked, unconf = m[:n], m[n:2 * n], m[2 * n:3 * n]
        high1 = m[3 * n:3 * n + d]
        high3 = m[3 * n + d:3 * n + 2 * d]
        low = m[3 * n + 2 * d:]
        c1, r1 = _cascade_pass(costs[b, 0], pool, high1, halves[0], big[b],
                               max_iters)
        c2, r2 = _cascade_pass(costs[b, 1], tracked & (c1 < 0), low,
                               halves[1], big[b], max_iters)
        c3, r3 = _cascade_pass(costs[b, 2], unconf, high3 & (r1 < 0),
                               halves[2], big[b], max_iters)
        cfr_all.append(torch.stack([c1, c2, c3]))
        rfc_all.append(torch.stack([r1, r2, r3]))
    return torch.stack(cfr_all), torch.stack(rfc_all)


class TrackOutputs(NamedTuple):
    """Per-frame readback: valid [N] (currently Tracked), tlbr [N, 4],
    track_id / score [N], det_index [N] int32 (body-det slot matched or
    created from this frame), dropped_new [] (new tracks lost to full
    slots). ``tracker_update_batched`` gives each a leading [B]."""

    valid: torch.Tensor
    tlbr: torch.Tensor
    track_id: torch.Tensor
    score: torch.Tensor
    det_index: torch.Tensor
    dropped_new: torch.Tensor


def _ema_update(smooth: torch.Tensor, feat: torch.Tensor, alpha: float,
                apply: torch.Tensor) -> torch.Tensor:
    """normalize(alpha*smooth + (1-alpha)*feat) on the masked rows."""
    mixed = alpha * smooth + (1.0 - alpha) * feat
    norm = torch.linalg.norm(mixed, dim=-1, keepdim=True)
    mixed = mixed / torch.clamp(norm, min=1e-12)
    return torch.where(apply[..., None], mixed, smooth)


def tracker_update_batched(stores: TrackStore, det_tlbr: torch.Tensor,
                           det_score: torch.Tensor, det_valid: torch.Tensor,
                           det_body_feat: torch.Tensor,
                           det_face_feat: torch.Tensor, cfg,
                           gmc_affines: Optional[torch.Tensor] = None
                           ) -> Tuple[TrackStore, TrackOutputs]:
    """One tracker frame of B independent streams (the JAX package's
    ``jax.vmap(tracker_update)``): stores carry a leading [B] on every
    field, det_* a leading [B] before the D slots ([B, D, 4], [B, D],
    ...), gmc_affines is [B, 2, 3] or None. The B cascades' assignments
    are one ``solve_cascade_masked`` call: one launch of the cascade
    kernel on the card.
    """
    bsz, n = stores.state.shape
    d = det_tlbr.shape[1]
    dev = stores.state.device
    frame = stores.frame_count + 1                                # [B]
    i32 = torch.int32
    bi = torch.arange(bsz, device=dev)[:, None]                   # [B, 1]

    tracked_m = (stores.state == TRACKED) & stores.is_activated
    unconfirmed_m = (stores.state == TRACKED) & ~stores.is_activated
    lost_m = stores.state == LOST
    pool_m = tracked_m | lost_m

    # Predict the pool; lost tracks get (vw, vh) zeroed first.
    vel_wh = torch.arange(8, device=dev) >= 6
    mean_z = torch.where(lost_m[..., None] & vel_wh, 0.0, stores.mean)
    mean_p, cov_p = predict(mean_z, stores.cov)
    mean = torch.where(pool_m[..., None], mean_p, stores.mean)
    cov = torch.where(pool_m[..., None, None], cov_p, stores.cov)
    if gmc_affines is not None:
        gmc_m = pool_m | unconfirmed_m
        mean_g, cov_g = apply_affine(mean, cov, gmc_affines)
        mean = torch.where(gmc_m[..., None], mean_g, mean)
        cov = torch.where(gmc_m[..., None, None], cov_g, cov)

    track_tlbr = xywh_to_tlbr(mean[..., :4])
    det_xywh = tlwh_to_xywh(tlbr_to_tlwh(det_tlbr))

    high_m = det_valid & (det_score > cfg.track_high_thresh)
    low_m = (det_valid & (det_score >= cfg.track_low_thresh)
             & (det_score <= cfg.track_high_thresh))

    # Pass-1 cost: IoU fused with the dual appearance distance.
    iou_d = iou_distance(track_tlbr, det_tlbr)                    # [B, N, D]
    body_sim = stores.body_feat @ det_body_feat.transpose(-1, -2)
    face_sim = stores.face_feat @ det_face_feat.transpose(-1, -2)
    face_sim = torch.where(face_sim > 0.99999, 0.0, face_sim)
    body_d = 1.0 - body_sim
    face_d = 1.0 - face_sim
    gate = torch.minimum(body_d, face_d) > cfg.appearance_thresh
    emb = torch.where(gate, 1.0, body_d)
    dists1 = torch.minimum(iou_d, emb)
    # Pass-3 cost: IoU + clamped body cosine, appearance and proximity
    # masks set 1.
    emb3 = 1.0 - torch.clamp(body_sim, min=0.0)
    emb3 = torch.where(emb3 > cfg.appearance_thresh, 1.0, emb3)
    emb3 = torch.where(iou_d > cfg.proximity_thresh, 1.0, emb3)
    dists3 = torch.minimum(iou_d, emb3)

    res1, res2, res3 = solve_cascade_masked(
        dists1, iou_d, dists3, pool_m, tracked_m, unconfirmed_m, high_m,
        low_m, (cfg.match_thresh, cfg.second_match_thresh,
                cfg.unconfirmed_match_thresh))

    r_tracked_m = tracked_m & (res1.col_for_row < 0)
    newly_lost_m = r_tracked_m & (res2.col_for_row < 0)
    removed_unconfirmed_m = unconfirmed_m & (res3.col_for_row < 0)
    leftover_m = high_m & (res1.row_for_col < 0)

    # Fused measurement update for every matched row (disjoint row sets).
    det_for_row = torch.where(
        res1.col_for_row >= 0, res1.col_for_row,
        torch.where(res2.col_for_row >= 0, res2.col_for_row,
                    res3.col_for_row))
    matched_m = det_for_row >= 0
    j = torch.clamp(det_for_row, 0, d - 1).long()                 # [B, N]
    mean_u, cov_u = update(mean, cov, det_xywh[bi, j])
    mean = torch.where(matched_m[..., None], mean_u, mean)
    cov = torch.where(matched_m[..., None, None], cov_u, cov)

    was_lost_refound = matched_m & lost_m
    body_j, face_j = det_body_feat[bi, j], det_face_feat[bi, j]
    body_feat = torch.where(matched_m[..., None], body_j, stores.body_feat)
    face_feat = torch.where(matched_m[..., None], face_j, stores.face_feat)
    body_smooth = _ema_update(stores.body_smooth, body_j,
                              cfg.feature_ema_alpha, matched_m)
    face_smooth = _ema_update(stores.face_smooth, face_j,
                              cfg.feature_ema_alpha, matched_m)

    frame_n = frame[:, None]                                      # [B, 1]
    score = torch.where(matched_m, det_score[bi, j], stores.score)
    frame_id = torch.where(matched_m, frame_n, stores.frame_id).to(i32)
    tracklet_len = torch.where(
        matched_m,
        torch.where(was_lost_refound, 0, stores.tracklet_len + 1),
        stores.tracklet_len).to(i32)
    state = torch.where(matched_m, TRACKED, stores.state).to(i32)
    is_activated = matched_m | stores.is_activated
    state = torch.where(newly_lost_m, LOST, state).to(i32)
    state = torch.where(removed_unconfirmed_m, FREE, state).to(i32)

    # New tracks from the remaining high dets, scattered into each
    # stream's free slots in detection order.
    remaining_m = leftover_m & (res3.row_for_col < 0)
    new_m = remaining_m & (det_score >= cfg.new_track_thresh)
    free_m = state == FREE
    det_rank = torch.cumsum(new_m.to(i32), 1) - 1                 # [B, D]
    slot_rank = torch.cumsum(free_m.to(i32), 1) - 1               # [B, N]
    num_free = free_m.sum(1, keepdim=True)                        # [B, 1]
    # slot_of_rank[b, r] = the r-th free slot of stream b; index n absorbs
    # the occupied slots.
    slot_of_rank = torch.full((bsz, n + 1), n, dtype=torch.int64,
                              device=dev)
    slot_of_rank.scatter_(
        1, torch.where(free_m, slot_rank, n).long(),
        torch.arange(n, device=dev).expand(bsz, n).contiguous())
    fits = new_m & (det_rank < num_free)
    target_slot = torch.where(
        fits, torch.gather(slot_of_rank, 1,
                           torch.clamp(det_rank, 0, n).long()), n)

    def scatter(arr, vals):
        # Det-indexed values into track slots through an [n+1] buffer
        # per stream whose last row absorbs the non-fitting candidates.
        buf = torch.cat([arr, torch.zeros_like(arr[:, :1])], dim=1)
        buf[bi, target_slot] = vals.to(arr.dtype)
        return buf[:, :n]

    new_mean, new_cov = initiate(det_xywh)
    mean = scatter(mean, new_mean)
    cov = scatter(cov, new_cov)
    state = scatter(state, torch.where(fits, TRACKED, FREE))
    is_activated = scatter(is_activated, fits & (frame_n == 1))
    score = scatter(score, det_score)
    frame_full = frame_n.expand(bsz, d)
    frame_id = scatter(frame_id, frame_full)
    start_frame = scatter(stores.start_frame, frame_full)
    tracklet_len = scatter(tracklet_len, torch.zeros_like(det_rank))
    new_ids = stores.next_id[:, None] + 1 + det_rank
    track_id = scatter(stores.track_id, new_ids)
    next_id = (stores.next_id + fits.sum(1)).to(i32)
    dropped_new = (new_m.sum(1) - fits.sum(1)).to(i32)
    body_feat = scatter(body_feat, det_body_feat)
    face_feat = scatter(face_feat, det_face_feat)
    body_smooth = scatter(body_smooth, det_body_feat)
    face_smooth = scatter(face_smooth, det_face_feat)

    det_index = torch.where(matched_m, det_for_row, -1).to(i32)
    det_index = scatter(det_index,
                        torch.arange(d, device=dev).expand(bsz, d))
    det_index = torch.where(state == TRACKED, det_index, -1).to(i32)

    # Expire lost tracks.
    expired_m = (state == LOST) & (frame_n - frame_id > cfg.max_time_lost)
    state = torch.where(expired_m, FREE, state).to(i32)

    # Dedup tracked vs lost pairs with IoU distance < 0.15: the
    # shorter-lived side goes (a tie drops the tracked one).
    final_tlbr = xywh_to_tlbr(mean[..., :4])
    trk_m = state == TRACKED
    lst_m = state == LOST
    dd = iou_distance(final_tlbr, final_tlbr)                     # [B, N, N]
    pair = (dd < 0.15) & trk_m[..., :, None] & lst_m[..., None, :]
    lifetime = frame_id - start_frame
    p_longer = lifetime[..., :, None] > lifetime[..., None, :]
    drop_lost = (pair & p_longer).any(dim=-2)
    drop_tracked = (pair & ~p_longer).any(dim=-1)
    state = torch.where(drop_lost | drop_tracked, FREE, state).to(i32)

    new_stores = stores.replace(
        state=state,
        is_activated=is_activated & (state != FREE),
        track_id=track_id,
        score=score,
        frame_id=frame_id,
        start_frame=start_frame,
        tracklet_len=tracklet_len,
        mean=mean,
        cov=cov,
        body_feat=body_feat,
        body_smooth=body_smooth,
        face_feat=face_feat,
        face_smooth=face_smooth,
        det_index=det_index,
        next_id=next_id,
        frame_count=frame.to(i32),
    )
    if stores.body_hist is not None:
        # Every slot that took a detection feature this frame appends to
        # its ring; new tracks restart at position 0.
        wrote = det_index >= 0
        is_new = wrote & (start_frame == frame_n)
        pos = torch.where(is_new, 0, stores.hist_pos).to(i32)
        h = stores.body_hist.shape[2]
        rows = torch.arange(n, device=dev)[None, :]
        slot = (pos % h).long()
        body_hist = stores.body_hist.clone()
        face_hist = stores.face_hist.clone()
        body_hist[bi, rows, slot] = torch.where(
            wrote[..., None], body_feat, stores.body_hist[bi, rows, slot])
        face_hist[bi, rows, slot] = torch.where(
            wrote[..., None], face_feat, stores.face_hist[bi, rows, slot])
        new_stores = new_stores.replace(
            body_hist=body_hist, face_hist=face_hist,
            hist_pos=torch.where(wrote, pos + 1, pos).to(i32))

    outputs = TrackOutputs(
        valid=state == TRACKED,
        tlbr=final_tlbr,
        track_id=track_id,
        score=score,
        det_index=det_index,
        dropped_new=dropped_new,
    )
    return new_stores, outputs


def solve_cascade_masked(dists1, iou_d, dists3, pool_m, tracked_m, unconf_m,
                         high_m, low_m, limits: Sequence[float],
                         max_iters: int = MAX_ITERS):
    """The cascade's three chained thresholded LAPs for B streams (costs
    [B, N, D], masks [B, N] / [B, D]): three AssignmentResults with a
    leading [B]."""
    costs, masks, big = prepare_cascade(dists1, iou_d, dists3, pool_m,
                                        tracked_m, unconf_m, high_m, low_m,
                                        limits)
    cfr, rfc = cascade_solve_plain(costs, masks, big, limits, max_iters)
    return tuple(AssignmentResult(cfr[..., k, :], rfc[..., k, :])
                 for k in range(3))
