"""The hierarchy's sequential claims (ops/hierarchy.py: ``greedy_scan``,
the plain version of kernel K10) against the JAX package's
``greedy_assign_batch`` (botsort_tpu/ops/hierarchy.py, its ``lax.scan``
jitted), on the same numpy-seeded problems: the integer picks exactly,
ties included. Then the custom op ``botsort_tpu_torch::hierarchy_scan``
on the CPU against the plain version, its fake under ``torch.export``,
and the dispatcher's routes. K10 itself is held to the plain version on
the card (tests/test_torch_cuda.py, ``-k k10``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.ops import hierarchy as jhier
from botsort_tpu_torch.ops import hierarchy as thier
from torch_scenes import (HIER_KINDS, HIER_ROUNDS, hierarchy_case,
                          hierarchy_problems)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnums=4)
def _jax_picks(base, base_valid, target, target_valid, rounds):
    """JAX greedy_assign_batch as [B, P, R] picks (-1 in the rounds a
    problem does not claim)."""
    res = jhier.greedy_assign_batch(
        [(base[i], base_valid[i], target[i], target_valid[i], r)
         for i, r in enumerate(rounds)])
    full = jnp.full((base.shape[1],), -1, jnp.int32)
    return jnp.stack([jnp.stack([res[i][r] if r < len(res[i]) else full
                                 for r in range(max(rounds))], -1)
                      for i in range(len(rounds))], 1)


def _port_picks(case):
    res = thier.greedy_assign_batch(
        hierarchy_problems(case, torch.from_numpy))
    r_max = max(case[4])
    full = torch.full((case[0].shape[1],), -1, dtype=torch.int32)
    return torch.stack([torch.stack([res[i][r] if r < len(res[i]) else full
                                     for r in range(r_max)], -1)
                        for i in range(len(res))], 1)


# (problems, bases, targets, kind, rounds pattern); the step's (1, 1, 2)
# pattern keeps the cases' earlier names.
CASES = [(3, 50, 50, kind, HIER_ROUNDS) for kind in HIER_KINDS] + \
    [(24, 50, 50, kind, HIER_ROUNDS) for kind in HIER_KINDS] + \
    [(3, 37, 45, "random", HIER_ROUNDS), (6, 20, 70, "grid", HIER_ROUNDS),
     (1, 50, 50, "dupes", HIER_ROUNDS),
     (3, 4, 1100, "random", HIER_ROUNDS), (3, 6, 1100, "grid", HIER_ROUNDS),
     (3, 2, 100, "random", (1, 1, 33)), (6, 3, 120, "dupes", (1, 1, 33))]


def _case_id(case):
    problems, n_bases, n_targets, kind, pattern = case
    name = f"{problems}-{n_bases}-{n_targets}-{kind}"
    return name if pattern == HIER_ROUNDS else f"{name}-R{max(pattern)}"


@pytest.mark.parametrize("problems,n_bases,n_targets,kind,pattern", CASES,
                         ids=[_case_id(c) for c in CASES])
def test_greedy_scan_plain_equals_jax(problems, n_bases, n_targets, kind,
                                      pattern):
    """b = T = 50 at P = 3 and 24 (one frame's and eight frames' problems)
    with rounds (1, 1, 2), odd sizes (T across the warp's 32 lanes), T =
    1,100 (above the 1,024 targets of K10's warp-a-problem form) and R =
    33 (above one 32-bit word of rounds): the port's picks through
    greedy_assign_batch (greedy_scan_plain on the CPU) equal the jitted
    JAX scan's, bit for bit."""
    rng = np.random.default_rng(1000 * problems + n_targets
                                + HIER_KINDS.index(kind))
    case = hierarchy_case(rng, problems, n_bases, n_targets, kind, pattern)
    want = np.asarray(_jax_picks(*(jnp.asarray(a) for a in case[:4]),
                                 case[4]))
    got = _port_picks(case).numpy()
    np.testing.assert_array_equal(got, want)
    # The cases hold what they are named for.
    claimed = (got >= 0).sum()
    if kind == "invalid":
        assert (got[:, ::3] == -1).all() and (got[:, 1] == -1).all()
    else:
        assert claimed > problems * min(n_bases, n_targets) // 4
    if problems > 2:
        assert (got[:, 0::3, 1] == -1).all()   # one-round problems
    if max(pattern) > 32:                      # claims past round 32
        assert got.shape[2] == max(pattern) and (got[:, :, 32:] >= 0).any()


def _scan_args(problems, n, kind, seed):
    case = hierarchy_case(np.random.default_rng(seed), problems, n, n, kind)
    return thier.scan_inputs(hierarchy_problems(case, torch.from_numpy))


@pytest.mark.parametrize("kind", ["dupes", "invalid"])
def test_hierarchy_scan_op_equals_plain(kind):
    """The custom op on the CPU is the plain version (opcheck: schema,
    fake, dispatch), and the dispatcher takes the plain version for CPU
    tensors."""
    args = _scan_args(6, 50, kind, 5)
    want = thier.greedy_scan_plain(*args)
    assert want.dtype == torch.int32 and want.shape == (50, 6, 2)
    assert torch.equal(thier.greedy_scan_op(*args), want)
    assert torch.equal(thier.greedy_scan(*args), want)
    torch.library.opcheck(thier.greedy_scan_op, args)


def test_hierarchy_scan_fake_shapes_under_export():
    """Under torch.export greedy_assign_batch calls the op, whose fake
    gives picks [B, P, R] int32; the program computes the eager picks."""
    case = hierarchy_case(np.random.default_rng(8), 3, 12, 20, "dupes")
    arrays = [torch.from_numpy(a) for a in case[:4]]

    class Hier(torch.nn.Module):
        def forward(self, base, base_valid, target, target_valid):
            res = thier.greedy_assign_batch(
                [(base[i], base_valid[i], target[i], target_valid[i], r)
                 for i, r in enumerate(case[4])])
            return tuple(x for picks in res for x in picks)

    ep = torch.export.export(Hier(), tuple(arrays))
    scans = [n for n in ep.graph.nodes
             if str(n.target) == "botsort_tpu_torch.hierarchy_scan.default"]
    assert len(scans) == 1
    fake = scans[0].meta["val"]
    assert fake.shape == (12, 3, 2) and fake.dtype == torch.int32
    got = ep.module()(*arrays)
    want = Hier()(*arrays)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == (12,) and torch.equal(g, w)


def test_greedy_scan_routes():
    """Any device but the CPU and the card raises; the CUDA wrapper
    refuses CPU tensors (the plain version is their route)."""
    args = _scan_args(3, 8, "random", 2)
    with pytest.raises(ValueError, match="no kernel"):
        thier.greedy_scan(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="CUDA tensors"):
        thier.greedy_scan_cuda(*args)


# --- K10's order-preserving keys, mirrored in torch integer ops ------------

_U32 = 0xFFFFFFFF
_ZERO_KEY, _NAN_KEY, _INF_KEY = 0x80000000, 0xFFFFFFFF, 0xFF800000


def _bits(x):
    """float32 bits as int64 in [0, 2^32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _U32


def _order_key(u):
    """csrc/hierarchy_scan.cu's monotone map of float32 bits: -0 taken as
    +0, negatives complemented, positives above them."""
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where((u & 0x80000000) != 0, u ^ _U32, u | 0x80000000)


def _iou_key(x):
    """iou_key: NaN above every number."""
    u = _bits(x)
    return torch.where((u & 0x7FFFFFFF) > 0x7F800000,
                       torch.full_like(u, _NAN_KEY), _order_key(u))


def _dist_key(x):
    """dist_key: NaN below every number."""
    u = _bits(x)
    return torch.where((u & 0x7FFFFFFF) > 0x7F800000, torch.zeros_like(u),
                       _order_key(u))


def _claims_by_keys(iou, dist, used0, round_active):
    """K10's claim as csrc/hierarchy_scan.cu makes it: keys once a row, a
    used target at 0's key; best = max of the IoU keys; d = min of the
    distance keys of the targets at best (+inf's key elsewhere); idx = the
    least index whose key is d; found = best above 0's key, not NaN's, and
    the round active. Returns the picks [B, P, R] and how often a row's
    best was NaN, a pick's distance was NaN and a pick had a tied rival."""
    p, b, t = iou.shape
    t_idx = torch.arange(t)[None, :]
    ik, dk = _iou_key(iou), _dist_key(dist)
    used = used0.clone()
    picks = torch.empty((b, p, round_active.shape[1]), dtype=torch.int32)
    seen = dict(nan_best=0, nan_dist=0, tie=0)
    for bi in range(b):
        for r in range(round_active.shape[1]):
            row = torch.where(used, _ZERO_KEY, ik[:, bi])
            best = row.amax(-1)
            found = (best > _ZERO_KEY) & (best != _NAN_KEY) & \
                round_active[:, r]
            d = torch.where(row == best[:, None], dk[:, bi], _INF_KEY)
            least = d.amin(-1)
            at_least = d == least[:, None]
            idx = torch.where(at_least, t_idx, t).amin(-1)
            picks[bi, :, r] = torch.where(found, idx, -1).to(torch.int32)
            used = used | ((t_idx == idx[:, None]) & found[:, None])
            seen["nan_best"] += int(((best == _NAN_KEY)
                                     & round_active[:, r]).sum())
            seen["nan_dist"] += int((found & (least == 0)).sum())
            seen["tie"] += int((found & (at_least.sum(-1) > 1)).sum())
    return picks, seen


_NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001],
                     np.uint32).view(np.float32)
# IoU and distance values around every edge of the order: NaNs (quiet,
# negative, signalling), +-0, +-inf, subnormals and repeated values.
_IOU_POOL = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40,
                      0.5, 0.5, 0.75, 1.0, -0.25, 3.4e38], np.float32)
_DIST_POOL = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 2.5, 2.5,
                       7.0, -3.0, 1e-40], np.float32)


def _adversarial(rng, problems, n_bases, n_targets, pattern):
    """Rows drawn from the pools, each problem with its own NaN rate (none,
    rare, frequent) for IoU and for distance; 20% of targets used from the
    start; rounds ``pattern`` repeated."""
    def draw(pool, nan_rate):
        vals = rng.choice(pool, (problems, n_bases, n_targets))
        nan = rng.uniform(0, 1, vals.shape) < nan_rate[:, None, None]
        return np.where(nan, rng.choice(_NAN_BITS, vals.shape), vals)

    rates = np.array([0.0, 0.004, 0.05])
    iou = draw(_IOU_POOL, rates[np.arange(problems) % 3])
    dist = draw(_DIST_POOL, rates[(np.arange(problems) // 3) % 3])
    used0 = rng.uniform(0, 1, (problems, n_targets)) < 0.2
    rounds = [pattern[i % len(pattern)] for i in range(problems)]
    active = np.arange(max(pattern))[None, :] < np.array(rounds)[:, None]
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (iou, dist, used0, active)]


@pytest.mark.parametrize("problems,n_bases,n_targets,pattern", [
    (18, 12, 7, HIER_ROUNDS), (9, 10, 40, HIER_ROUNDS),
    (9, 6, 70, (1, 1, 33))])
def test_claims_by_keys_equal_the_plain_version(problems, n_bases,
                                                n_targets, pattern):
    """The claims K10 makes by its 32-bit keys (mirrored here in torch
    integer ops) pick what greedy_scan_plain picks with float compares, on
    rows of NaN IoU and distance, +-0, +-inf, subnormals and exact ties;
    the rows reach each of those cases."""
    rng = np.random.default_rng(problems * 100 + n_targets)
    args = _adversarial(rng, problems, n_bases, n_targets, pattern)
    got, seen = _claims_by_keys(*args)
    want = thier.greedy_scan_plain(*args)
    assert torch.equal(got, want)
    assert (want >= 0).sum() > problems * n_bases // 2
    assert seen["nan_best"] > 0 and seen["nan_dist"] > 0 and seen["tie"] > 0
    assert (want == -1).sum() > 0
