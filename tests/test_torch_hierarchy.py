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
from torch_scenes import HIER_KINDS, hierarchy_case, hierarchy_problems


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


CASES = [(3, 50, 50, kind) for kind in HIER_KINDS] + \
    [(24, 50, 50, kind) for kind in HIER_KINDS] + \
    [(3, 37, 45, "random"), (6, 20, 70, "grid"), (1, 50, 50, "dupes")]


@pytest.mark.parametrize("problems,n_bases,n_targets,kind", CASES)
def test_greedy_scan_plain_equals_jax(problems, n_bases, n_targets, kind):
    """b = T = 50 at P = 3 and 24 (one frame's and eight frames' problems)
    with rounds (1, 1, 2), and odd sizes (T across the warp's 32 lanes):
    the port's picks through greedy_assign_batch (greedy_scan_plain on the
    CPU) equal the jitted JAX scan's, bit for bit."""
    rng = np.random.default_rng(1000 * problems + n_targets
                                + HIER_KINDS.index(kind))
    case = hierarchy_case(rng, problems, n_bases, n_targets, kind)
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
