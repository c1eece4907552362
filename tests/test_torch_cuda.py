"""Kernels K1, K2 and K3 on the card, against their plain PyTorch versions.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card
and skips without one. The file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from botsort_tpu_torch.ops import assignment, assignment_cuda

pytestmark = pytest.mark.cuda

LIMITS = (0.8, 0.5, 0.7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _instance(rng, n, d, p_row=0.6, p_col=0.6, quantum=None):
    costs = [rng.uniform(0, 1, (n, d)).astype(np.float32) for _ in range(3)]
    if quantum:
        costs = [(np.round(c / quantum) * quantum).astype(np.float32)
                 for c in costs]
    pool = rng.uniform(0, 1, n) < p_row
    tracked = pool & (rng.uniform(0, 1, n) < 0.7)
    unconf = (~pool) & (rng.uniform(0, 1, n) < 0.4 * p_row / 0.6)
    high = rng.uniform(0, 1, d) < p_col
    low = (~high) & (rng.uniform(0, 1, d) < 0.5)
    return (*costs, pool, tracked, unconf, high, low)


def _kernel_and_plain(inst, dev):
    tensors = [torch.from_numpy(a).to(dev) for a in inst]
    costs, masks, big = assignment.prepare_cascade(*tensors, LIMITS)
    args = (costs[None], masks[None], big[None], LIMITS)
    got = assignment_cuda.cascade_solve_cuda(*args)
    want = assignment.cascade_solve_plain(*args)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("n,d,quantum", [
    (64, 50, None), (64, 50, 0.05), (12, 9, None), (5, 14, None),
    (16, 16, 0.05), (3, 2, None), (1, 1, None)])
def test_k1_equals_plain(dev, n, d, quantum):
    rng = np.random.default_rng(n * 1000 + d)
    for _ in range(3):
        got, want = _kernel_and_plain(
            _instance(rng, n, d, quantum=quantum), dev)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_k1_strided_lanes_equal_plain(dev):
    """N + D > 1024: more columns than threads, each thread strides."""
    rng = np.random.default_rng(3)
    got, want = _kernel_and_plain(
        _instance(rng, 700, 400, p_row=0.05, p_col=0.1), dev)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dispatcher_launches_k1_for_cuda_tensors(dev):
    inst = _instance(np.random.default_rng(4), 64, 50)
    before = assignment_cuda.cascade_solve_cuda.launches
    got = assignment.solve_cascade_masked(
        *[torch.from_numpy(a).to(dev) for a in inst], LIMITS)
    assert assignment_cuda.cascade_solve_cuda.launches == before + 1
    want = assignment.solve_cascade_masked(
        *[torch.from_numpy(a) for a in inst], LIMITS)
    for g, w in zip(got, want):
        assert torch.equal(g.col_for_row.cpu(), w.col_for_row)
        assert torch.equal(g.row_for_col.cpu(), w.row_for_col)


def test_wrapper_rejects_malformed_inputs(dev):
    inst = _instance(np.random.default_rng(5), 6, 5)
    costs, masks, big = assignment.prepare_cascade(
        *[torch.from_numpy(a).to(dev) for a in inst], LIMITS)
    good = (costs[None], masks[None], big[None])
    bad = [
        (good[0].double(), good[1], good[2]),
        (good[0], good[1].long(), good[2]),
        (good[0], good[1][:, :-1], good[2]),
        (good[0].transpose(2, 3).contiguous().transpose(2, 3), good[1],
         good[2]),
        (good[0], good[1].cpu(), good[2]),
    ]
    before = assignment_cuda.cascade_solve_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            assignment_cuda.cascade_solve_cuda(*args, LIMITS)
    assert assignment_cuda.cascade_solve_cuda.launches == before


def test_k2_batch_equals_plain_and_k1(dev):
    """Eight streams at the main path's shape in one launch (K2): equal to
    the plain version and to eight one-stream launches (K1). One stream
    has no live rows."""
    rng = np.random.default_rng(6)
    insts = [_instance(rng, 64, 50) for _ in range(8)]
    insts[3] = _instance(rng, 64, 50, p_row=0.0)
    batched = [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*insts)]
    costs, masks, big = assignment.prepare_cascade(*batched, LIMITS)
    before = (assignment_cuda.cascade_solve_cuda.launches,
              assignment_cuda.cascade_solve_cuda.batched_launches)
    got = assignment_cuda.cascade_solve_cuda(costs, masks, big, LIMITS)
    assert assignment_cuda.cascade_solve_cuda.batched_launches == \
        before[1] + 1
    want = assignment.cascade_solve_plain(costs, masks, big, LIMITS)
    singles = [assignment_cuda.cascade_solve_cuda(
        costs[b:b + 1], masks[b:b + 1], big[b:b + 1], LIMITS)
        for b in range(8)]
    assert assignment_cuda.cascade_solve_cuda.launches == before[0] + 8
    torch.cuda.synchronize()
    for k in range(2):
        assert torch.equal(got[k], want[k])
        assert torch.equal(got[k], torch.cat([s[k] for s in singles]))


def _jv_problem(rng, s, n_live, quantum=None):
    ext = rng.uniform(0, 1, (s, s)).astype(np.float32)
    if quantum:
        ext = (np.round(ext / quantum) * quantum).astype(np.float32)
    p0 = np.where(np.arange(s) < n_live, -1, np.arange(s)).astype(np.int32)
    live_order = np.where(np.arange(s) < n_live, np.arange(s),
                          s).astype(np.int32)
    return ext, p0, live_order, np.int32(n_live)


@pytest.mark.parametrize("s,n_live,quantum", [
    (24, 7, None), (24, 0, None), (114, 60, None), (114, 114, 0.05),
    (5, 5, None), (1, 1, None), (1100, 40, None)])
def test_k3_equals_plain(dev, s, n_live, quantum):
    """Square solves, including S > 1024 (more columns than threads)."""
    rng = np.random.default_rng(s + n_live)
    probs = [_jv_problem(rng, s, n_live, quantum) for _ in range(3)]
    args = [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*probs)]
    got = assignment_cuda.jv_solve_cuda(*args)
    want = assignment.jv_solve_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sorted(got[0].tolist()) == list(range(s))


def test_solve_masked_launches_k3_for_cuda_tensors(dev):
    rng = np.random.default_rng(8)
    cost = rng.uniform(0, 1.2, (64, 50)).astype(np.float32)
    rv, cv = rng.uniform(0, 1, 64) < 0.7, rng.uniform(0, 1, 50) < 0.7
    before = assignment_cuda.jv_solve_cuda.launches
    got = assignment.solve_masked(
        *[torch.from_numpy(a).to(dev) for a in (cost, rv, cv)], 0.8)
    assert assignment_cuda.jv_solve_cuda.launches == before + 1
    want = assignment.solve_masked(
        *[torch.from_numpy(a) for a in (cost, rv, cv)], 0.8)
    assert torch.equal(got.col_for_row.cpu(), want.col_for_row)
    assert torch.equal(got.row_for_col.cpu(), want.row_for_col)


def test_jv_wrapper_rejects_malformed_inputs(dev):
    rng = np.random.default_rng(9)
    good = [torch.from_numpy(np.stack(x)).to(dev)
            for x in zip(_jv_problem(rng, 12, 5))]
    ext, p0, order, n_live = good
    bad = [
        (ext.double(), p0, order, n_live),
        (ext[:, :, :-1], p0, order, n_live),
        (ext, p0.long(), order, n_live),
        (ext, p0, order[:, :-1], n_live),
        (ext, p0, order, n_live.cpu()),
        (ext.transpose(1, 2), p0, order, n_live),
    ]
    before = assignment_cuda.jv_solve_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            assignment_cuda.jv_solve_cuda(*args)
    assert assignment_cuda.jv_solve_cuda.launches == before
