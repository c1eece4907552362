"""Kernel K1 on the card, against its plain PyTorch version.

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
        pytest.skip("needs a CUDA card: K1 is CUDA C++ with no CPU mode")
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
