"""The port's cascade solver against the JAX package's.

The plain PyTorch ``solve_cascade_masked`` (the CPU route, and the
semantics oracle of kernels K1 and K2) walks the TPU kernel step for step,
so it must equal the TPU kernel run in interpret mode bit for bit, ties
included, on the shapes and degenerate masks of
tests/test_cascade_solve.py, on tie-heavy grids and on entries exactly at
the dummy price L/2; its objective must equal the native C++ LAPJV's.
Where the optimum is unique it also equals JAX ``solve_cascade_masked``
(three ``solve_masked`` calls), which at exact ties may pick another
optimum (tests/test_torch_cascade_ties.py). K1 itself is held to the
plain version on the card by tests/test_torch_cuda.py.
"""

from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from botsort_tpu.ops import assignment as jassign
from botsort_tpu.ops.assignment_pallas import cascade_solve_pallas
from botsort_tpu_torch.ops import assignment as tassign
from botsort_tpu_torch.ops import assignment_cuda
from botsort_tpu_torch.runtime import kernels
from tests.test_torch_jv import _chip_smoke

LIMITS = (0.8, 0.5, 0.7)


def random_instance(rng, n, d, empty_rows=False, empty_cols=False,
                    quantum=None):
    """The generator of tests/test_cascade_solve.py, as numpy arrays."""
    costs = [rng.uniform(0, 1, (n, d)).astype(np.float32) for _ in range(3)]
    if quantum:
        costs = [(np.round(c / quantum) * quantum).astype(np.float32)
                 for c in costs]
    pool = rng.uniform(0, 1, n) < 0.6
    tracked = pool & (rng.uniform(0, 1, n) < 0.7)
    unconf = (~pool) & (rng.uniform(0, 1, n) < 0.4)
    high = rng.uniform(0, 1, d) < 0.6
    low = (~high) & (rng.uniform(0, 1, d) < 0.5)
    if empty_rows:
        pool[:] = tracked[:] = unconf[:] = False
    if empty_cols:
        high[:] = low[:] = False
    return (*costs, pool, tracked, unconf, high, low)


def _assert_equal(got, want, what):
    for p in range(3):
        for k, name in enumerate(("col_for_row", "row_for_col")):
            np.testing.assert_array_equal(
                np.asarray(got[p][k]), np.asarray(want[p][k]),
                err_msg=f"{what}: pass {p + 1} {name}")


def _check_instance(inst, pallas=True):
    got = tassign.solve_cascade_masked(
        *[torch.from_numpy(a) for a in inst], LIMITS)
    want = jassign.solve_cascade_masked(*[jnp.asarray(a) for a in inst],
                                        LIMITS)
    _assert_equal(got, want, "JAX solve_cascade_masked")
    if pallas:
        kern = cascade_solve_pallas(*[jnp.asarray(a) for a in inst],
                                    LIMITS, interpret=True)
        _assert_equal(got, kern, "cascade_solve_pallas(interpret=True)")
    return got


@pytest.mark.parametrize("n,d", [(12, 9), (5, 14), (16, 16), (3, 2)])
def test_plain_cascade_equals_jax_and_tpu_kernel(n, d):
    rng = np.random.default_rng(n * 100 + d)
    for _ in range(4):
        _check_instance(random_instance(rng, n, d))


@pytest.mark.parametrize("empty_rows,empty_cols",
                         [(True, False), (False, True), (True, True)])
def test_plain_cascade_degenerate(empty_rows, empty_cols):
    rng = np.random.default_rng(7)
    got = _check_instance(random_instance(rng, 10, 8, empty_rows,
                                          empty_cols))
    if empty_rows:
        assert (got[0].col_for_row.numpy() == -1).all()


def test_plain_cascade_ties_equal_jax():
    """Costs on a 0.05 grid: many exactly equal reduced costs, where
    only the same argmin order reproduces JAX's matching."""
    rng = np.random.default_rng(13)
    for n, d in ((12, 9), (16, 16)):
        _check_instance(random_instance(rng, n, d, quantum=0.05))


def test_plain_cascade_full_width_equals_jax():
    """The main path's width: 64 track slots x 50 detection slots."""
    rng = np.random.default_rng(17)
    _check_instance(random_instance(rng, 64, 50), pallas=False)


def _objective(cost, cfr, rfc, limit):
    """Extended-problem cost: matched pairs plus L/2 per unmatched live
    endpoint."""
    matched = cfr >= 0
    half = np.float64(np.float32(limit)) / 2
    return (cost[matched, cfr[matched]].astype(np.float64).sum()
            + half * ((~matched).sum() + (rfc < 0).sum()))


def _assert_objective_equals_native(inst, got):
    """Each pass's objective against the port's native LAPJV
    (runtime/native.py) on the live sub-problem that pass solved, whose
    matchings equal the JAX package's native ones."""
    from botsort_tpu.runtime import native as jnative
    from botsort_tpu_torch.runtime import native

    d1, iou, d3, pool, tracked, unconf, high, low = inst
    cfrs = [np.asarray(r[0]) for r in got]
    rfcs = [np.asarray(r[1]) for r in got]
    rows = (pool, tracked & (cfrs[0] < 0), unconf)
    cols = (high, low, high & (rfcs[0] < 0))
    for p, cost in enumerate((d1, iou, d3)):
        ri, ci = np.flatnonzero(rows[p]), np.flatnonzero(cols[p])
        sub = cost[np.ix_(ri, ci)]
        cfr = cfrs[p][ri]
        rfc = rfcs[p][ci]
        # Re-index the port's matching into the live sub-problem.
        pos = {c: k for k, c in enumerate(ci)}
        cfr_sub = np.array([pos[c] if c >= 0 else -1 for c in cfr],
                           np.int64)
        ref_cfr, ref_rfc = native.lapjv_cost_limit(sub, LIMITS[p])
        for mine, theirs in zip((ref_cfr, ref_rfc),
                                jnative.lapjv_cost_limit(sub, LIMITS[p])):
            np.testing.assert_array_equal(mine, theirs)
        assert _objective(sub, cfr_sub, rfc, LIMITS[p]) == \
            pytest.approx(_objective(sub, ref_cfr, ref_rfc, LIMITS[p]),
                          abs=1e-5)


def test_plain_cascade_objective_equals_native_lapjv():
    """Objective against the port's native LAPJV (runtime/native.py), which
    returns the JAX package's native matchings on the same matrices."""
    rng = np.random.default_rng(19)
    for n, d in ((12, 9), (5, 14), (16, 16)):
        inst = random_instance(rng, n, d)
        got = tassign.solve_cascade_masked(
            *[torch.from_numpy(a) for a in inst], LIMITS)
        _assert_objective_equals_native(inst, got)


def _equals_tpu_kernel(inst):
    """The plain cascade against the TPU kernel in interpret mode, and its
    objective against the native LAPJV's."""
    got = tassign.solve_cascade_masked(
        *[torch.from_numpy(a) for a in inst], LIMITS)
    kern = cascade_solve_pallas(*[jnp.asarray(a) for a in inst], LIMITS,
                                interpret=True)
    _assert_equal(got, kern, "cascade_solve_pallas(interpret=True)")
    _assert_objective_equals_native(inst, got)


@pytest.mark.parametrize("n,d", [(12, 9), (16, 16), (64, 50)])
def test_plain_cascade_equals_tpu_kernel_on_fine_grid(n, d):
    """Costs on a 0.05 grid, up to the main path's 64 x 50."""
    rng = np.random.default_rng(n * 1000 + d)
    for _ in range(3):
        _equals_tpu_kernel(random_instance(rng, n, d, quantum=0.05))


HALF = [inst for label, inst in _chip_smoke().tie_instances()
        if label.startswith("half")]


@pytest.mark.parametrize("k", range(len(HALF)))
def test_plain_cascade_equals_tpu_kernel_at_half_limit(k):
    """chip_smoke.py's half-exact instances: every pass's costs are
    multiples of L/4, about one in six exactly L/2, where the escape fast
    path's inclusive >= decides (8 at 12 x 9, 8 at 64 x 50)."""
    _equals_tpu_kernel(HALF[k])


def test_half_limit_instances_hold_entries_at_half():
    for inst in HALF:
        for cost, limit in zip(inst[:3], LIMITS):
            assert (cost == np.float32(limit) / np.float32(2)).any()


def test_solve_masked_equals_jax():
    rng = np.random.default_rng(23)
    for _ in range(4):
        cost = rng.uniform(0, 1.2, (9, 11)).astype(np.float32)
        rv = rng.uniform(0, 1, 9) < 0.7
        cv = rng.uniform(0, 1, 11) < 0.7
        got = tassign.solve_masked(*[torch.from_numpy(a)
                                     for a in (cost, rv, cv)], 0.8)
        want = jassign.solve_masked(*[jnp.asarray(a)
                                      for a in (cost, rv, cv)], 0.8)
        np.testing.assert_array_equal(got.col_for_row.numpy(),
                                      np.asarray(want.col_for_row))
        np.testing.assert_array_equal(got.row_for_col.numpy(),
                                      np.asarray(want.row_for_col))


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(29)
    # The dispatcher reaches the kernel's wrapper only for CUDA tensors.
    with mock.patch.object(assignment_cuda, "cascade_solve_cuda",
                           side_effect=AssertionError("K1 reached")):
        _check_instance(random_instance(rng, 6, 5), pallas=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        costs = torch.zeros((1, 3, 6, 5))
        assignment_cuda.cascade_solve_cuda(
            costs, torch.zeros((1, 33), dtype=torch.int32),
            torch.ones(1), LIMITS)


def test_kernel_build_names_the_missing_compiler(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.load("cascade_lap")
