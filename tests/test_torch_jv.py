"""K3's plain version and the port's ``solve_masked`` against the JAX
package's.

``jv_solve_plain`` (the CPU route of ``solve_masked``, and the plain
version kernel K3 is held to on the card by tests/test_torch_cuda.py)
must give exactly the column owners of the TPU kernel ``_jv_kernel`` run
in interpret mode (``jv_solve_pallas``) and of the XLA solver
``_jv_masked``, on the fuzz cases of tests/test_assignment_pallas.py plus
an all-parked and a tie-heavy case. The port's ``solve_masked`` must
equal JAX ``solve_masked`` exactly on random, degenerate and tie-heavy
instances. Integers throughout: every comparison is exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from botsort_tpu.ops import assignment as jassign
from botsort_tpu.ops.assignment_pallas import jv_solve_pallas
from botsort_tpu_torch.ops import assignment as tassign
from botsort_tpu_torch.ops import assignment_cuda
from botsort_tpu_torch.runtime import kernels


def _parked_problem(ext, parked, parked_col):
    """The JAX kernel's (ext, parked, parked_col) as the port's (ext, p0,
    live_order, n_live), each with a leading batch of one."""
    s = ext.shape[0]
    rows = np.arange(s)
    p0 = np.full(s + 1, -1, np.int32)
    p0[np.where(parked, parked_col, s)] = rows
    live_order = np.sort(np.where(parked, s, rows)).astype(np.int32)
    n_live = np.int32((~parked).sum())
    return [torch.from_numpy(np.asarray(a))[None]
            for a in (ext, p0[:s], live_order, n_live)]


def _fuzz_case(kind, seed):
    rng = np.random.default_rng(seed)
    s = 24
    ext = rng.random((s, s)).astype(np.float32)
    if kind == "ties":
        ext = (np.round(ext / 0.05) * 0.05).astype(np.float32)
    n_live = {"fuzz": int(rng.integers(3, 10)), "parked": 0,
              "ties": 14}[kind]
    parked = np.arange(s) >= n_live
    return ext, parked, np.arange(s, dtype=np.int32)


@pytest.mark.parametrize("kind,seed", [
    ("fuzz", 0), ("fuzz", 1), ("fuzz", 2), ("parked", 3), ("ties", 4)])
def test_jv_plain_equals_tpu_kernel_and_xla_solver(kind, seed):
    ext, parked, pcol = _fuzz_case(kind, seed)
    got = tassign.jv_solve_plain(*_parked_problem(ext, parked, pcol),
                                 max_iters=512)[0].numpy()
    kern = np.asarray(jv_solve_pallas(jnp.asarray(ext), jnp.asarray(parked),
                                      jnp.asarray(pcol), max_iters=512,
                                      interpret=True))
    xla = np.asarray(jassign._jv_masked(jnp.asarray(ext),
                                        jnp.asarray(parked),
                                        jnp.asarray(pcol), 512))
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, xla)
    assert sorted(got.tolist()) == list(range(ext.shape[0]))


def _masked_instance(rng, n, d, kind):
    cost = rng.uniform(0, 1.2, (n, d)).astype(np.float32)
    if kind == "ties":
        cost = (np.round(cost / 0.05) * 0.05).astype(np.float32)
    rv = rng.uniform(0, 1, n) < 0.7
    cv = rng.uniform(0, 1, d) < 0.7
    if kind == "no_rows":
        rv[:] = False
    if kind == "no_cols":
        cv[:] = False
    if kind == "infeasible":
        cost = cost + 1.0
    return cost, rv, cv


@pytest.mark.parametrize("kind", ["random", "ties", "no_rows", "no_cols",
                                  "infeasible"])
def test_solve_masked_equals_jax(kind):
    rng = np.random.default_rng(len(kind))
    for n, d in ((9, 11), (16, 16), (64, 50)):
        inst = _masked_instance(rng, n, d, kind)
        got = tassign.solve_masked(*[torch.from_numpy(a) for a in inst],
                                   0.8)
        want = jassign.solve_masked(*[jnp.asarray(a) for a in inst], 0.8)
        np.testing.assert_array_equal(got.col_for_row.numpy(),
                                      np.asarray(want.col_for_row))
        np.testing.assert_array_equal(got.row_for_col.numpy(),
                                      np.asarray(want.row_for_col))


def test_masked_problem_matches_jax_extended_matrix():
    """The square problem K3 is given: the JAX package's extended matrix
    and designated parking."""
    rng = np.random.default_rng(5)
    cost, rv, cv = _masked_instance(rng, 7, 5, "random")
    ext, p0, order, n_live, rv_f, cv_f = tassign.masked_problem(
        *[torch.from_numpy(a) for a in (cost, rv, cv)], 0.8)
    # JAX's own construction, from _solve_masked_nonempty.
    feas = rv[:, None] & cv[None, :] & (cost <= np.float32(0.8))
    rvj, cvj = rv & feas.any(1), cv & feas.any(0)
    np.testing.assert_array_equal(rv_f.numpy(), rvj)
    np.testing.assert_array_equal(cv_f.numpy(), cvj)
    big = np.abs(np.where(rvj[:, None] & cvj[None, :], cost, 0)).max() + \
        np.float32(0.8) + 1
    half = np.float32(0.4)
    want = np.zeros((12, 12), np.float32)
    want[:7, :5] = np.where(rvj[:, None] & cvj[None, :], cost, big)
    want[:7, 5:] = np.where(rvj[:, None], half, 0)
    want[7:, :5] = np.where(cvj[None, :], half, 0)
    np.testing.assert_array_equal(ext.numpy(), want)
    parked = np.concatenate([~rvj, ~cvj])
    pcol = np.concatenate([5 + np.arange(7), np.arange(5)]).astype(np.int32)
    for g, w in zip((p0, order, n_live),
                    _parked_problem(want, parked, pcol)[1:]):
        np.testing.assert_array_equal(g.numpy(), w[0].numpy())


def test_cpu_tensors_take_the_plain_jv_solver():
    before = assignment_cuda.jv_solve_cuda.launches
    rng = np.random.default_rng(6)
    inst = _masked_instance(rng, 6, 5, "random")
    tassign.solve_masked(*[torch.from_numpy(a) for a in inst], 0.8)
    assert assignment_cuda.jv_solve_cuda.launches == before
    ext, parked, pcol = _fuzz_case("fuzz", 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        assignment_cuda.jv_solve_cuda(*_parked_problem(ext, parked, pcol))


def test_solvers_refuse_other_devices():
    """Only CUDA (the kernels) and CPU (the plain versions) have solvers."""
    meta = torch.device("meta")
    cost = torch.zeros((3, 2), device=meta)
    rows = torch.ones(3, dtype=torch.bool, device=meta)
    cols = torch.ones(2, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="no assignment solver"):
        tassign.solve_masked(cost, rows, cols, 0.8)
    with pytest.raises(ValueError, match="no cascade solver"):
        tassign.solve_cascade_masked(cost, cost, cost, rows, rows, rows,
                                     cols, cols, (0.8, 0.5, 0.7))


def test_library_name_follows_shared_headers(monkeypatch, tmp_path):
    """K1 and K3 share lap_common.cuh: an edited header must rebuild
    both libraries, so the header is part of each library's hash."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kernels.CSRC_DIR.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    before = {n: kernels.library_path(n) for n in ("cascade_lap", "jv_lap")}
    header = csrc / "lap_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert kernels.library_path(name) != path, name


def _pops(fn, *args):
    before = tassign.jv_solve_plain.pops
    fn(*args)
    return tassign.jv_solve_plain.pops - before


def test_pop_count_of_a_diagonal_problem_is_its_live_rows():
    """Zero on the diagonal, one elsewhere, each live row's own column
    free: every augmentation ends at its first pop."""
    s, n_live = 12, 7
    ext = np.ones((s, s), np.float32)
    np.fill_diagonal(ext, 0.0)
    parked = np.arange(s) >= n_live
    args = _parked_problem(ext, parked, np.arange(s, dtype=np.int32))
    assert _pops(tassign.jv_solve_plain, *args) == n_live


def _three_solves(d1, iou, d3, pool, tracked, unconf, high, low):
    """The cascade as three chained ``solve_masked`` calls."""
    limits = (0.8, 0.5, 0.7)
    res1 = tassign.solve_masked(d1, pool, high, limits[0])
    tassign.solve_masked(iou, tracked & (res1.col_for_row < 0), low,
                         limits[1])
    tassign.solve_masked(d3, unconf, high & (res1.row_for_col < 0),
                         limits[2])


def test_cascade_pops_are_its_three_solves():
    """The cascade pops only for the rows its column reduction and resolve
    leave: over these instances fewer pops than three chained solves of
    the same problems, which augment every live row from zero duals. (Not
    a bound instance by instance: the reduction's duals change the
    Dijkstra trees, and on rare instances one more path is longer.)"""
    rng = np.random.default_rng(3)
    n, d = 12, 9
    limits = (0.8, 0.5, 0.7)
    totals = [0, 0]
    for _ in range(6):
        inst = [torch.from_numpy(a) for a in (
            *(rng.uniform(0, 1, (n, d)).astype(np.float32)
              for _ in range(3)),
            rng.uniform(0, 1, n) < 0.7, rng.uniform(0, 1, n) < 0.5,
            rng.uniform(0, 1, n) < 0.3, rng.uniform(0, 1, d) < 0.7,
            rng.uniform(0, 1, d) < 0.4)]
        totals[0] += _pops(tassign.solve_cascade_masked, *inst, limits)
        totals[1] += _pops(_three_solves, *inst)
    assert 0 < totals[0] < totals[1]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_coherent_cascade_costs_no_pops():
    """chip_smoke.py's coherent scenes at the main path's 64 x 50 (each
    detection within 0.2 of exactly one live track, every other cost
    >= 0.6): the column reduction and the resolve match every row, so the
    cascade makes no Dijkstra pop, where three chained solves pop for
    every live row."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    for _ in range(3):
        inst = [torch.from_numpy(a) for a in cs.coherent_instance(
            rng, cs.N_TRACKS, cs.N_DETS)]
        assert _pops(tassign.solve_cascade_masked, *inst, cs.LIMITS) == 0
        assert _pops(_three_solves, *inst) > cs.N_DETS


def test_pop_counts_of_chip_smoke_timing_inputs_are_stable():
    """The pops per solve that chip_smoke.py prints beside K1's and K3's
    times: its own timing inputs (the first of each), counted twice."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    k1 = [a for n, d, kw, a in cs.k1_instances(torch, tassign, cpu)
          if cs.is_k1_timing(n, d, kw)][:8]
    k3 = [a for a in cs.k3_problems(torch, tassign, cpu)
          if a[0].shape[1] == cs.N_TRACKS + cs.N_DETS][:8]
    for plain, inputs in ((tassign.cascade_solve_plain, k1),
                          (tassign.jv_solve_plain, k3)):
        first = [_pops(plain, *args) for args in inputs]
        assert first == [_pops(plain, *args) for args in inputs]
        assert len(first) == 8 and min(first) > 0
