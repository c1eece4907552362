"""The port's cascade against the TPU cascade kernel at exact ties.

The plain PyTorch cascade (``solve_cascade_masked`` on CPU tensors, the
version kernels K1 and K2 are held to on the card) walks the TPU kernel
``_cascade_kernel`` step for step: column reduction, leftover pairing,
the post-reduction resolve, then Dijkstra pops for the rows left. So its
matchings must equal ``cascade_solve_pallas(interpret=True)``'s bit for
bit, ties included, where the JAX package's CPU route (three chained
``solve_masked`` calls) may pick another optimum of the same cost. The
instances are chip_smoke.py's ``tie_instances``: the 60 on a 0.1 grid
(default_rng(0), N and D in 2..11), which chip_smoke also holds K1 to on
the card. Every pass's objective must equal the native LAPJV's
(runtime/native.py) too. Matchings are integers, compared exactly;
objectives are float64 sums, within 1e-5.

Each instance shape compiles the interpret-mode kernel once (about 3-4 s
here); the 60 instances have 43 shapes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from botsort_tpu.ops import assignment as jassign
from botsort_tpu.ops.assignment_pallas import cascade_solve_pallas
from botsort_tpu_torch.ops import assignment as tassign
from tests.test_torch_assignment import (LIMITS, _assert_equal,
                                         _assert_objective_equals_native)
from tests.test_torch_jv import _chip_smoke

GRID = [inst for label, inst in _chip_smoke().tie_instances()
        if label.startswith("grid")]
# The instances on which three chained solves pick another optimum than
# the TPU kernel (instance 40, N = 10, D = 2: the kernel matches row 6 to
# column 0 and leaves row 8 unmatched, the composition the reverse).
COMPOSITION_DIFFERS = (9, 14, 19, 30, 40)


def _tpu_kernel(inst):
    return cascade_solve_pallas(*[jnp.asarray(a) for a in inst], LIMITS,
                                interpret=True)


@pytest.mark.parametrize("k", range(len(GRID)))
def test_plain_cascade_equals_tpu_kernel_on_grid_ties(k):
    inst = GRID[k]
    got = tassign.solve_cascade_masked(*[torch.from_numpy(a) for a in inst],
                                       LIMITS)
    _assert_equal(got, _tpu_kernel(inst), f"instance {k}")
    _assert_objective_equals_native(inst, got)


def test_three_solves_pick_other_optima_at_ties():
    """What the tests above guard: on these instances the JAX package's
    CPU route differs from the TPU kernel (so a port of the composition
    would too), at the same objective."""
    for k in COMPOSITION_DIFFERS:
        inst = GRID[k]
        kern = _tpu_kernel(inst)
        comp = jassign.solve_cascade_masked(*[jnp.asarray(a) for a in inst],
                                            LIMITS)
        assert any(not np.array_equal(np.asarray(kern[p][0]),
                                      np.asarray(comp[p].col_for_row))
                   for p in range(3)), k
        _assert_objective_equals_native(inst, kern)
    cfr = np.asarray(_tpu_kernel(GRID[40])[0][0])
    assert (cfr[6], cfr[8]) == (0, -1)


def test_pad_lanes_never_enter_the_pops():
    """The TPU kernel pads S = N + D lanes to 128; pad row r owns pad column
    r at 0 and every other entry a pad lane touches is 1e9. Before the pops
    every minimum, argmin and rank is masked by a live mask, which is 0 on
    pad lanes; the pops are the only step that sees them unmasked. Pop
    every active row of passes 1 and 3 of the tie instances with and
    without the pad lanes: the same owners, duals and pop counts, and the
    pad lanes' duals untouched, so no pad column ever won an argmin."""
    checked = 0
    for inst in GRID[:20]:
        tensors = [torch.from_numpy(a) for a in inst]
        costs, masks, big = tassign.prepare_cascade(*tensors, LIMITS)
        n, d = costs.shape[-2:]
        m = masks.bool()
        # Pass 1 and pass 3 take their masks as they come (pass 3's
        # columns without pass 1's result: still a valid problem).
        for p, rv, cv in ((0, m[:n], m[3 * n:3 * n + d]),
                          (2, m[2 * n:3 * n], m[3 * n + d:3 * n + 2 * d])):
            half = tassign.half_limit(LIMITS[p])
            pp, q, u, v = tassign._reduce_and_resolve(costs[p], rv, cv, half)
            e = tassign._ext_matrix(costs[p], rv, cv, half, big)
            s, sp = n + d, 128
            e_pad = torch.full((sp, sp), 1e9)
            e_pad[:s, :s] = e
            e_pad[s:, s:].fill_diagonal_(0.0)
            active = torch.nonzero(torch.cat([rv, cv]) & (q < 0)).flatten()
            runs = []
            for ext, lanes in ((e, s), (e_pad, sp)):
                owner = pp.tolist() + list(range(s, lanes))
                uu = torch.cat([u, torch.zeros(lanes - s)])
                vv = torch.cat([v, torch.zeros(lanes - s)])
                before = tassign.jv_solve_plain.pops
                for i in active.tolist():
                    uu, vv = tassign._augment(ext, i, owner, uu, vv,
                                              tassign.MAX_ITERS)
                runs.append((owner, uu, vv,
                             tassign.jv_solve_plain.pops - before))
            (o1, u1, v1, n1), (o2, u2, v2, n2) = runs
            assert o2 == o1 + list(range(s, sp))
            assert torch.equal(u2[:s], u1) and torch.equal(v2[:s], v1)
            assert not u2[s:].any() and not v2[s:].any()
            assert n1 == n2
            checked += int(active.numel() > 0)
    assert checked > 10
