"""A whole run of a miniature cell on the CPU, the card check skipped,
with the timed path broken underneath: ``correct`` must come out false
for each fault the cells can have, and true without one. (The cells run
on one card, so there is no exchange between chips to leave out.) The
limits are the miniature float32 cell's: sound runs read at rounding."""

import pytest

from portbench import control, faults, registry, run
from portbench.tests import minicell

# The loaded cell's committed limits.
LIMITS = registry.limits("mot17_256.loaded.1stream")["limits"]
FAULTS = faults.FAULTS


@pytest.mark.parametrize("streams", [1, 3])
def test_sound_run_is_correct(tmp_path, monkeypatch, streams):
    args = minicell.make(tmp_path, monkeypatch, limits=LIMITS,
                         streams=streams)
    out = run.run(args, device_kind="cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 2
    assert 0 in out["info"]["samples"]
    assert list(out["checks"])[-1] == "track_gap"


@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault, streams):
    args = minicell.make(tmp_path, monkeypatch, limits=LIMITS,
                         streams=streams)
    with FAULTS[fault]():
        out = run.run(args, device_kind="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["mot17_256.loaded.1stream",
                                  "mot20_384.moderate16.8stream"])
def test_the_control_fails_the_cells_limits_at_miniature_size(
        tmp_path, monkeypatch, cell):
    """The reference in the program's place, networks in float8, on the
    miniature cell fails the committed limits of the cell; in float32 it
    passes them."""
    limits = registry.limits(cell)["limits"]
    minicell.make(tmp_path, monkeypatch, limits=limits)
    fp8 = control.control_readings("mini.cell", 11, 6, device="cpu")
    f32 = control.control_readings("mini.cell", 11, 6, device="cpu",
                                   precision="float32")
    _, ok8 = run_checks(fp8["readings"], limits)
    _, ok32 = run_checks(f32["readings"], limits)
    assert not ok8, fp8["readings"]
    assert fp8["readings"]["body_cos_gap"] > limits["body_cos_gap"]
    assert ok32, f32["readings"]


def run_checks(readings, limits):
    from portbench import judge

    return judge.checks(readings, limits, 0)


@pytest.mark.parametrize("fault, number", [
    ("no_suppression", "nms_overlap"), ("over_suppression", "nms_uncovered")])
def test_a_broken_nms_fails_its_own_number(tmp_path, monkeypatch, fault,
                                           number):
    args = minicell.make(tmp_path, monkeypatch, limits=LIMITS)
    with FAULTS[fault]():
        out = run.run(args, device_kind="cpu")
    check = out["checks"][number]
    assert check["value"] > check["limit"], out["checks"]
