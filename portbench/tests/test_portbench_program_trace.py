"""The program trace's record and its readers on a synthetic trace: two
window updates (the second with an overflow re-run), an unrecorded first
profiled update and one profiled update, whose spans are moved onto the
profiler's clock."""

import pytest

from portbench import program_trace, registry
from portbench.trace import Event

MS = 1_000_000  # ns
STAGES = [["detect", 1.0], ["nms", 0.5], ["hierarchy", 0.25],
          ["embed", 2.0], ["track", 0.5], ["pack", 0.25]]


def spans_of(u, rerun=False):
    """One update's spans, 10 ms apart, in ns."""
    b = u * 10 * MS
    out = [["upload", b + MS // 10, b + MS, "update", u],
           ["graph.launch", b + 3 * MS // 2, b + 8 * MS // 5, "device_step",
            u],
           ["device_step", b + MS, b + 2 * MS, "update", u],
           ["readback.wait", b + 21 * MS // 10, b + 5 * MS, "readback", u]]
    if rerun:
        out += [["graph.launch", b + 52 * MS // 10, b + 54 * MS // 10,
                 "device_step", u],
                ["device_step", b + 51 * MS // 10, b + 55 * MS // 10,
                 "readback", u]]
    return out + [["readback", b + 2 * MS, b + 6 * MS, "update", u],
                  ["assemble", b + 6 * MS, b + 7 * MS, "update", u],
                  ["update", b, b + 8 * MS, None, u]]


EXPORT = {"spans": spans_of(0) + spans_of(1, rerun=True) + spans_of(2)
          + spans_of(3),
          "stages": [[u, STAGES] for u in (0, 1, 1, 2, 3)]}
# The profiler's clock: update 3's record_function starts at 500 us, so
# the offset is 500 - 30,000 us; the device ran 3,000-7,000 us of the
# 10,000 us window.
EVENTS = [Event("update", False, 500.0, 8600.0),
          Event("cudaGraphLaunch", False, 2001.0, 2060.0),
          Event("some_kernel", True, 3000.0, 7000.0)]
WINDOW = (0.0, 10000.0)


def rec(**kw):
    base = {"program_trace": program_trace.record(EXPORT, 2, EVENTS),
            "events": EVENTS, "window": WINDOW, "unprofiled_seconds": 0.02,
            "updates": 2}
    base.update(kw)
    return base


def read(name, r=None):
    return registry.metric_reader(name)(rec() if r is None else r)


def test_record_splits_the_window_and_maps_the_profiled_spans():
    r = rec()["program_trace"]
    assert {s[4] for s in r["window"]["spans"]} == {0, 1}
    assert [u for u, _ in r["window"]["stages"]] == [0, 1, 1]
    assert r["offset_us"] == pytest.approx(500.0 - 30000.0)
    prof = r["profiled"]["spans"]
    assert {s[4] for s in prof} == {2, 3}
    root3 = [s for s in prof if s[0] == "update" and s[4] == 3][0]
    assert root3[1:3] == pytest.approx([500.0, 8500.0])


def test_stage_readers_sum_the_step_runs_a_update():
    # Update 1 ran twice (the re-run): (1 + 2) runs over 2 updates.
    want = {"detect": 1.5, "nms": 0.75, "hierarchy": 0.375, "embed": 3.0,
            "track": 1.125}
    for stage, ms in want.items():
        assert read(f"step.{stage}_device_ms") == pytest.approx(ms), stage


def test_step_idle_is_the_window_outside_the_step_runs():
    # Three runs of 4.5 ms in a 20 ms window.
    assert read("device.step_idle_pct") == pytest.approx(32.5)


def test_host_span_readers():
    assert read("graph.launch_ms") == pytest.approx((0.1 + 0.1 + 0.2) / 2)
    assert read("host.wait_ms") == pytest.approx(2.9)
    # readback less its wait, and less the re-run in update 1.
    assert read("host.readback_ms") == pytest.approx((1.1 + 0.7) / 2)


def test_unattributed_idle_share():
    # Idle 0-3,000 and 7,000-10,000 us; the spans below the roots cover
    # 600-7,500 us (update 3) once mapped: 2,900 of 6,000 us are named.
    assert read("device.idle_unattributed_pct") == pytest.approx(
        100.0 * (1 - 2900 / 6000))
    assert program_trace.launch_outside_us(rec()) == 0.0
    late = EVENTS + [Event("cudaGraphLaunch", False, 2090.0, 2130.0)]
    assert program_trace.launch_outside_us(rec(events=late)) == \
        pytest.approx(30.0)


NEW = ("step.detect_device_ms", "step.nms_device_ms",
       "step.hierarchy_device_ms", "step.embed_device_ms",
       "step.track_device_ms", "device.step_idle_pct", "graph.launch_ms",
       "host.wait_ms", "host.readback_ms", "device.idle_unattributed_pct")


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_a_program_trace(name):
    """A program that does not trace (the record has no key, or its
    export is empty) reads None, and nothing raises."""
    assert read(name, rec(program_trace=None)) is None
    empty = program_trace.record({"spans": [], "stages": []}, 2, EVENTS)
    assert read(name, rec(program_trace=empty)) is None


def test_device_readers_find_nothing_off_the_card():
    """On the CPU a step run's stages have no device time: the host
    readers read, the device ones do not."""
    cpu = {"spans": EXPORT["spans"],
           "stages": [[u, [[n, None] for n, _ in STAGES]]
                      for u, _ in EXPORT["stages"]]}
    r = rec(program_trace=program_trace.record(cpu, 2, EVENTS))
    assert read("step.detect_device_ms", r) is None
    assert read("device.step_idle_pct", r) is None
    assert read("host.wait_ms", r) == pytest.approx(2.9)
