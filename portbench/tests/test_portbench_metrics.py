"""The per-layer readers and the trace arithmetic on synthetic profiler
events."""

import pytest
import torch

from portbench import counts, registry, trace
from portbench.trace import Event


def ev(name, dev, a, b):
    return Event(name, dev, float(a), float(b))


EVENTS = [
    # Host: an update span, launches and a synchronisation.
    ev("update", False, 0, 1000),
    ev("cudaGraphLaunch", False, 10, 20),
    ev("cudaMemcpyAsync", False, 30, 35),
    ev("cudaLaunchKernel", False, 40, 45),
    ev("cudaStreamSynchronize", False, 600, 990),
    # Device: overlapping kernels 100-300 and 250-400, then 500-700.
    ev("sm90_xmma_fprop_implicit_gemm_bf16", True, 100, 300),
    ev("void bn_act_kernel<__nv_bfloat16, 1>", True, 250, 400),
    ev("void cascade_lap_kernel<64, false>", True, 500, 600),
    ev("void bn_act_kernel<__nv_bfloat16, 2>", True, 600, 700),
]
WINDOW = (0.0, 1000.0)


def rec(**kw):
    base = {"events": EVENTS, "window": WINDOW, "profiled_updates": 2,
            "streams": 1, "timers": {"upload": 1.5, "assemble": 0.25},
            "graph_replays": 10, "updates": 8, "unprofiled_seconds": 2.0,
            "unprofiled_flops": 989e12, "norm_bytes_profiled": 0.0}
    base.update(kw)
    return base


def test_busy_union_merges_overlaps():
    assert trace.busy_intervals(EVENTS) == [(100.0, 400.0), (500.0, 700.0)]
    assert trace.busy_us(EVENTS) == 500.0


def test_idle_pct_is_the_uncovered_share_of_the_window():
    read = registry.metric_reader("device.idle_pct")
    assert read(rec()) == pytest.approx(50.0)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    gaps = trace.idle_gaps(EVENTS, WINDOW)
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(300e-6)]
    assert sorted(g[1] for g in gaps) == pytest.approx(
        [100e-6, 100e-6, 300e-6])


def test_device_ops_sum_by_name_longest_first():
    ops = trace.device_ops(EVENTS)
    assert ops[0] == ["sm90_xmma_fprop_implicit_gemm_bf16",
                      pytest.approx(200e-6)]
    assert len(ops) == 4


def test_host_calls_and_device_times_a_update():
    assert registry.metric_reader("graph.host_calls")(rec()) == 1.5
    # Convolution 200 us + the norms 150 + 100 us over 2 updates.
    assert registry.metric_reader("networks.device_ms")(rec()) == \
        pytest.approx(0.225)
    assert registry.metric_reader("tracker.solver_device_ms")(rec()) == \
        pytest.approx(0.05)
    assert registry.metric_reader("graph.step_runs")(rec()) == 1.25


def test_roofline_share_is_the_bytes_floor_over_the_kernel_time():
    # 250 us of K6; at 3.35 TB/s, 837.5 MB take exactly that long.
    read = registry.metric_reader("kernel.bn_act.roofline_pct")
    nbytes = counts.PEAK_HBM_BYTES_S * 250e-6
    assert read(rec(norm_bytes_profiled=nbytes)) == pytest.approx(100.0)
    assert read(rec(norm_bytes_profiled=nbytes / 4)) == pytest.approx(25.0)
    assert read(rec(norm_bytes_profiled=0.0)) is None


def test_mfu_is_useful_flops_a_second_over_the_bf16_peak():
    read = registry.metric_reader("mfu")
    assert read(rec()) == pytest.approx(50.0)
    assert read(rec(unprofiled_flops=0.0)) is None


def test_host_stage_readers_and_absent_readings():
    assert registry.metric_reader("host.upload_ms")(rec()) == 1.5
    assert registry.metric_reader("host.assemble_ms")(rec()) == 0.25
    assert registry.metric_reader("graph.step_runs")(
        rec(graph_replays=None)) is None
    empty = rec(events=[e for e in EVENTS if not e.device])
    assert registry.metric_reader("networks.device_ms")(empty) is None
    assert registry.metric_reader("tracker.solver_device_ms")(empty) is None


def test_useful_flops_and_run_norm_bytes_count_what_they_say():
    c = {"detector": {"flops": 10.0, "norm_bytes": 100.0},
         "body": {"flops": 2.0, "norm_bytes": 20.0},
         "face": {"flops": 1.0, "norm_bytes": 5.0}}
    assert counts.useful_flops(c, 3, 4, 5) == 30 + 8 + 5
    assert counts.run_norm_bytes(c, 2, 16, 8) == 200 + 320 + 40


def test_span_ranges_on_the_device_are_no_operation():
    from types import SimpleNamespace

    cuda = torch.autograd.DeviceType.CUDA
    kernel = SimpleNamespace(name="bn_act_kernel", device_type=cuda,
                             device_time=5.0, is_user_annotation=False)
    span = SimpleNamespace(name="graph.step", device_type=cuda,
                           device_time=900.0, is_user_annotation=True)
    named = SimpleNamespace(name="host.upload", device_type=cuda,
                            device_time=3.0)
    host = SimpleNamespace(name="cudaGraphLaunch",
                           device_type=torch.autograd.DeviceType.CPU,
                           device_time=0.0)
    assert trace.is_device_operation(kernel)
    assert not trace.is_device_operation(span)
    assert not trace.is_device_operation(named)
    assert not trace.is_device_operation(host)
