"""Reads a ``torch.profiler`` run of the window's last updates.

``profile(fn, updates)`` runs one call of ``fn`` unrecorded by the counts
(a profiler run can lose its first milliseconds of events), synchronises,
then runs ``updates`` calls and synchronises again; the events between the
two synchronisations are the traced window. Events become plain tuples
(name, on_device, start_us, end_us), which the per-layer readers in
metrics/ take.

Also here: the union of device-busy intervals, the breakdown of the
longest device operations and idle gaps, and the host launch calls
(a copy of the port's chip smoke test's list).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

HOST_LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
    "cudaMemsetAsync"))
SYNCS = frozenset(("cudaDeviceSynchronize",))
# The record_function spans the benchmark puts around the facade's layers
# in a profiled run (portbench/program.py::spans). The profiler also
# reports each as a device-side range over the work it enqueued: that
# range is no operation and is left out of the device events.
SPANS = ("update", "host.upload", "graph.step", "host.readback",
         "host.assemble")


class Event(NamedTuple):
    name: str
    device: bool
    start: float   # microseconds, the profiler's clock
    end: float


def _device_us(e) -> float:
    us = getattr(e, "device_time", None)
    return e.cuda_time if us is None else us


def is_device_operation(e) -> bool:
    """Whether a profiler event is work the device ran: a device event
    with time, and not the device-side range of a span."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0.0 and e.name not in SPANS
            and not getattr(e, "is_user_annotation", False))


def profile(fn: Callable[[], None], updates: int):
    """(events in the traced window, (window start, window end) in us)."""
    from torch.profiler import ProfilerActivity, profile as tp

    torch.cuda.synchronize()
    with tp(activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        for _ in range(updates):
            fn()
        torch.cuda.synchronize()
    events = []
    syncs = []
    for e in prof.events():
        on_dev = e.device_type == torch.autograd.DeviceType.CUDA
        start, end = float(e.time_range.start), float(e.time_range.end)
        if on_dev and not is_device_operation(e):
            continue
        events.append(Event(e.name, on_dev, start, end))
        if not on_dev and e.name in SYNCS:
            syncs.append(end)
    syncs.sort()
    if len(syncs) < 2:
        raise RuntimeError("torch.profiler recorded no device "
                           "synchronisations to bound the window")
    lo, hi = syncs[0], syncs[-1]
    return [e for e in events if e.start >= lo and e.end <= hi], (lo, hi)


def busy_intervals(events: Sequence[Event]) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, merged, in order."""
    spans = sorted((e.start, e.end) for e in events if e.device)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(events: Sequence[Event]) -> float:
    return sum(b - a for a, b in busy_intervals(events))


def device_ops(events: Sequence[Event], top: int = 10):
    """[[name, seconds]] of the device operations that took most time in
    all, summed by name."""
    total: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.device:
            total[e.name] += e.end - e.start
    rows = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, us / 1e6] for name, us in rows]


def idle_gaps(events: Sequence[Event], window: Tuple[float, float],
              top: int = 10):
    """[[what the host was doing, seconds]] of the longest stretches in
    which the device ran nothing: each gap is named by the innermost host
    event (the latest to start) that covers its midpoint."""
    busy = busy_intervals(events)
    edges = [window[0]] + [x for span in busy for x in span] + [window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted((e for e in events if not e.device),
                  key=lambda e: e.start)
    rows = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        name = "no host event"
        mid = (a + b) / 2
        for e in host:
            if e.start > mid:
                break
            if e.end >= mid:
                name = e.name
        rows.append([name, (b - a) / 1e6])
    return rows


def host_calls(events: Sequence[Event]) -> int:
    return sum(1 for e in events if not e.device
               and e.name in HOST_LAUNCH_CALLS)


def device_us_where(events: Sequence[Event], keep: Callable[[str], bool]
                    ) -> float:
    return sum(e.end - e.start for e in events if e.device and keep(e.name))
