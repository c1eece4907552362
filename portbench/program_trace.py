"""The program's own trace: spans and stage device times the port keeps
when its facade traces (``botsort_tpu_torch/utils/profiling.py``), as a
record for the per-layer readers.

``record(export, window_updates, events)`` builds the record key
``program_trace`` from the facade's ``timers.export()`` taken after a
traced run (the window's updates, then the profiled ones):

- ``window``: the spans (``[name, start_ns, end_ns, parent, update]``,
  the host's ``perf_counter_ns``) and stage rows (``[update, [[stage,
  ms], ...]]``, one a step run) of the unprofiled window's updates;
- ``profiled``: those of the profiled updates, the spans moved onto the
  profiler's clock (microseconds, as ``trace.Event``);
- ``offset_us``: what was added to a span's time in ns / 1e3 to move it:
  the median, over the profiled updates, of the start of the benchmark's
  ``record_function("update")`` minus the start of the program's
  ``update`` span (the k-th of one paired with the k-th of the other).

The readers' arithmetic is here too; each returns None where the record
has no program trace (a program that does not trace).

``run.py`` does not build the key yet, so ``BENCHMARK.json`` lists none
of the ten readers that read it (``metrics/step.<stage>_device_ms``,
``device.step_idle_pct``, ``graph.launch_ms``, ``host.wait_ms``,
``host.readback_ms``, ``device.idle_unattributed_pct``). That takes two
added lines, in ``program.py::facade`` (``trace=True`` under
``--trace 1``) and in ``run.py`` (``record["program_trace"] =
program_trace.record(pipe.timers.export(), updates, events)`` after the
profiled run), and the ten entries.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import trace

ROOT = "update"
# The stage rows' names: a stage's device time runs from the mark before
# it to its own; "pack" (the result's packing) counts with "track".
STAGE_ROWS = {"detect": ("detect",), "nms": ("nms",),
              "hierarchy": ("hierarchy",), "embed": ("embed",),
              "track": ("track", "pack")}


def _offset_us(spans, events) -> Optional[float]:
    prog = sorted(s[1] for s in spans if s[0] == ROOT)
    prof = sorted(e.start for e in events
                  if not e.device and e.name == trace.SPANS[0])
    n = min(len(prog), len(prof))
    if n == 0:
        return None
    # Aligned from the end: the profiler's window starts after the
    # first, unrecorded call.
    return statistics.median(a - b / 1e3 for a, b in zip(prof[-n:],
                                                         prog[-n:]))


def record(export: Dict[str, list], window_updates: int,
           events: Sequence[trace.Event] = ()) -> Dict:
    """The ``program_trace`` record of a traced run (module docstring)."""
    spans, stages = export["spans"], export["stages"]
    out = {"window": {"spans": [s for s in spans if s[4] < window_updates],
                      "stages": [r for r in stages
                                 if r[0] < window_updates]}}
    late = [s for s in spans if s[4] >= window_updates]
    offset = _offset_us(late, events)
    if offset is not None:
        out["offset_us"] = offset
        out["profiled"] = {
            "spans": [[n, a / 1e3 + offset, b / 1e3 + offset, p, u]
                      for n, a, b, p, u in late],
            "stages": [r for r in stages if r[0] >= window_updates]}
    return out


def window(rec) -> Optional[Dict[str, list]]:
    """The unprofiled window's part, None where there is none or it holds
    no update."""
    part = (rec.get("program_trace") or {}).get("window")
    if not part or not updates(part):
        return None
    return part


def updates(part) -> int:
    return sum(1 for s in part["spans"] if s[0] == ROOT)


def stage_ms(part, stage: str) -> Optional[float]:
    """Device ms a update of one of the five stages, summed over each
    update's step runs; None where no step run was timed."""
    total, timed = 0.0, False
    for _, rows in part["stages"]:
        for name, ms in rows:
            if ms is not None and name in STAGE_ROWS[stage]:
                total += ms
                timed = True
    return total / updates(part) if timed else None


def step_device_s(part) -> Optional[float]:
    """Seconds of device time from each step run's first mark to its
    last, summed; None where no step run was timed."""
    ms = [m for _, rows in part["stages"] for _, m in rows if m is not None]
    return sum(ms) / 1e3 if ms else None


def span_ms(part, name: str) -> float:
    """Host ms a update inside spans named ``name``."""
    return sum(s[2] - s[1] for s in part["spans"]
               if s[0] == name) / 1e6 / updates(part)


def self_ms(part, name: str) -> float:
    """Host ms a update inside spans named ``name`` and in none of their
    children (spans whose parent is ``name``, inside its interval, of the
    same update)."""
    children = defaultdict(list)
    for c in part["spans"]:
        if c[3] == name:
            children[c[4]].append(c)
    total = 0.0
    for s in part["spans"]:
        if s[0] == name:
            total += s[2] - s[1] - sum(c[2] - c[1] for c in children[s[4]]
                                       if s[1] <= c[1] and c[2] <= s[2])
    return total / 1e6 / updates(part)


def _union(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(events, window_us) -> List[Tuple[float, float]]:
    """The stretches of the profiled window in which the card ran
    nothing."""
    edges = [window_us[0]] + [x for span in trace.busy_intervals(events)
                              for x in span] + [window_us[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def unattributed_idle_pct(rec) -> Optional[float]:
    """Share of the profiled window's device-idle time in which no
    program span below the update's root is open."""
    part = (rec.get("program_trace") or {}).get("profiled")
    if not part:
        return None
    gaps = idle_gaps(rec["events"], rec["window"])
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    covered = _union((s[1], s[2]) for s in part["spans"] if s[0] != ROOT)
    named, j = 0.0, 0
    for a, b in gaps:
        while j < len(covered) and covered[j][1] <= a:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < b:
            named += min(b, covered[k][1]) - max(a, covered[k][0])
            k += 1
    return 100.0 * (1.0 - named / idle)


def launch_outside_us(rec, name: str = "cudaGraphLaunch") -> Optional[float]:
    """The farthest, in microseconds, that a profiled host event ``name``
    lies outside every program ``graph.launch`` span (0: each inside
    one), after the clocks' mapping; None where either is missing."""
    part = (rec.get("program_trace") or {}).get("profiled")
    calls = [e for e in rec.get("events", ()) if not e.device and
             e.name == name]
    if not part or not calls:
        return None
    launches = [(s[1], s[2]) for s in part["spans"]
                if s[0] == "graph.launch"]
    if not launches:
        return None
    worst = 0.0
    for e in calls:
        worst = max(worst, min(max(a - e.start, e.end - b, 0.0)
                               for a, b in launches))
    return worst
