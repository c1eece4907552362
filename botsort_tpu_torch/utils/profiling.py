"""Per-stage wall-clock timers, the facades' tracer, and a device trace
(port of botsort_tpu/utils/profiling.py).

``StageTimers`` sums the host-clock time of each named stage of an update
(``report()``: ms averages). PyTorch returns before the card finishes, so
a stage's time is its host work and its enqueueing; no stage waits for the
card. With ``trace=True`` it is also the facades' tracer, and keeps:

- host spans: each ``stage``, each ``span`` and each update's root
  (``begin_update`` / ``end_update``) as ``(name, start_ns, end_ns,
  parent, update)``: ``time.perf_counter_ns()`` times, the enclosing
  span's name (None for the root) and the update's index since the last
  ``reset()``; in a ring of ``CAPACITY`` spans (a 45 s window of the
  6 ms empty-scene update holds about 53,000), so a server that traces
  does not grow;
- device stage times: while a step is enqueued under ``recording(marks)``,
  each ``stage_mark(name)`` the step reaches records a timing event on the
  current stream (inside a CUDA-graph capture an event-record node, which
  every replay records again, so a replay times its stages without running
  Python); once the step's work is done, ``add_step`` keeps the device ms
  between consecutive marks, named by the later mark;
- device part times: a pair of ``part_mark(name)`` calls inside a stage
  (the body encoder's call, ``PARTS``) records two more events the same
  way, and ``add_step`` keeps the device ms between them as a row of that
  part's own, apart from the stage rows, which read as they would
  without it.

``export()`` returns them as plain lists. With ``trace=False`` (the
default) a span is a shared no-op context, ``stage_mark`` records nothing
and nothing is kept. ``device_trace(log_dir)`` is the counterpart of the
JAX package's ``jax.profiler`` trace: a ``torch.profiler`` run over the
host and, where there is one, the card, written as a Chrome trace into
``log_dir``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

import torch

# The root span of an update.
ROOT = "update"
# The step's stage marks, in run order: the step's start, then the end of
# each stage (pipeline/frame_step.py; "pack": pipeline/host.py). A stage's
# device time runs from the mark before it to its own.
MARKS = ("start", "detect", "nms", "hierarchy", "embed", "track", "pack")
# The five stages a step's device time is reported by; "track" includes
# the packing of the result that follows it.
STAGES = ("detect", "nms", "hierarchy", "embed", "track")
# Parts of a stage timed on their own, by a pair of ``part_mark`` calls:
# the body crops and the body encoder's call, inside "embed".
PARTS = ("body_encoder",)

_NULL = contextlib.nullcontext()


class Marks:
    """The stage marks of one step run, in run order: their names and, on a
    CUDA device, their timing events (None elsewhere: no device time);
    and the part marks, kept apart in ``parts`` as (name, event)."""

    def __init__(self, tracer: "StageTimers", device):
        self.tracer = tracer
        self.timed = torch.device(device).type == "cuda"
        self.names: List[str] = []
        self.events: List[Optional[torch.cuda.Event]] = []
        self.parts: List[tuple] = []

    def _event(self) -> Optional[torch.cuda.Event]:
        if not self.timed:
            return None
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    def mark(self, name: str) -> None:
        self.names.append(name)
        self.events.append(self._event())

    def part(self, name: str) -> None:
        self.parts.append((name, self._event()))

    def take(self, other: Optional["Marks"]) -> None:
        """Adopt a capture's marks: a replay records its events again."""
        if other is not None:
            self.names.extend(other.names)
            self.events.extend(other.events)
            self.parts.extend(other.parts)


class _Refused:
    """Stands for the marks inside a switch branch's capture: a branch is
    the body of a conditional node, which takes no event-record node."""

    def mark(self, name: str) -> None:
        raise RuntimeError(f"stage mark {name!r} inside a switch branch")

    part = mark


NO_MARKS_IN_BRANCH = _Refused()
_MARKS: contextvars.ContextVar = contextvars.ContextVar(
    "botsort_stage_marks", default=None)


def stage_mark(name: str) -> None:
    """Mark the end of a stage of the step being recorded (no-op unless a
    traced facade is enqueueing a step)."""
    marks = _MARKS.get()
    if marks is not None:
        marks.mark(name)


def part_mark(name: str) -> None:
    """Mark the start, then the end, of a part of a stage (one of
    ``PARTS``) of the step being recorded (no-op unless a traced facade is
    enqueueing a step)."""
    marks = _MARKS.get()
    if marks is not None:
        marks.part(name)


def current_marks() -> Optional[Marks]:
    return _MARKS.get()


@contextlib.contextmanager
def recording(marks) -> Iterator[None]:
    """Record the block's stage marks into ``marks`` (None: none)."""
    token = _MARKS.set(marks)
    try:
        yield
    finally:
        _MARKS.reset(token)


class StageTimers:
    """Accumulates wall-clock per named stage; report() -> ms averages.
    ``trace``: also keep spans and stage device times (module docstring)."""

    CAPACITY = 1 << 17

    def __init__(self, trace: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.tracing = trace
        self.update = -1
        self._open: List[str] = []
        self._root: Optional[int] = None
        self._spans = deque(maxlen=self.CAPACITY) if trace else None
        self._steps = deque(maxlen=self.CAPACITY) if trace else None
        self._parts = {p: deque(maxlen=self.CAPACITY) if trace else None
                       for p in PARTS}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with self.span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def span(self, name: str):
        """A span of the trace that adds no stage total."""
        return self._span(name) if self.tracing else _NULL

    @contextlib.contextmanager
    def _span(self, name: str) -> Iterator[None]:
        token = self._begin(name)
        try:
            yield
        finally:
            self._end(token)

    def _begin(self, name: str):
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        return name, time.perf_counter_ns(), parent

    def _end(self, token) -> None:
        name, start, parent = token
        if self._open:
            self._open.pop()
        self._spans.append((name, start, time.perf_counter_ns(), parent,
                            self.update))

    def begin_update(self) -> None:
        """Open the root span of a new update (closes whatever an update
        that raised left open)."""
        if self.tracing:
            self.update += 1
            self._open[:] = [ROOT]
            self._root = time.perf_counter_ns()

    def end_update(self) -> None:
        if self.tracing and self._root is not None:
            self._spans.append((ROOT, self._root, time.perf_counter_ns(),
                                None, self.update))
            self._root = None
            self._open.clear()

    def add_step(self, marks: Optional[Marks]) -> None:
        """Keep one step run's stage device times, once its work is done:
        ``[update, [[stage, ms], ...]]`` (ms None off CUDA), and each
        pair of its part marks' ``[update, ms]`` under the part's name."""
        if not self.tracing or marks is None or len(marks.names) < 2:
            return
        ev = marks.events
        ms = [ev[i].elapsed_time(ev[i + 1]) if marks.timed else None
              for i in range(len(ev) - 1)]
        self._steps.append((self.update, list(zip(marks.names[1:], ms))))
        for (name, a), (_, b) in zip(marks.parts[0::2], marks.parts[1::2]):
            self._parts[name].append(
                (self.update, a.elapsed_time(b) if marks.timed else None))

    def report(self) -> Dict[str, float]:
        return {
            name: 1000.0 * self.totals[name] / max(self.counts[name], 1)
            for name in self.totals
        }

    def export(self) -> Dict[str, list]:
        """{"spans": [[name, start_ns, end_ns, parent, update], ...],
        "stages": [[update, [[stage, ms], ...]], ...], and for each of
        ``PARTS`` its name: [[update, ms], ...]}, one stage row and one
        row a part for each step run, oldest first (empty lists when not
        tracing)."""
        if not self.tracing:
            return {"spans": [], "stages": [], **{p: [] for p in PARTS}}
        return {"spans": [list(s) for s in self._spans],
                "stages": [[u, [list(p) for p in st]]
                           for u, st in self._steps],
                **{p: [list(r) for r in rows]
                   for p, rows in self._parts.items()}}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Means a update over the kept trace: each span's self time (its
        time less its children's) and each of ``STAGES``' and ``PARTS``'
        device time, in ms."""
        spans = list(self._spans or ())
        n = max(sum(1 for s in spans if s[0] == ROOT), 1)
        own: Dict[str, float] = defaultdict(float)
        for name, a, b, _, _ in spans:
            own[name] += (b - a) / 1e6
        for _, a, b, parent, _ in spans:
            if parent is not None:
                own[parent] -= (b - a) / 1e6
        device: Dict[str, float] = defaultdict(float)
        for _, stages in self._steps or ():
            for stage, ms in stages:
                if ms is not None:
                    device["track" if stage == "pack" else stage] += ms
        for part, rows in (self._parts.items() if self.tracing else ()):
            for _, ms in rows:
                if ms is not None:
                    device[part] += ms
        return {"self_ms": {k: v / n for k, v in own.items()},
                "device_ms": {k: device[k] / n for k in STAGES + PARTS
                              if k in device}}

    def summary_lines(self) -> List[str]:
        """``summary()`` as lines for a terminal (``--profile``)."""
        out = self.summary()
        return ([f"  {name}: {ms:.3f} ms self a update"
                 for name, ms in sorted(out["self_ms"].items())]
                + [f"  device {stage}: {ms:.3f} ms a update"
                   for stage, ms in out["device_ms"].items()])

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        if self.tracing:
            self.update = -1
            self._open.clear()
            self._root = None
            self._spans.clear()
            self._steps.clear()
            for rows in self._parts.values():
                rows.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body of the ``with`` (CPU activity, and CUDA activity
    when a card is present) and write its Chrome trace to
    ``{log_dir}/trace.json`` at exit (chrome://tracing or Perfetto read
    it). Yields the profiler, whose ``key_averages()`` sums by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
