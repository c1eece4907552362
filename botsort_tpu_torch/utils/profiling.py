"""Per-stage wall-clock timers and a device trace (port of
botsort_tpu/utils/profiling.py).

PyTorch returns before the card finishes. With ``cuda_sync`` every stage
ends with ``torch.cuda.synchronize()``, so that its time covers the device
work it enqueued (the facades ask for that only when profiling); without
it a stage's time is the enqueueing alone and nothing waits for the card.
``device_trace(log_dir)`` is the counterpart of the JAX package's
``jax.profiler`` trace: a ``torch.profiler`` run over the host and, where
there is one, the card, written as a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class StageTimers:
    """Accumulates wall-clock per named stage; report() -> ms averages."""

    def __init__(self, cuda_sync: bool = False):
        self.cuda_sync = cuda_sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda_sync:
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        return {
            name: 1000.0 * self.totals[name] / max(self.counts[name], 1)
            for name in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


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
