"""Device kernels counted from a ``torch.profiler`` run, by CUDA symbol.

The card tests ask which hand-written kernels a call ran, and how often.
The profiler answers from what the card did, replays of CUDA graphs
included, by the kernel's ``__global__`` name: ``cascade_lap_kernel``
(K1 and K2: one launch for a B-stream problem, B for B one-stream ones),
``jv_lap_kernel`` (K3), ``stem0_kernel`` (K4, one of its 16 kernels a
call), ``dw3x3_kernel`` (K5), ``bn_act_kernel`` / ``bn_act_kernel_cl``
(K6's NCHW and channels-innermost paths), ``bn_act_backward_kernel`` and
``bn_act_backward_sums`` (K6b), ``crop_resize_kernel`` (K7),
``nms_fixpoint_kernel`` (K8), ``set_conditionals_kernel`` (K9) and
``hierarchy_scan_warp`` / ``hierarchy_scan_block`` (K10).

The host's and the card's clocks in a profile disagree by up to a few
milliseconds, so a window on the host's clock can miss the first or last
kernels of a call. Each counted call is bounded on the card's own
timeline instead: a short marker kernel (``torch.cuda._sleep``, ATen's
``spin_kernel``) runs before it and a long one after it, each between two
device synchronisations, and the kernels that start after the first
marker ends and end before the second starts are the call's.

A profile loses the device events of its first milliseconds, and more
of them the longer its process has run: on an H100 (torch 2.11, CUDA
12.8), late in a card-test process, the first 11 of 50 tiny kernels
launched 2 ms apart at a profile's start; with only 5 ms before its
first marker, 120 of 289 profiles of one card-test run held no device
event at all and 8 lost their first marker. A profile therefore opens
with ``_LEAD_S`` of tiny kernels that are not counted (no profile of a
card-test or chip_smoke.py run lost a marker after it) and closes with
``_TAIL_S`` of idle, and its events count only if they hold every
call's two markers in order; ``kernel_counts`` takes a profile that does
not again. A loss inside a counted call would read as a missing kernel,
so a check that a kernel did not run also asserts one that the same
call must launch.

No JAX here: the module runs on a machine with only PyTorch and CUDA.
"""

from __future__ import annotations

import collections
import contextlib
import re
import time
from typing import Callable, List, Optional

import torch

# The marker kernel and its lengths in cycles before and after a counted
# call (about a microsecond and 50 us on the H100): a marker of another
# profile cannot pass for one of these two in their order.
_MARK = "spin_kernel"
_MARK_CYCLES = (1_000, 100_000)
# Host seconds at the start and the end of a profile in which nothing is
# counted; the start's hold a tiny kernel a millisecond.
_LEAD_S, _TAIL_S = 0.1, 0.01
# Profiles ``kernel_counts`` takes before it gives up.
ATTEMPTS = 8


class ProfileLost(AssertionError):
    """The profile lacks markers of its counted calls."""


def kernel_symbol(name: str) -> str:
    """The function name in a profiler's kernel name: ``void (anonymous
    namespace)::bn_act_kernel_cl<float, 8, 1>(float const*, ...)`` ->
    ``bn_act_kernel_cl``."""
    text = name.replace("(anonymous namespace)::", "")
    if text.startswith("void "):
        text = text[len("void "):]
    found = re.match(r"[A-Za-z_][\w:]*", text)
    return found.group(0).rsplit("::", 1)[-1] if found else name


class Counter:
    """The calls counted in one profile (``counting``): ``counter(fn)``
    runs ``fn`` between its two markers and returns what it returns;
    after the profile, ``counts[i]`` holds the device kernels (and copies)
    of the i-th counted call, by symbol. Work outside a counted call is
    not counted. ``fn`` must end its work on the device by the time it
    returns or on the current stream."""

    def __init__(self):
        self.calls = 0
        self.counts: List[collections.Counter] = []

    def __call__(self, fn: Callable[[], object]):
        _marker(_MARK_CYCLES[0])
        out = fn()
        _marker(_MARK_CYCLES[1])
        self.calls += 1
        return out


def _lead():
    pad = torch.zeros(1, device="cuda")
    start = time.perf_counter()
    while time.perf_counter() - start < _LEAD_S:
        pad.fill_(0.0)
        time.sleep(0.001)
    torch.cuda.synchronize()


def _marker(cycles):
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


@contextlib.contextmanager
def counting():
    """A torch.profiler run of the body; yields a ``Counter``, whose
    ``counts`` are set when the body ends. Raises ``ProfileLost`` if the
    profile's events do not hold each counted call's two markers."""
    from torch.profiler import ProfilerActivity, profile

    counter = Counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead()
        yield counter
        torch.cuda.synchronize()
        time.sleep(_TAIL_S)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.time_range.start, e.time_range.end,
                      kernel_symbol(e.name))
                     for e in prof.events() if e.device_type == cuda)
    marks = [k for k in kernels if k[2] == _MARK]
    pairs = list(zip(marks[::2], marks[1::2]))
    if len(marks) != 2 * counter.calls or any(
            b[1] - b[0] <= 10 * (a[1] - a[0]) for a, b in pairs):
        raise ProfileLost(f"torch.profiler recorded {len(marks)} marker "
                          f"kernels for {counter.calls} counted calls")
    counter.counts = [
        collections.Counter(sym for start, end, sym in kernels
                            if sym != _MARK and a[1] <= start
                            and end <= b[0])
        for a, b in pairs]


def kernel_counts(fn: Callable[[], object],
                  warmup: Optional[Callable[[], object]] = None
                  ) -> collections.Counter:
    """The device kernels (and copies) one call of ``fn`` ran, by symbol.
    ``warmup`` (default: ``fn`` itself) runs first in the profile,
    uncounted; give another one where a second call of ``fn`` would
    change what it computes. ``fn`` may run more than once: a profile
    that lost a marker is taken again, up to ``ATTEMPTS`` times."""
    for attempt in range(ATTEMPTS):
        try:
            with counting() as counter:
                (fn if warmup is None else warmup)()
                counter(fn)
            return counter.counts[0]
        except ProfileLost:
            if attempt == ATTEMPTS - 1:
                raise
