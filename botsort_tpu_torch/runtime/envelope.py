"""Measured per-card serving envelope, keyed by operating point (port of
botsort_tpu/runtime/envelope.py).

The serving CLIs batch B streams through one card
(``BatchedBoTSORTPipeline``); this module records what one card has been
measured to sustain, so that ``cli/multitrack.py`` can warn when B streams
exceed the real-time envelope instead of letting every stream slow down.
The envelope is keyed by ``body_reid_input_hw``: 384x128 crops are 1.5
times the ReID pixels of 256x128 and give a lower aggregate. Points between
the measured ones interpolate linearly in ReID pixel count, clamped at the
ends (larger crops are never credited with more throughput).

The table holds the card's own numbers, not the JAX package's: the JAX
module reads the TPU's ``BENCH_r*.json`` records, which say nothing about
this card. Each value is the aggregate frames per second of an 8-stream
``BatchedBoTSORTPipeline`` replayed from CUDA graphs on the moderate-16
scene of bench.py:499-532 (1080p frames, 16 body slots a stream), full
model width, bfloat16, seeded random weights, as ``chip_smoke.py``'s
``envelope`` phase measures it on an NVIDIA H100 80GB HBM3 at a 700 W
power limit. ``BOTSORT_TPU_AGGREGATE_FPS`` overrides it (tests, other
cards).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

# NVIDIA H100 80GB HBM3, 700.00 W, b = 8 streams, bfloat16, keyed by the
# body ReID input: chip_smoke.py's "envelope" phase, 10 steady steps each
# (PERF.md section 6 names the run).
MEASURED_AGGREGATE_FPS: Dict[Tuple[int, int], float] = {
    (256, 128): 164.61,
    (384, 128): 137.95,
}
DEFAULT_POINT = (256, 128)

_ENV_OVERRIDE = "BOTSORT_TPU_AGGREGATE_FPS"


def aggregate_fps(
        body_reid_input_hw: Tuple[int, int] = DEFAULT_POINT) -> float:
    """Measured aggregate frames/s of one card at the given body-ReID
    operating point (the environment override, where set, wins)."""
    raw = os.environ.get(_ENV_OVERRIDE)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    hw = tuple(body_reid_input_hw)
    if hw in MEASURED_AGGREGATE_FPS:
        return MEASURED_AGGREGATE_FPS[hw]
    # Interpolate in ReID pixel count, clamped to the measured range.
    pts = sorted((h * w, fps) for (h, w), fps
                 in MEASURED_AGGREGATE_FPS.items())
    px = hw[0] * hw[1]
    if px <= pts[0][0]:
        return pts[0][1]
    if px >= pts[-1][0]:
        return pts[-1][1]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if x0 <= px <= x1:
            return y0 + (px - x0) / (x1 - x0) * (y1 - y0)
    return pts[-1][1]  # unreachable


def max_realtime_streams(
        per_stream_fps: float = 30.0,
        body_reid_input_hw: Tuple[int, int] = DEFAULT_POINT) -> int:
    """How many streams one card holds at ``per_stream_fps`` each."""
    return max(int(aggregate_fps(body_reid_input_hw) // per_stream_fps),
               1)


def stream_envelope_warning(
        n_streams: int, backend: str, per_stream_fps: float = 30.0,
        body_reid_input_hw: Optional[Tuple[int, int]] = None
) -> Optional[str]:
    """A warning when ``n_streams`` exceed the measured per-card real-time
    envelope at this operating point, else None. Only the card (backend
    ``"cuda"``) has a measured envelope; the CPU is a functional path. The
    environment override applies on any backend."""
    if backend != "cuda" and not os.environ.get(_ENV_OVERRIDE):
        return None
    hw = tuple(body_reid_input_hw or DEFAULT_POINT)
    cap = max_realtime_streams(per_stream_fps, hw)
    if n_streams <= cap:
        return None
    cards = math.ceil(n_streams / cap)
    return (
        f"WARNING: {n_streams} streams exceed the measured single-card "
        f"real-time envelope at ReID {hw[0]}x{hw[1]} "
        f"({cap} streams at {per_stream_fps:.0f} FPS/stream from "
        f"{aggregate_fps(hw):.0f} FPS aggregate, PERF.md); expect "
        f"<{per_stream_fps:.0f} FPS/stream. Shard across {cards} cards "
        f"(multitrack --chips, MeshBatchedBoTSORTPipeline) or accept the "
        f"degraded rate.")
