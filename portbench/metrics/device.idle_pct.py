"""device.idle_pct: the share of the traced window in which the card ran
nothing: 100 x (1 - the union of the device events' intervals / the
window between the profiler's two synchronisations)."""

from portbench import trace


def read(rec):
    lo, hi = rec["window"]
    if hi <= lo:
        return None
    return 100.0 * (1.0 - trace.busy_us(rec["events"]) / (hi - lo))
