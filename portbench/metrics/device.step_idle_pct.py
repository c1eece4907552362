"""device.step_idle_pct: the share of the unprofiled window in which no
step ran on the card: 100 x (1 - the device time from each step run's
first stage mark to its last, summed / the window's seconds). Without the
profiler; the frames' upload, the copies into and out of the graph's
buffers and the readback count as idle (portbench/program_trace.py)."""

from portbench import program_trace


def read(rec):
    part = program_trace.window(rec)
    busy = None if part is None else program_trace.step_device_s(part)
    secs = rec["unprofiled_seconds"]
    if busy is None or secs <= 0:
        return None
    return 100.0 * (1.0 - busy / secs)
