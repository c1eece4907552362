"""device.idle_unattributed_pct: the share of the profiled window's
device-idle time (trace.busy_intervals) in which no program span below
the update's root is open, once the program's spans are moved onto the
profiler's clock (portbench/program_trace.py)."""

from portbench import program_trace


def read(rec):
    return program_trace.unattributed_idle_pct(rec)
