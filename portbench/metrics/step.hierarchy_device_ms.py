"""step.hierarchy_device_ms: device ms a update of the step's hierarchy stage,
the box hierarchy's claims (K10): "nms" to "hierarchy". The program's stage marks (events recorded inside the captured
step), summed over each update's step runs, mean over the unprofiled
window (portbench/program_trace.py)."""

from portbench import program_trace


def read(rec):
    part = program_trace.window(rec)
    return None if part is None else program_trace.stage_ms(part, "hierarchy")
