"""step.nms_device_ms: device ms a update of the step's nms stage,
decode, top-k, the suppression fixpoint (K8) and the rescale: "detect" to "nms". The program's stage marks (events recorded inside the captured
step), summed over each update's step runs, mean over the unprofiled
window (portbench/program_trace.py)."""

from portbench import program_trace


def read(rec):
    part = program_trace.window(rec)
    return None if part is None else program_trace.stage_ms(part, "nms")
