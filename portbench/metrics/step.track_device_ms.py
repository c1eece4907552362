"""step.track_device_ms: device ms a update of the step's track stage,
the Kalman filter, the cascade (K1 / K2), the store and the result's packing: "embed" to the last mark. The program's stage marks (events recorded inside the captured
step), summed over each update's step runs, mean over the unprofiled
window (portbench/program_trace.py)."""

from portbench import program_trace


def read(rec):
    part = program_trace.window(rec)
    return None if part is None else program_trace.stage_ms(part, "track")
