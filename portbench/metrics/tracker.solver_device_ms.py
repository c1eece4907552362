"""tracker.solver_device_ms: device ms a update of the association
cascade's solver (kernels K1 / K2, ``cascade_lap_kernel``), by kernel
name in the profiled updates."""

from portbench import trace


def read(rec):
    if rec["profiled_updates"] < 1:
        return None
    us = trace.device_us_where(rec["events"],
                               lambda n: "cascade_lap_kernel" in n)
    return us / 1e3 / rec["profiled_updates"] if us > 0 else None
