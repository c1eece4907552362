"""kernel.bn_act.roofline_pct: kernel K6's share of its roofline. The
least bytes its norms must move in the profiled updates (each norm's
input read once, output written once, its parameters: portbench/counts.py
at the batches the program ran) over the HBM peak, divided by K6's device
time in the trace (``bn_act_kernel``). K6 is bound by bytes: its
operations are a few per element."""

from portbench import counts, trace


def read(rec):
    us = trace.device_us_where(rec["events"], lambda n: "bn_act_kernel" in n)
    nbytes = rec.get("norm_bytes_profiled", 0.0)
    if us <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / counts.PEAK_HBM_BYTES_S) / (us / 1e6)
