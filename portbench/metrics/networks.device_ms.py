"""networks.device_ms: device ms a update of the networks' convolutions
and matrix products (cuDNN, cuBLAS (nvjet) and CUTLASS kernels, layout
transposes) and their norms (kernel K6, ``bn_act_kernel``), by kernel
name in the profiled updates."""

from portbench import trace

NEEDLES = ("conv", "gemm", "xmma", "cudnn", "cutlass", "wgmma", "nvjet",
           "nchwToNhwc", "nhwcToNchw", "implicit", "s16816", "s1688",
           "bn_act_kernel")


def is_network(name):
    low = name.lower()
    return any(n.lower() in low for n in NEEDLES)


def read(rec):
    if rec["profiled_updates"] < 1:
        return None
    us = trace.device_us_where(rec["events"], is_network)
    return us / 1e3 / rec["profiled_updates"] if us > 0 else None
