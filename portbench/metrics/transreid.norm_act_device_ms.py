"""transreid.norm_act_device_ms: device ms a update of the body encoder's
LayerNorms and GELUs (PyTorch's layer-norm kernels and its GELU
elementwise kernel), by kernel name in the profiled updates. None where
no such kernel ran."""

from portbench import trace

NEEDLES = ("layer_norm", "layernorm", "gelu")


def is_norm_act(name):
    low = name.lower()
    return any(n in low for n in NEEDLES)


def read(rec):
    if rec["profiled_updates"] < 1:
        return None
    us = trace.device_us_where(rec["events"], is_norm_act)
    return us / 1e3 / rec["profiled_updates"] if us > 0 else None
