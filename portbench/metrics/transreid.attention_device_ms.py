"""transreid.attention_device_ms: device ms a update of the body encoder's
attention, the fused scaled-dot-product attention kernels that
``F.scaled_dot_product_attention`` runs (flash, memory-efficient or cuDNN
attention, whichever the card picks), by kernel name in the profiled
updates. None where no such kernel ran."""

from portbench import trace

NEEDLES = ("flash_fwd", "flash_fprop", "fmha", "sdpa", "attention")


def is_attention(name):
    low = name.lower()
    return any(n in low for n in NEEDLES)


def read(rec):
    if rec["profiled_updates"] < 1:
        return None
    us = trace.device_us_where(rec["events"], is_attention)
    return us / 1e3 / rec["profiled_updates"] if us > 0 else None
