"""mfu: the whole step's share of the card's bfloat16 peak. The useful
FLOPs of the unprofiled updates (the detector once a frame, the body
encoder once a live body, the face encoder once an attached face:
portbench/counts.py, from the published architectures) over those
updates' host-clock seconds, divided by 989 TFLOP/s."""

from portbench import counts


def read(rec):
    secs = rec["unprofiled_seconds"]
    flops = rec["unprofiled_flops"]
    if secs <= 0 or flops <= 0:
        return None
    return 100.0 * flops / secs / counts.PEAK_BF16_FLOPS
