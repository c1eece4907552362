"""Analytic work of the three networks, from a walk of the plain
reference architectures (portbench/reference/nets.py) on the meta device:
nothing is allocated or computed, only shapes.

- ``flops``: 2 x multiply-accumulates of every convolution and dense
  layer (the convention of YOLOX's published GFLOPs);
- ``params``: parameters, norms included;
- ``norm_bytes``: what the norms (kernel K6 in the port) must move at
  least: each norm's input read once and output written once, in the dtype
  the port runs it (bfloat16 after a bfloat16 convolution or dense layer;
  float32 for the body encoder's last norm, which follows the float32 GeM
  pool), plus its three float32 parameter vectors (mean, scale, bias).

All counts are per image at the given input size. They depend on the
published architectures alone, not on the program that runs them.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn

from portbench.reference import nets

# Peaks of one NVIDIA H100 SXM (data sheet, dense): bfloat16 tensor-core
# FLOP/s and HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

NETWORKS = ("detector", "body", "face")
# Norms the port runs on float32 inputs: (network, module path).
FLOAT32_NORMS = {("body", "BatchNorm_0")}


@functools.lru_cache(maxsize=None)
def network_counts(arch: str, network: str, input_hw: Tuple[int, int]
                   ) -> Dict[str, float]:
    """{"flops", "params", "norm_bytes"} of one image through ``network``
    ("detector", "body" or "face") of ``arch`` ("full" or "mini")."""
    model = dict(zip(NETWORKS, nets.build(arch)))[network]
    totals = {"flops": 0.0, "norm_bytes": 0.0}
    hooks = []

    def conv_hook(m, inputs, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        totals["flops"] += 2.0 * out.numel() * k

    def linear_hook(m, inputs, out):
        totals["flops"] += 2.0 * out.numel() * m.in_features

    def norm_hook(path):
        width = 4 if (network, path) in FLOAT32_NORMS else 2

        def hook(m, inputs, out):
            totals["norm_bytes"] += (2 * width * inputs[0].numel()
                                     + 3 * 4 * m.weight.numel())
        return hook

    for path, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(linear_hook))
        elif isinstance(m, nets.BatchNorm):
            hooks.append(m.register_forward_hook(norm_hook(path)))
    h, w = input_hw
    with torch.no_grad():
        model(torch.zeros((1, h, w, 3), device="meta"))
    for hk in hooks:
        hk.remove()
    totals["params"] = float(sum(p.numel() for p in model.parameters()))
    return totals


def cell_counts(cfg: Dict) -> Dict[str, Dict[str, float]]:
    """network -> counts per image, at the configuration's input sizes."""
    arch = cfg.get("arch", "full")
    sizes = {"detector": cfg["detector_input_hw"],
             "body": cfg["body_reid_input_hw"],
             "face": cfg["face_reid_input_hw"]}
    return {n: network_counts(arch, n, tuple(sizes[n])) for n in NETWORKS}


def useful_flops(counts, frames: int, bodies: int, faces: int) -> float:
    """FLOPs of the useful work: the detector once a frame, the body
    encoder once a live body, the face encoder once a face attached to a
    live body."""
    return (frames * counts["detector"]["flops"]
            + bodies * counts["body"]["flops"]
            + faces * counts["face"]["flops"])


def run_norm_bytes(counts, frames: int, body_crops: int,
                   face_crops: int) -> float:
    """Norm bytes of what the program ran: the detector once a frame and
    each encoder once a crop of its batch (the bucket, padding included)."""
    return (frames * counts["detector"]["norm_bytes"]
            + body_crops * counts["body"]["norm_bytes"]
            + face_crops * counts["face"]["norm_bytes"])
