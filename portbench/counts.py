"""Analytic work of the three networks, from a walk of the reference
classes a configuration's ``models`` entries name (portbench/networks.py)
on the meta device: nothing is allocated or computed, only shapes.

- ``flops``: 2 x multiply-accumulates of every convolution and dense
  layer (the convention of YOLOX's published GFLOPs), plus what each
  module with a ``counted_flops(inputs, output)`` returns: a family's
  products of two activations (attention's QK^T and PV), which no
  convolution or dense layer sees;
- ``params``: parameters, norms included;
- ``norm_bytes``: what the batch norms (``nets.BatchNorm``, kernel K6 in
  the port) must move at least: each norm's input read once and output
  written once, in the dtype the port runs it (bfloat16 after a bfloat16
  convolution or dense layer; float32 for the norms the entry lists under
  ``float32_norms``, such as the body encoder's last norm, which follows
  the float32 GeM pool), plus its three float32 parameter vectors (mean,
  scale, bias).

All counts are per image at the given input size. They depend on the
published networks alone, not on the program that runs them.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Tuple

import torch
from torch import nn

from portbench import networks
from portbench.reference import nets

# Peaks of one NVIDIA H100 SXM (data sheet, dense): bfloat16 tensor-core
# FLOP/s and HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def network_counts(entry: Dict, input_hw: Tuple[int, int]
                   ) -> Dict[str, float]:
    """{"flops", "params", "norm_bytes"} of one image through the network
    of a configuration's ``models`` entry."""
    return _counts(json.dumps(entry, sort_keys=True), tuple(input_hw))


@functools.lru_cache(maxsize=None)
def _counts(entry_json: str, input_hw: Tuple[int, int]) -> Dict[str, float]:
    entry = json.loads(entry_json)
    float32_norms = set(entry.get("float32_norms", ()))
    model = networks.reference_network(entry)
    totals = {"flops": 0.0, "norm_bytes": 0.0}
    hooks = []

    def conv_hook(m, inputs, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        totals["flops"] += 2.0 * out.numel() * k

    def linear_hook(m, inputs, out):
        totals["flops"] += 2.0 * out.numel() * m.in_features

    def norm_hook(path):
        width = 4 if path in float32_norms else 2

        def hook(m, inputs, out):
            totals["norm_bytes"] += (2 * width * inputs[0].numel()
                                     + 3 * 4 * m.weight.numel())
        return hook

    def counted_hook(m, inputs, out):
        totals["flops"] += float(m.counted_flops(inputs, out))

    for path, m in model.named_modules():
        if hasattr(m, "counted_flops"):
            hooks.append(m.register_forward_hook(counted_hook))
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
    sizes = {"detector": cfg["detector_input_hw"],
             "body": cfg["body_reid_input_hw"],
             "face": cfg["face_reid_input_hw"]}
    return {n: network_counts(cfg["models"][n], sizes[n])
            for n in networks.NETWORKS}


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
