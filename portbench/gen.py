"""Inputs made from the seed: the networks' weights and the frames.

No trained weights are in the repository, so every weight is drawn from
the seed, on the device, by one ``torch.Generator`` in one call a
network: every convolution and dense kernel normal x fan_in^-1/2, biases
0, and for the modules the recipe knows, norm scales 1, biases 0, means
0, variances 1, GeM's exponent 3 (the recipe of the port's and the JAX
package's test bundles). A module of another family that holds other
tensors (a LayerNorm, a class token, a position table) seeds them in its
own ``seed_(generator)``, called after the draw; a tensor that neither
writes is an error. Then the detector's norms are calibrated
(``calibrate_``): each norm's running mean and variance are set to its
input's on the first frame, and its scale to DETECTOR_GAIN. Uncalibrated,
the detector's activations grow or die with the draw through its
hundred-odd layers, so that one seed's detector reports 50 bodies a frame
and another's none; calibrated at a small gain, every seed's detector
scores its anchors near 0.25 and sizes its boxes near its strides, so
every seed gives a cell the same load, and it stays close to linear, so
rounding does not grow through its depth (at a gain of 1 the calibrated
network is chaotic: bfloat16 and float32 disagree on boxes as much as
float8 does). The encoders keep the recipe's identity norms: their work
does not depend on their outputs, and their rounding stays small. The
state dicts are float32, keyed as the port's and the reference's modules
are.

Frames are 1080p uint8 BGR noise (the frames of the port's chip smoke
test), drawn on the device in one call and copied to the host once.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from portbench import networks
from portbench.reference import nets

# Streams of one seed: weights and frames draw from generators seeded
# apart.
WEIGHTS, FRAMES = 0, 1
DETECTOR_GAIN = 0.1


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (2 ** 63))
    return g


def init_weights(models, seed: int, device) -> None:
    """Materialise the meta-device ``models`` on ``device`` with the
    seeded recipe (norm statistics left at 0 and 1 for ``calibrate_``),
    then each module's ``seed_(generator)``, in ``modules()`` order.
    Raises ValueError naming every parameter or buffer left unwritten."""
    g = generator(seed, WEIGHTS, device)
    for model in models:
        model.to_empty(device=device)
        tensors = dict(model.named_parameters())
        tensors.update(model.named_buffers())
        with torch.no_grad():
            for t in tensors.values():
                if t.is_floating_point():
                    t.fill_(math.nan)
        versions = {k: t._version for k, t in tensors.items()}
        kernels = [m.weight for m in model.modules()
                   if isinstance(m, (nn.Conv2d, nn.Linear))]
        draw = torch.randn(sum(w.numel() for w in kernels), generator=g,
                           device=device, dtype=torch.float32)
        with torch.no_grad():
            off = 0
            for w in kernels:
                n = w.numel()
                fan_in = max(math.prod(w.shape[1:]), 1)
                w.copy_(draw[off:off + n].view_as(w) * fan_in ** -0.5)
                off += n
            for m in model.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)) and \
                        m.bias is not None:
                    m.bias.zero_()
                elif isinstance(m, nets.BatchNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                elif isinstance(m, nets.GeMPool):
                    m.p.fill_(3.0)
            for m in model.modules():
                if hasattr(m, "seed_"):
                    m.seed_(g)
        del draw
        unwritten(model, tensors, versions)
        model.eval().requires_grad_(False)


def unwritten(model, tensors, versions) -> None:
    """Raise ValueError naming the tensors of ``model`` that still hold
    the NaN they were filled with (or, not floating, were never written
    since ``versions``)."""
    floats = [k for k, t in tensors.items() if t.is_floating_point()]
    nan = (torch.stack([tensors[k].isnan().any() for k in floats]).cpu()
           if floats else [])
    bad = [k for k, hit in zip(floats, nan) if hit]
    bad += [k for k, t in tensors.items() if not t.is_floating_point()
            and t._version == versions[k]]
    if bad:
        raise ValueError(f"{type(model).__name__}: no rule of the seeded "
                         f"recipe and no seed_ writes {sorted(bad)}")


@torch.no_grad()
def calibrate_(detector, frame: torch.Tensor, s) -> None:
    """Set every norm of ``detector`` to its input's statistics on
    ``frame`` [H, W, 3] uint8 resized to the detector's input (one float32
    forward, in place), with scale DETECTOR_GAIN. ``s``: the pipeline
    Settings (input size, crop numerics)."""
    from portbench.reference import ops

    hw = frame.shape[:2]
    full = torch.tensor([[[0.0, 0.0, float(hw[1]), float(hw[0])]]],
                        device=frame.device)

    def stats_hook(m, inputs):
        x = inputs[0].float()
        dims = [i for i in range(x.dim()) if i != 1]
        m.running_mean.copy_(x.mean(dim=dims))
        m.running_var.copy_(x.var(dim=dims, unbiased=False).clamp(min=1e-3))
        m.weight.fill_(DETECTOR_GAIN)

    hooks = [m.register_forward_pre_hook(stats_hook)
             for m in detector.modules() if isinstance(m, nets.BatchNorm)]
    detector(ops.crop_resize_plain(frame[None], full, s.detector_input_hw,
                                   s.crop_mode)[:, 0])
    for h in hooks:
        h.remove()


def reference_networks(cfg, seed: int, device, frame, s,
                       precision="float32"):
    """The reference's (detector, body encoder, face encoder) of the
    configuration ``cfg`` from the seed, the detector calibrated on
    ``frame`` (``calibrate_``), at ``precision`` (nets.set_precision)."""
    models = networks.reference(cfg)
    init_weights(models, seed, device)
    calibrate_(models[0], frame, s)
    for m in models:
        nets.set_precision(m, precision)
    return models


def frame_pool(seed: int, count: int, streams: int, hw: Tuple[int, int],
               device) -> np.ndarray:
    """[count, streams, H, W, 3] uint8 noise frames on the host: update u
    of a run takes entry u % count, one frame a stream."""
    g = generator(seed, FRAMES, device)
    frames = torch.randint(0, 255, (count, streams) + tuple(hw) + (3,),
                           generator=g, device=device, dtype=torch.uint8)
    return frames.cpu().numpy()
