"""Shared conv blocks of the detector (port of botsort_tpu/models/common.py).

The public models take NHWC images, as the JAX package does; inside, the
blocks take [N, C, H, W] tensors. On the card they are channels-last in
memory from the first convolution to the last norm: ``cast_compute`` lays
a CUDA module's convolution weights out channels-last, the first
convolution sees the NHWC images through a permuted view, every
convolution and norm (K6's channels-innermost path) keeps that layout, and
so do the concatenations, pools, upsamplings and sums between them; so
cuDNN runs its NHWC kernels with no transpose on the way in or out. On the
CPU the weights stay as they are. Child modules carry the
JAX package's Flax names (``ConvBN_0``, ``Conv_0``, ``BatchNorm_0``, ...)
so that runtime/from_flax.py maps a Flax variable tree onto them by path.

Precision follows the JAX package: convolutions and dense layers run in
the model's compute dtype (bfloat16 on the card); batch normalisation
computes in float32 from float32 statistics and casts back. A norm and the
activation after it are one call of models/bn_act.py::bn_act: kernel K6 on
the card, one pass over the activation.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from botsort_tpu_torch.models.bn_act import bn_act
from botsort_tpu_torch.utils.consts import tracing


class BatchNorm(nn.Module):
    """Batch norm over dim 1 with its running statistics (Flax's
    ``use_running_average=True``, in training too), Flax's formula:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast
    back to the input dtype, then the activation ``act`` (one of
    models/bn_act.py::ACTS) on the cast value. Parameters and statistics
    stay float32."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self._mul = None
        self._mul_key = None
        self._mul_src = None
        # A ``mul`` given from outside: an exported program's input while
        # runtime/exported.py traces the step.
        self.bound_constant = None

    def inference_constant(self) -> torch.Tensor:
        """What an exported program takes as this norm's input: ``mul``."""
        return self.mul()

    def mul(self) -> torch.Tensor:
        """``rsqrt(var + eps) * scale`` [C] float32 of the current
        statistics, rebuilt whenever the variance or the scale was
        replaced, moved or written in place, or eps changed (an inference
        constant: no gradient flows through it). Where a gradient is wanted
        (grad enabled and the variance or the scale requires one, as in
        train/reid_trainer.py) the formula with its graph. Under a trace
        the cache is neither read nor written: the bound value, else the
        formula."""
        if self.bound_constant is not None:
            return self.bound_constant
        var, weight = self.running_var, self.weight
        if torch.is_grad_enabled() and (var.requires_grad
                                        or weight.requires_grad):
            return torch.rsqrt(var + self.eps) * weight
        weight = weight.detach()
        if tracing():
            return torch.rsqrt(var + self.eps) * weight
        key = (var.data_ptr(), var._version, weight.data_ptr(),
               weight._version, self.eps, var.device, var.dtype)
        if key != self._mul_key:
            with torch.no_grad():
                self._mul = torch.rsqrt(var + self.eps) * weight
            self._mul_key = key
            # Holding the sources keeps their memory from being handed to
            # later tensors at the same addresses, which the key would
            # miss.
            self._mul_src = (var, weight)
        return self._mul

    def forward(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        return bn_act(x, self.running_mean, self.mul(), self.bias, act)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1,
           groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """Flax ``nn.Conv`` with symmetric padding (kernel - 1) // 2."""
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                     groups=groups, bias=bias)


def cast_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Convolution and dense weights to the compute dtype; norms and
    other parameters stay float32 (the JAX package's cast_bundle_bf16).
    On a CUDA device the convolution weights also go channels-last, so a
    convolution given the channels-last view of NHWC images writes a
    channels-last output and the activations keep that layout through the
    network; call it after the module is on its device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
        if isinstance(m, nn.Conv2d) and m.weight.is_cuda:
            m.to(memory_format=torch.channels_last)
    return module


class ConvBN(nn.Module):
    """Conv2D + BatchNorm (eps 1e-3) + SiLU: the YOLOX "BaseConv"."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups)
        self.BatchNorm_0 = BatchNorm(features, 1e-3)
        self.act = act

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x),
                                "silu" if self.act else "none")


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(features * expansion)
        self.ConvBN_0 = ConvBN(cin, hidden, 1, 1)
        self.ConvBN_1 = ConvBN(hidden, features, 3, 1)
        self.use_add = shortcut and cin == features

    def forward(self, x):
        y = self.ConvBN_1(self.ConvBN_0(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """Cross-stage-partial layer (YOLOX "CSPLayer" / C3)."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5):
        super().__init__()
        hidden = int(features * expansion)
        self.ConvBN_0 = ConvBN(cin, hidden, 1, 1)
        self.ConvBN_1 = ConvBN(cin, hidden, 1, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"Bottleneck_{i}",
                            Bottleneck(hidden, hidden, shortcut, 1.0))
        self.ConvBN_2 = ConvBN(2 * hidden, features, 1, 1)

    def forward(self, x):
        a = self.ConvBN_0(x)
        b = self.ConvBN_1(x)
        for i in range(self.n):
            a = getattr(self, f"Bottleneck_{i}")(a)
        return self.ConvBN_2(torch.cat([a, b], dim=1))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (kernel sizes 5/9/13, -inf padding). Each
    pool after the first is a pool of the one before it: at stride 1 the
    max over a k-wide window is the max over a (k - j + 1)-wide window of
    the j-wide pool's (borders clip alike), the same values in a third of
    the reads, which matters in the channels-last layout, whose max-pool
    kernel is several times slower on these 15x20 planes."""

    def __init__(self, cin: int, features: int,
                 kernels: Sequence[int] = (5, 9, 13)):
        super().__init__()
        if any(k % 2 == 0 for k in kernels) or \
                list(kernels) != sorted(set(kernels)):
            raise ValueError(f"SPP kernels must be odd and increasing, got "
                             f"{tuple(kernels)}")
        hidden = cin // 2
        self.ConvBN_0 = ConvBN(cin, hidden, 1, 1)
        self.kernels = tuple(kernels)
        self.ConvBN_1 = ConvBN(hidden * (len(kernels) + 1), features, 1, 1)

    def forward(self, x):
        pools, width = [self.ConvBN_0(x)], 1
        for k in self.kernels:
            step = k - width + 1
            pools.append(F.max_pool2d(pools[-1], step, 1, step // 2))
            width = k
        return self.ConvBN_1(torch.cat(pools, dim=1))


class Focus(nn.Module):
    """YOLOX stem in its folded form: the space-to-depth 3x3 conv on 12
    channels equals one 6x6 stride-2 pad-2 conv on the 3 raw channels,
    which is what the JAX package runs (``Focus(fold=True)``) and what
    its parameters hold."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 6, 2, 2, bias=False)
        self.BatchNorm_0 = BatchNorm(features, 1e-3)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x), "silu")
