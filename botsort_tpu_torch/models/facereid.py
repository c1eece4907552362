"""Face ReID encoder (port of botsort_tpu/models/facereid.py): a
MobileNetV2-style trunk on 128x128 face crops, global average pool and a
dense head, giving an L2-normalised 256-d embedding. Input: raw BGR
0..255 NHWC, no normalisation; BN eps is 1e-5.

``dw_mode`` selects how a depthwise 3x3 runs, with the same weights and the
same state dict in every mode: ``"conv"`` (the default) is the grouped
convolution, the JAX package's ``"conv"``; ``"kernel"`` is the JAX
package's ``"pallas"``: every stride-1 depthwise 3x3 goes through
models/facereid_dw.py (kernel K5 on the card) and the stride-2 ones stay
grouped convolutions, as ``DWConvPallas`` keeps them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from botsort_tpu_torch.models.common import BatchNorm, conv2d
from botsort_tpu_torch.models.facereid_dw import dw_conv3x3, taps_of

# (expand, channels, repeats, stride) — MobileNetV2 layout.
MOBILENETV2_LAYOUT = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                      (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                      (6, 320, 1, 1))
DW_MODES = ("conv", "kernel")


def check_dw_mode(dw_mode: str) -> None:
    if dw_mode in ("shift", "skip"):
        raise ValueError(
            f"dw_mode {dw_mode!r} is a TPU probe of the JAX package and is "
            "not ported (ROADMAP.md, \"Not ported\")")
    if dw_mode not in DW_MODES:
        raise ValueError(f"unknown dw_mode {dw_mode!r}; expected one of "
                         f"{DW_MODES}")


class _ConvBNRelu6(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True,
                 dw_mode: str = "conv"):
        super().__init__()
        check_dw_mode(dw_mode)
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups)
        self.BatchNorm_0 = BatchNorm(features, 1e-5)
        self.act = act
        # The stride-1 depthwise 3x3s of dw_mode="kernel" run K5.
        self.dw_kernel = (dw_mode == "kernel" and groups > 1
                          and stride == 1)
        self._taps = None
        self._taps_key = None
        self._taps_src = None

    def taps(self) -> torch.Tensor:
        """K5's taps [9, C] of the current weight, rebuilt whenever the
        weight was replaced, moved, cast or written in place (an inference
        constant: no gradient flows through it)."""
        w = self.Conv_0.weight.detach()  # shares the weight's version
        key = (w.data_ptr(), w._version, w.dtype, w.device, w.shape)
        if key != self._taps_key:
            self._taps = taps_of(w)
            self._taps_key = key
            # Holding the source keeps its memory from being handed to a
            # later weight at the same address, which the key would miss.
            self._taps_src = w
        return self._taps

    def forward(self, x):
        if self.dw_kernel:
            x = dw_conv3x3(x, self.taps())
        else:
            x = self.Conv_0(x)
        return self.BatchNorm_0(x, "relu6" if self.act else "none")


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 expand: int = 6, dw_mode: str = "conv"):
        super().__init__()
        hidden = cin * expand
        layers = []
        if expand != 1:
            layers.append(_ConvBNRelu6(cin, hidden, 1, 1))
        layers.append(_ConvBNRelu6(hidden, hidden, 3, stride, groups=hidden,
                                   dw_mode=dw_mode))
        layers.append(_ConvBNRelu6(hidden, features, 1, 1, act=False))
        self.n = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"_ConvBNRelu6_{i}", layer)
        self.use_add = stride == 1 and cin == features

    def forward(self, x):
        y = x
        for i in range(self.n):
            y = getattr(self, f"_ConvBNRelu6_{i}")(y)
        return y + x if self.use_add else y


class FaceReID(nn.Module):
    """images [N, H, W, 3] raw BGR -> [N, 256] float32 L2-normalised
    embeddings. The pooled features and the dense head run in float32,
    as in the JAX model."""

    def __init__(self, feature_dim: int = 256, layout=MOBILENETV2_LAYOUT,
                 head_width: int = 1280, dw_mode: str = "conv"):
        super().__init__()
        self._ConvBNRelu6_0 = _ConvBNRelu6(3, 32, 3, 2)
        cin = 32
        idx = 0
        for expand, ch, reps, stride in layout:
            for i in range(reps):
                self.add_module(f"InvertedResidual_{idx}", InvertedResidual(
                    cin, ch, stride if i == 0 else 1, expand, dw_mode))
                cin = ch
                idx += 1
        self.n_blocks = idx
        self._ConvBNRelu6_1 = _ConvBNRelu6(cin, head_width, 1, 1)
        self.Dense_0 = nn.Linear(head_width, feature_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self._ConvBNRelu6_0.Conv_0.weight.dtype
        x = self._ConvBNRelu6_0(images.permute(0, 3, 1, 2).to(dtype))
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = self._ConvBNRelu6_1(x).float().mean(dim=(2, 3))
        feat = F.linear(x, self.Dense_0.weight.float(),
                        self.Dense_0.bias.float())
        norm = torch.linalg.norm(feat, dim=-1, keepdim=True)
        return feat / torch.clamp(norm, min=1e-12)


def encode_and_compare(model: FaceReID, images: torch.Tensor,
                       target_features: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images [N, H, W, 3], target_features [M, D]) -> (features [N, D],
    similarities [N, M]): the face model's own output order, the opposite
    of the body model's (the JAX package's contract)."""
    feats = model(images)
    return feats, feats @ target_features.float().T
