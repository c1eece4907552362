"""Face ReID encoder (port of botsort_tpu/models/facereid.py): a
MobileNetV2-style trunk on 128x128 face crops, global average pool and a
dense head, giving an L2-normalised 256-d embedding. Input: raw BGR
0..255 NHWC, no normalisation. Depthwise 3x3s run as grouped
convolutions (the JAX package's ``dw_mode="conv"``); BN eps is 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from botsort_tpu_torch.models.common import BatchNorm, conv2d

# (expand, channels, repeats, stride) — MobileNetV2 layout.
MOBILENETV2_LAYOUT = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                      (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                      (6, 320, 1, 1))


class _ConvBNRelu6(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups)
        self.BatchNorm_0 = BatchNorm(features, 1e-5)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.clamp(x, 0.0, 6.0) if self.act else x


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        hidden = cin * expand
        layers = []
        if expand != 1:
            layers.append(_ConvBNRelu6(cin, hidden, 1, 1))
        layers.append(_ConvBNRelu6(hidden, hidden, 3, stride, groups=hidden))
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
                 head_width: int = 1280):
        super().__init__()
        self._ConvBNRelu6_0 = _ConvBNRelu6(3, 32, 3, 2)
        cin = 32
        idx = 0
        for expand, ch, reps, stride in layout:
            for i in range(reps):
                self.add_module(f"InvertedResidual_{idx}", InvertedResidual(
                    cin, ch, stride if i == 0 else 1, expand))
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
