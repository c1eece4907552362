"""FastReID SBS(S50) body ReID encoder (port of
botsort_tpu/models/fastreid.py): ResNeSt-50 (split-attention bottlenecks,
deep stem, average-pool downsampling, last stride 1), generalized-mean
pooling and a BNNeck, giving an L2-normalised 2048-d embedding. Input:
normalised RGB NHWC (``preprocess``). BN eps is 1e-5 throughout.

``fused_stem=True`` runs the deep stem and stage 1 as one
models/fastreid_fused.py::stem_stage1 call (kernel K4 on the card), as the
JAX package's ``fused_stem=True`` runs its Pallas kernel, under the JAX
model's own static dispatch: only when stage 1 has three blocks, the convs
are bfloat16 and the input geometry passes ``geometry_ok``; otherwise the
plain modules run. The state dict is the same in both modes.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from botsort_tpu_torch.models.common import BatchNorm, conv2d
from botsort_tpu_torch.utils.consts import const, tracing
from botsort_tpu_torch.models.fastreid_fused import (
    fold_stem_stage1,
    geometry_ok,
    stem_stage1,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _ConvBN(nn.Module):
    """Conv + BN (+ReLU)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups)
        self.BatchNorm_0 = BatchNorm(features, 1e-5)
        self.act = act

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x),
                                "relu" if self.act else "none")


class SplAtConv(nn.Module):
    """Split-attention 3x3 convolution (ResNeSt), radix 2, cardinality 1.
    Conv output channels are radix-major ([radix0 C | radix1 C])."""

    def __init__(self, cin: int, features: int, radix: int = 2,
                 reduction: int = 4):
        super().__init__()
        c, r = features, radix
        inter = max(c * r // reduction, 32)
        self.radix = r
        self._ConvBN_0 = _ConvBN(cin, c * r, 3, 1, groups=r)
        self.Dense_0 = nn.Linear(c, inter)
        self.BatchNorm_0 = BatchNorm(inter, 1e-5)
        self.Dense_1 = nn.Linear(inter, c * r)

    def forward(self, x):
        x = self._ConvBN_0(x)
        b, _, h, w = x.shape
        r = self.radix
        splits = x.view(b, r, -1, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3))                     # [B, C]
        z = self.BatchNorm_0(self.Dense_0(gap), "relu")
        atten = self.Dense_1(z).view(b, r, -1)
        atten = torch.softmax(atten.float(), dim=1).to(x.dtype)      # rSoftmax
        return (splits * atten[..., None, None]).sum(dim=1)


class SplAtBottleneck(nn.Module):
    """1x1 -> SplAt 3x3 (+avd 3x3 average pool on stride) -> 1x1 x4,
    with an avg-pool + 1x1 shortcut on the first block of a stage."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = width * 4
        self.stride = stride
        self._ConvBN_0 = _ConvBN(cin, width, 1, 1)
        self.SplAtConv_0 = SplAtConv(width, width)
        self._ConvBN_1 = _ConvBN(width, out_ch, 1, 1, act=False)
        self.downsample = downsample
        if downsample:
            self._ConvBN_2 = _ConvBN(cin, out_ch, 1, 1, act=False)

    def forward(self, x):
        y = self.SplAtConv_0(self._ConvBN_0(x))
        if self.stride > 1:
            # Flax avg_pool counts the zero padding, as torch does.
            y = F.avg_pool2d(y, 3, self.stride, 1)
        y = self._ConvBN_1(y)
        s = x
        if self.downsample:
            if self.stride > 1:
                s = F.avg_pool2d(s, self.stride, self.stride)
            s = self._ConvBN_2(s)
        return F.relu(y + s)


class ResNeSt50(nn.Module):
    """ResNeSt trunk with last stride 1; the defaults are ResNeSt-50."""

    def __init__(self, stage_blocks=(3, 4, 6, 3),
                 stage_widths=(64, 128, 256, 512), stem_width: int = 32,
                 fused_stem: bool = False):
        super().__init__()
        self.fused_stem = fused_stem
        self.stage1_blocks = stage_blocks[0]
        self._folded = None
        self._folded_key = None
        # A fold given from outside: an exported program's inputs while
        # runtime/exported.py traces the step.
        self.bound_constant = None
        sw = stem_width
        self._ConvBN_0 = _ConvBN(3, sw, 3, 2)
        self._ConvBN_1 = _ConvBN(sw, sw, 3, 1)
        self._ConvBN_2 = _ConvBN(sw, sw * 2, 3, 1)
        cin = sw * 2
        idx = 0
        for width, blocks, stride in zip(stage_widths, stage_blocks,
                                         (1, 2, 2, 1)):
            for i in range(blocks):
                self.add_module(f"SplAtBottleneck_{idx}", SplAtBottleneck(
                    cin, width, stride if i == 0 else 1, downsample=i == 0))
                cin = width * 4
                idx += 1
        self.n_blocks = idx

    def uses_fused_stem(self, h: int, w: int) -> bool:
        """The JAX model's dispatch: the fused stem and stage 1 run only for
        three stage-1 blocks, bfloat16 convs and a supported geometry."""
        return (self.fused_stem and self.stage1_blocks == 3
                and self._ConvBN_0.Conv_0.weight.dtype == torch.bfloat16
                and geometry_ok(h, w))

    def inference_constant(self):
        """What an exported program takes as this trunk's input: K4's fold
        (with ``fused_stem`` only)."""
        return self.folded_stem_stage1() if self.fused_stem else None

    def folded_stem_stage1(self):
        """fold_stem_stage1 of the current weights, refolded whenever one of
        them was replaced or written in place. Under a trace the cache is
        neither read nor written: the bound fold, else a fresh one."""
        if self.bound_constant is not None:
            return self.bound_constant
        if tracing():
            return fold_stem_stage1(self)
        parts = [self._ConvBN_0, self._ConvBN_1, self._ConvBN_2,
                 self.SplAtBottleneck_0, self.SplAtBottleneck_1,
                 self.SplAtBottleneck_2]
        key = tuple((t.data_ptr(), t._version) for m in parts
                    for t in (*m.parameters(), *m.buffers()))
        if key != self._folded_key:
            self._folded = fold_stem_stage1(self)
            self._folded_key = key
        return self._folded

    def forward(self, x):
        start = 0
        if self.uses_fused_stem(x.shape[2], x.shape[3]):
            # x is the NCHW view of NHWC images: stem_stage1 takes NHWC.
            x = stem_stage1(x.permute(0, 2, 3, 1),
                            self.folded_stem_stage1())
            start = 3
        else:
            x = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(start, self.n_blocks):
            x = getattr(self, f"SplAtBottleneck_{i}")(x)
        return x


class GeMPool(nn.Module):
    """Generalized-mean pooling with learnable exponent p (init 3)."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.tensor(3.0))

    def forward(self, x):
        x = torch.clamp(x.float(), min=self.eps) ** self.p
        return x.mean(dim=(2, 3)) ** (1.0 / self.p)


class FastReIDSBS(nn.Module):
    """images [N, H, W, 3] normalised RGB -> [N, D] float32 L2-normalised
    embeddings (trunk -> GeM -> BNNeck -> normalise)."""

    def __init__(self, feature_dim: int = 2048, stage_blocks=(3, 4, 6, 3),
                 stage_widths=(64, 128, 256, 512), stem_width: int = 32,
                 fused_stem: bool = False):
        super().__init__()
        self.ResNeSt50_0 = ResNeSt50(stage_blocks, stage_widths, stem_width,
                                     fused_stem)
        self.GeMPool_0 = GeMPool()
        self.BatchNorm_0 = BatchNorm(stage_widths[-1] * 4, 1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self.ResNeSt50_0._ConvBN_0.Conv_0.weight.dtype
        x = self.ResNeSt50_0(images.permute(0, 3, 1, 2).to(dtype))
        feat = self.BatchNorm_0(self.GeMPool_0(x))
        norm = torch.linalg.norm(feat, dim=-1, keepdim=True)
        return feat / torch.clamp(norm, min=1e-12)


def encode_and_compare(model: FastReIDSBS, images: torch.Tensor,
                       target_features: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference ONNX contract: (images [N, H, W, 3], target_features
    [M, D]) -> (similarities [N, M], features [N, D])."""
    feats = model(images)
    return feats @ target_features.float().T, feats


def preprocess(images_bgr: torch.Tensor) -> torch.Tensor:
    """BGR [N, H, W, 3] -> normalised RGB float32 (ImageNet mean/std)."""
    rgb = images_bgr.flip(-1).float() / 255.0
    mean = const(IMAGENET_MEAN, torch.float32, rgb.device)
    std = const(IMAGENET_STD, torch.float32, rgb.device)
    return (rgb - mean) / std
