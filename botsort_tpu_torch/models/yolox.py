"""YOLOX detector (port of botsort_tpu/models/yolox.py).

CSPDarknet + PAFPN + decoupled head with the YOLOX depth/width
multipliers; the repo's detector is YOLOX-X (depth 1.33, width 1.25) with
four classes (body, head, hand, face). Input: raw BGR pixels 0..255,
NHWC, no normalisation. ``YOLOX.forward`` returns decoded candidates,
boxes [B, A, 4] tlbr in input pixels and obj*cls scores [B, A, C].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from botsort_tpu_torch.models.common import (
    ConvBN,
    CSPLayer,
    Focus,
    SPPBottleneck,
)

STRIDES = (8, 16, 32)


def _d(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


def _w(c: int, width: float) -> int:
    return int(c * width)


class CSPDarknet(nn.Module):
    def __init__(self, depth: float, width: float):
        super().__init__()
        d, w = depth, width
        self.Focus_0 = Focus(3, _w(64, w))                            # /2
        self.ConvBN_0 = ConvBN(_w(64, w), _w(128, w), 3, 2)           # /4
        self.CSPLayer_0 = CSPLayer(_w(128, w), _w(128, w), _d(3, d))
        self.ConvBN_1 = ConvBN(_w(128, w), _w(256, w), 3, 2)          # /8
        self.CSPLayer_1 = CSPLayer(_w(256, w), _w(256, w), _d(9, d))
        self.ConvBN_2 = ConvBN(_w(256, w), _w(512, w), 3, 2)          # /16
        self.CSPLayer_2 = CSPLayer(_w(512, w), _w(512, w), _d(9, d))
        self.ConvBN_3 = ConvBN(_w(512, w), _w(1024, w), 3, 2)         # /32
        self.SPPBottleneck_0 = SPPBottleneck(_w(1024, w), _w(1024, w))
        self.CSPLayer_3 = CSPLayer(_w(1024, w), _w(1024, w), _d(3, d),
                                   shortcut=False)

    def forward(self, x):
        x = self.CSPLayer_0(self.ConvBN_0(self.Focus_0(x)))
        c3 = self.CSPLayer_1(self.ConvBN_1(x))
        c4 = self.CSPLayer_2(self.ConvBN_2(c3))
        x = self.SPPBottleneck_0(self.ConvBN_3(c4))
        return c3, c4, self.CSPLayer_3(x)


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling (jnp.repeat on both spatial axes): a copy of
    each element, in x's layout."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PAFPN(nn.Module):
    def __init__(self, depth: float, width: float):
        super().__init__()
        d, w = depth, width
        self.ConvBN_0 = ConvBN(_w(1024, w), _w(512, w), 1, 1)
        self.CSPLayer_0 = CSPLayer(2 * _w(512, w), _w(512, w), _d(3, d),
                                   shortcut=False)
        self.ConvBN_1 = ConvBN(_w(512, w), _w(256, w), 1, 1)
        self.CSPLayer_1 = CSPLayer(2 * _w(256, w), _w(256, w), _d(3, d),
                                   shortcut=False)
        self.ConvBN_2 = ConvBN(_w(256, w), _w(256, w), 3, 2)
        self.CSPLayer_2 = CSPLayer(2 * _w(256, w), _w(512, w), _d(3, d),
                                   shortcut=False)
        self.ConvBN_3 = ConvBN(_w(512, w), _w(512, w), 3, 2)
        self.CSPLayer_3 = CSPLayer(2 * _w(512, w), _w(1024, w), _d(3, d),
                                   shortcut=False)

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = self.ConvBN_0(c5)
        x = self.CSPLayer_0(torch.cat([_up(p5), c4], dim=1))
        p4 = self.ConvBN_1(x)
        n3 = self.CSPLayer_1(torch.cat([_up(p4), c3], dim=1))
        x = torch.cat([self.ConvBN_2(n3), p4], dim=1)
        n4 = self.CSPLayer_2(x)
        x = torch.cat([self.ConvBN_3(n4), p5], dim=1)
        return n3, n4, self.CSPLayer_3(x)


class Predictor(nn.Conv2d):
    """A head's 1x1 predictor with bias: an ``nn.Conv2d`` (its parameters,
    names and int8 wrapping are a convolution's) computed as a product over
    the channels of the NHWC view, so its output keeps the channels-last
    layout whatever its width: cuDNN would write the one-channel
    objectness map NCHW and transpose it."""

    def __init__(self, cin: int, features: int):
        super().__init__(cin, features, 1)

    def forward(self, x):
        y = F.linear(x.permute(0, 2, 3, 1), self.weight.flatten(1),
                     self.bias)
        return y.permute(0, 3, 1, 2)


class DecoupledHead(nn.Module):
    """Per level: 1x1 stem, two 3x3 convs each for the class and the
    regression branch, then 1x1 predictors (cls, box, obj) with bias."""

    def __init__(self, num_classes: int, width: float):
        super().__init__()
        hidden = _w(256, width)
        in_chs = (_w(256, width), _w(512, width), _w(1024, width))
        for lvl, cin in enumerate(in_chs):
            c, p = 5 * lvl, 3 * lvl
            self.add_module(f"ConvBN_{c}", ConvBN(cin, hidden, 1, 1))
            for k in range(1, 5):
                self.add_module(f"ConvBN_{c + k}",
                                ConvBN(hidden, hidden, 3, 1))
            self.add_module(f"Conv_{p}", Predictor(hidden, num_classes))
            self.add_module(f"Conv_{p + 1}", Predictor(hidden, 4))
            self.add_module(f"Conv_{p + 2}", Predictor(hidden, 1))

    def forward(self, feats):
        """[B, C, H, W] features -> per-level raw maps [B, H, W, 5 + C]
        (NHWC, the JAX layout ``decode_outputs`` flattens), contiguous;
        from channels-last predictions the permutes are free views."""
        m = lambda name: getattr(self, name)  # noqa: E731
        outs = []
        for lvl, f in enumerate(feats):
            c, p = 5 * lvl, 3 * lvl
            x = m(f"ConvBN_{c}")(f)
            cls = m(f"ConvBN_{c + 2}")(m(f"ConvBN_{c + 1}")(x))
            reg = m(f"ConvBN_{c + 4}")(m(f"ConvBN_{c + 3}")(x))
            preds = (m(f"Conv_{p + 1}")(reg), m(f"Conv_{p + 2}")(reg),
                     m(f"Conv_{p}")(cls))
            outs.append(torch.cat([t.permute(0, 2, 3, 1) for t in preds],
                                  dim=-1))
        return outs


class YOLOX(nn.Module):
    """images [B, H, W, 3] raw BGR -> (boxes_tlbr [B, A, 4], scores
    [B, A, C]); A = sum over strides of H/s * W/s (6300 at 480x640)."""

    def __init__(self, num_classes: int = 4, depth: float = 1.33,
                 width: float = 1.25):
        super().__init__()
        self.num_classes = num_classes
        self.CSPDarknet_0 = CSPDarknet(depth, width)
        self.PAFPN_0 = PAFPN(depth, width)
        self.DecoupledHead_0 = DecoupledHead(num_classes, width)

    def forward(self, images: torch.Tensor):
        dtype = self.CSPDarknet_0.Focus_0.Conv_0.weight.dtype
        x = images.permute(0, 3, 1, 2).to(dtype)
        outs = self.DecoupledHead_0(self.PAFPN_0(self.CSPDarknet_0(x)))
        return decode_outputs(outs, self.num_classes)


def decode_outputs(level_outputs: Sequence[torch.Tensor],
                   num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level raw maps [B, H, W, 5 + C] -> boxes [B, A, 4] and class
    scores [B, A, C]: xy = (pred + grid) * stride, wh = exp(pred) *
    stride with the exponent clamped at 20 (garbage logits stay finite),
    score = sigmoid(obj) * sigmoid(cls). Anchors flatten level by level,
    row-major over (h, w)."""
    boxes, scores = [], []
    for out, stride in zip(level_outputs, STRIDES):
        b, h, w, _ = out.shape
        out = out.float()
        gy = torch.arange(h, dtype=torch.float32, device=out.device)[:, None]
        gx = torch.arange(w, dtype=torch.float32, device=out.device)[None, :]
        cx = (out[..., 0] + gx) * stride
        cy = (out[..., 1] + gy) * stride
        bw = torch.exp(torch.clamp(out[..., 2], max=20.0)) * stride
        bh = torch.exp(torch.clamp(out[..., 3], max=20.0)) * stride
        tlbr = torch.stack(
            [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
        obj = torch.sigmoid(out[..., 4:5])
        cls = torch.sigmoid(out[..., 5:])
        boxes.append(tlbr.reshape(b, h * w, 4))
        scores.append((obj * cls).reshape(b, h * w, num_classes))
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)
