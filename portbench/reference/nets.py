"""The plain PyTorch classes of the port's networks: YOLOX, FastReID SBS
(ResNeSt trunk) and the MobileNetV2 face encoder, float32 throughout.

A frozen copy of the port's model files, with their Flax-style child
names, so that one state dict loads into both, with every norm a plain
float32 batch norm and no kernel, fused stem or cache. A configuration's
``models`` entry names the class and its arguments (portbench/networks.py);
nothing here lists architectures. Each convolution and dense layer is a
``QConv2d`` / ``QLinear``: at ``precision = "float32"`` (the default) a
plain layer; at ``"fp8"`` its input, weight and output are rounded to
float8 e4m3 with one scale per tensor around the float32 product, which is
the benchmark's control (``set_precision``). A family of its own in
another file of this folder uses these layers, and puts any product of
two activations in a module with a ``precision`` attribute of its own.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

PRECISIONS = ("float32", "fp8")
FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to 448), returned in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class QConv2d(nn.Conv2d):
    precision = "float32"

    def forward(self, x):
        if self.precision == "fp8":
            r = fp8_round
            return r(self._conv_forward(r(x), r(self.weight), self.bias))
        return super().forward(x)


class QLinear(nn.Linear):
    precision = "float32"

    def forward(self, x):
        if self.precision == "fp8":
            r = fp8_round
            return r(F.linear(r(x), r(self.weight), self.bias))
        return super().forward(x)


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    """``precision`` on every module of ``model`` that has the attribute:
    QConv2d, QLinear, and any module of another family that rounds its
    products of two activations under it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    for m in model.modules():
        if hasattr(m, "precision"):
            m.precision = precision
    return model


class BatchNorm(nn.Module):
    """Batch norm with running statistics, then an activation:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, act: str = "none"):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        y = y + self.bias.view(shape)
        if act == "silu":
            return F.silu(y)
        if act == "relu":
            return F.relu(y)
        if act == "relu6":
            return torch.clamp(y, 0.0, 6.0)
        return y


def conv2d(cin, cout, kernel, stride=1, groups=1, bias=False) -> QConv2d:
    return QConv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                   groups=groups, bias=bias)


# --------------------------------------------------------------- YOLOX-X

STRIDES = (8, 16, 32)


class ConvBN(nn.Module):
    def __init__(self, cin, features, kernel=3, stride=1, groups=1,
                 act=True):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups)
        self.BatchNorm_0 = BatchNorm(features, 1e-3)
        self.act = act

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x),
                                "silu" if self.act else "none")


class Bottleneck(nn.Module):
    def __init__(self, cin, features, shortcut=True, expansion=0.5):
        super().__init__()
        hidden = int(features * expansion)
        self.ConvBN_0 = ConvBN(cin, hidden, 1, 1)
        self.ConvBN_1 = ConvBN(hidden, features, 3, 1)
        self.use_add = shortcut and cin == features

    def forward(self, x):
        y = self.ConvBN_1(self.ConvBN_0(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    def __init__(self, cin, features, n=1, shortcut=True, expansion=0.5):
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
    def __init__(self, cin, features, kernels: Sequence[int] = (5, 9, 13)):
        super().__init__()
        hidden = cin // 2
        self.ConvBN_0 = ConvBN(cin, hidden, 1, 1)
        self.kernels = tuple(kernels)
        self.ConvBN_1 = ConvBN(hidden * (len(kernels) + 1), features, 1, 1)

    def forward(self, x):
        x = self.ConvBN_0(x)
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.kernels]
        return self.ConvBN_1(torch.cat(pools, dim=1))


class Focus(nn.Module):
    """The space-to-depth stem folded into one 6x6 stride-2 conv."""

    def __init__(self, cin, features):
        super().__init__()
        self.Conv_0 = QConv2d(cin, features, 6, 2, 2, bias=False)
        self.BatchNorm_0 = BatchNorm(features, 1e-3)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x), "silu")


def _d(n, depth):
    return max(round(n * depth), 1)


def _w(c, width):
    return int(c * width)


class CSPDarknet(nn.Module):
    def __init__(self, depth, width):
        super().__init__()
        d, w = depth, width
        self.Focus_0 = Focus(3, _w(64, w))
        self.ConvBN_0 = ConvBN(_w(64, w), _w(128, w), 3, 2)
        self.CSPLayer_0 = CSPLayer(_w(128, w), _w(128, w), _d(3, d))
        self.ConvBN_1 = ConvBN(_w(128, w), _w(256, w), 3, 2)
        self.CSPLayer_1 = CSPLayer(_w(256, w), _w(256, w), _d(9, d))
        self.ConvBN_2 = ConvBN(_w(256, w), _w(512, w), 3, 2)
        self.CSPLayer_2 = CSPLayer(_w(512, w), _w(512, w), _d(9, d))
        self.ConvBN_3 = ConvBN(_w(512, w), _w(1024, w), 3, 2)
        self.SPPBottleneck_0 = SPPBottleneck(_w(1024, w), _w(1024, w))
        self.CSPLayer_3 = CSPLayer(_w(1024, w), _w(1024, w), _d(3, d),
                                   shortcut=False)

    def forward(self, x):
        x = self.CSPLayer_0(self.ConvBN_0(self.Focus_0(x)))
        c3 = self.CSPLayer_1(self.ConvBN_1(x))
        c4 = self.CSPLayer_2(self.ConvBN_2(c3))
        x = self.SPPBottleneck_0(self.ConvBN_3(c4))
        return c3, c4, self.CSPLayer_3(x)


def _up(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class PAFPN(nn.Module):
    def __init__(self, depth, width):
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


class DecoupledHead(nn.Module):
    def __init__(self, num_classes, width):
        super().__init__()
        hidden = _w(256, width)
        in_chs = (_w(256, width), _w(512, width), _w(1024, width))
        for lvl, cin in enumerate(in_chs):
            c, p = 5 * lvl, 3 * lvl
            self.add_module(f"ConvBN_{c}", ConvBN(cin, hidden, 1, 1))
            for k in range(1, 5):
                self.add_module(f"ConvBN_{c + k}",
                                ConvBN(hidden, hidden, 3, 1))
            self.add_module(f"Conv_{p}", QConv2d(hidden, num_classes, 1))
            self.add_module(f"Conv_{p + 1}", QConv2d(hidden, 4, 1))
            self.add_module(f"Conv_{p + 2}", QConv2d(hidden, 1, 1))

    def forward(self, feats):
        m = lambda name: getattr(self, name)  # noqa: E731
        outs = []
        for lvl, f in enumerate(feats):
            c, p = 5 * lvl, 3 * lvl
            x = m(f"ConvBN_{c}")(f)
            cls = m(f"ConvBN_{c + 2}")(m(f"ConvBN_{c + 1}")(x))
            reg = m(f"ConvBN_{c + 4}")(m(f"ConvBN_{c + 3}")(x))
            out = torch.cat([m(f"Conv_{p + 1}")(reg), m(f"Conv_{p + 2}")(reg),
                             m(f"Conv_{p}")(cls)], dim=1)
            outs.append(out.permute(0, 2, 3, 1))
        return outs


class YOLOX(nn.Module):
    """images [B, H, W, 3] raw BGR 0..255 -> (boxes tlbr [B, A, 4] in input
    pixels, obj * cls scores [B, A, C])."""

    def __init__(self, num_classes=4, depth=1.33, width=1.25):
        super().__init__()
        self.num_classes = num_classes
        self.CSPDarknet_0 = CSPDarknet(depth, width)
        self.PAFPN_0 = PAFPN(depth, width)
        self.DecoupledHead_0 = DecoupledHead(num_classes, width)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).float()
        outs = self.DecoupledHead_0(self.PAFPN_0(self.CSPDarknet_0(x)))
        return decode_outputs(outs, self.num_classes)


def decode_outputs(level_outputs, num_classes
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
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


# ------------------------------------------------------ FastReID SBS-S50

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _ConvBN(nn.Module):
    def __init__(self, cin, features, kernel=3, stride=1, groups=1,
                 act=True):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups)
        self.BatchNorm_0 = BatchNorm(features, 1e-5)
        self.act = act

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x),
                                "relu" if self.act else "none")


class SplAtConv(nn.Module):
    """Split-attention 3x3 convolution, radix 2, cardinality 1."""

    def __init__(self, cin, features, radix=2, reduction=4):
        super().__init__()
        c, r = features, radix
        inter = max(c * r // reduction, 32)
        self.radix = r
        self._ConvBN_0 = _ConvBN(cin, c * r, 3, 1, groups=r)
        self.Dense_0 = QLinear(c, inter)
        self.BatchNorm_0 = BatchNorm(inter, 1e-5)
        self.Dense_1 = QLinear(inter, c * r)

    def forward(self, x):
        x = self._ConvBN_0(x)
        b, _, h, w = x.shape
        r = self.radix
        splits = x.view(b, r, -1, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3))
        z = self.BatchNorm_0(self.Dense_0(gap), "relu")
        atten = torch.softmax(self.Dense_1(z).view(b, r, -1), dim=1)
        return (splits * atten[..., None, None]).sum(dim=1)


class SplAtBottleneck(nn.Module):
    def __init__(self, cin, width, stride=1, downsample=False):
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
            y = F.avg_pool2d(y, 3, self.stride, 1)
        y = self._ConvBN_1(y)
        s = x
        if self.downsample:
            if self.stride > 1:
                s = F.avg_pool2d(s, self.stride, self.stride)
            s = self._ConvBN_2(s)
        return F.relu(y + s)


class ResNeSt50(nn.Module):
    def __init__(self, stage_blocks=(3, 4, 6, 3),
                 stage_widths=(64, 128, 256, 512), stem_width=32):
        super().__init__()
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

    def forward(self, x):
        x = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.n_blocks):
            x = getattr(self, f"SplAtBottleneck_{i}")(x)
        return x


class GeMPool(nn.Module):
    def __init__(self, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.tensor(3.0))

    def forward(self, x):
        x = torch.clamp(x.float(), min=self.eps) ** self.p
        return x.mean(dim=(2, 3)) ** (1.0 / self.p)


class FastReIDSBS(nn.Module):
    """images [N, H, W, 3] normalised RGB -> [N, 2048] L2-normalised."""

    def __init__(self, feature_dim=2048, stage_blocks=(3, 4, 6, 3),
                 stage_widths=(64, 128, 256, 512), stem_width=32):
        super().__init__()
        # The published network's width, whatever ``feature_dim`` says, as
        # in the port's class.
        self.feature_dim = stage_widths[-1] * 4
        self.ResNeSt50_0 = ResNeSt50(stage_blocks, stage_widths, stem_width)
        self.GeMPool_0 = GeMPool()
        self.BatchNorm_0 = BatchNorm(stage_widths[-1] * 4, 1e-5)

    def forward(self, images):
        x = self.ResNeSt50_0(images.permute(0, 3, 1, 2).float())
        feat = self.BatchNorm_0(self.GeMPool_0(x))
        return feat / torch.clamp(torch.linalg.norm(feat, dim=-1,
                                                    keepdim=True), min=1e-12)


def preprocess(images_bgr):
    """BGR [N, H, W, 3] -> normalised RGB float32 (ImageNet mean/std)."""
    rgb = images_bgr.flip(-1).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    return (rgb - mean) / std


# ----------------------------------------------------------- face encoder

MOBILENETV2_LAYOUT = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                      (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                      (6, 320, 1, 1))


class _ConvBNRelu6(nn.Module):
    def __init__(self, cin, features, kernel=3, stride=1, groups=1,
                 act=True):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups)
        self.BatchNorm_0 = BatchNorm(features, 1e-5)
        self.act = act

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x),
                                "relu6" if self.act else "none")


class InvertedResidual(nn.Module):
    def __init__(self, cin, features, stride=1, expand=6):
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
    """images [N, H, W, 3] raw BGR -> [N, 256] L2-normalised."""

    def __init__(self, feature_dim=256, layout=MOBILENETV2_LAYOUT,
                 head_width=1280):
        super().__init__()
        self.feature_dim = feature_dim
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
        self.Dense_0 = QLinear(head_width, feature_dim)

    def forward(self, images):
        x = self._ConvBNRelu6_0(images.permute(0, 3, 1, 2).float())
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = self._ConvBNRelu6_1(x).mean(dim=(2, 3))
        feat = self.Dense_0(x)
        return feat / torch.clamp(torch.linalg.norm(feat, dim=-1,
                                                    keepdim=True), min=1e-12)
