"""TransReID (He et al., ICCV 2021, arXiv:2102.04378;
github.com/damo-cv/TransReID), the plain float32 reference of the port's
``botsort_tpu_torch.models.transreid.TransReID``: ViT-B/16 on overlapping
patches (stride 12) with the camera embedding (SIE) and the jigsaw patch
module (JPM), written as the release's ``vit_pytorch.py`` and
``make_model.py::build_transformer_local`` compute it at inference, with
the same child names as the port's class so that one state dict loads
into both.

Float32 throughout; every convolution and dense layer a ``QConv2d`` /
``QLinear`` and attention's two products of activations in ``Products``,
so that ``nets.set_precision(model, "fp8")`` makes the whole network the
benchmark's float8 control. ``b1`` and ``b2`` run every row, as the release
does, but their output is read at the class token alone, so the count of
useful work (portbench/counts.py) leaves out the other rows' queries,
attention rows, ``proj`` and MLP (``Branch.counted_flops``). The jigsaw groups are cut as the release cuts
them (a shift by concatenation, a shuffle by view and transpose, one
slice a group) and run through ``b2`` one by one. The seeded recipe
(portbench/gen.py) draws the convolution and dense kernels; ``seed_``
writes the rest: LayerNorms at scale 1, bias 0, and the class token,
position table and SIE rows normal x 0.02.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.nets import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    QConv2d,
    QLinear,
    fp8_round,
)

TABLE_STD = 0.02


class Products(nn.Module):
    """softmax(q k^T * scale) v over [N, heads, T, d] activations, each
    product's inputs and output rounded to float8 at ``precision =
    "fp8"``."""

    precision = "float32"

    def forward(self, q, k, v):
        r = fp8_round if self.precision == "fp8" else (lambda t: t)
        attn = (r(q) @ r(k).transpose(-2, -1)) * q.shape[-1] ** -0.5
        attn = r(attn).softmax(dim=-1)
        return r(r(attn) @ r(v))

    def counted_flops(self, inputs, output):
        q, k, v = inputs
        n, h, t, d = q.shape
        return 2.0 * n * h * t * k.shape[2] * (d + v.shape[-1])


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, stride):
        super().__init__()
        self.proj = QConv2d(3, dim, patch, stride)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = QLinear(dim, 3 * dim)
        self.proj = QLinear(dim, dim)
        self.products = Products()

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        out = self.products(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = QLinear(dim, hidden)
        self.fc2 = QLinear(hidden, dim)

    def forward(self, x):
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Branch(nn.Sequential):
    """A block and a LayerNorm (``b1``, ``b2``) whose output is read at the
    class token alone. ``counted_flops`` takes off the work no output
    depends on: every other row's query, attention row, ``proj`` and MLP
    (the keys and values of every row stay)."""

    def counted_flops(self, inputs, output):
        n, t, c = inputs[0].shape
        hidden = self[0].mlp.fc1.out_features
        dense = 2.0 * c * (2 * c + 2 * hidden)  # q, proj, fc1, fc2 a row
        products = 4.0 * t * c  # a query row's QK^T and PV, all heads
        return -n * (t - 1) * (dense + products)


def shuffle_unit(features, shift, group, begin=1):
    """The release's shift and patch shuffle of [N, 1 + P, C] tokens
    (the class token dropped)."""
    b, _, c = features.shape
    x = torch.cat([features[:, begin - 1 + shift:],
                   features[:, begin:begin - 1 + shift]], dim=1)
    if x.shape[1] % group:
        x = torch.cat([x, x[:, -2:-1, :]], dim=1)
    x = x.view(b, group, -1, c).transpose(1, 2).contiguous()
    return x.view(b, -1, c)


class TransReID(nn.Module):
    """images [N, H, W, 3] ImageNet-normalised RGB -> [N, (1 + divide) x
    embed_dim] L2-normalised."""

    def __init__(self, embed_dim=768, depth=12, heads=12, mlp_ratio=4,
                 patch=16, stride=12, input_hw=(256, 128), cameras=15,
                 camera=0, sie_coe=3.0, shift=5, groups=2, divide=4):
        super().__init__()
        rows = (input_hw[0] - patch) // stride + 1
        cols = (input_hw[1] - patch) // stride + 1
        self.camera = camera
        self.sie_coe = sie_coe
        self.shift = shift
        self.groups = groups
        self.divide = divide
        self.feature_dim = embed_dim * (1 + divide)
        self.patch_embed = PatchEmbed(embed_dim, patch, stride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + rows * cols, embed_dim))
        self.sie_embed = nn.Parameter(torch.zeros(cameras, 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, heads, mlp_ratio)
                                    for _ in range(depth - 1))
        self.b1 = Branch(Block(embed_dim, heads, mlp_ratio),
                         nn.LayerNorm(embed_dim, eps=1e-6))
        self.b2 = Branch(Block(embed_dim, heads, mlp_ratio),
                         nn.LayerNorm(embed_dim, eps=1e-6))

    def seed_(self, generator):
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for t in (self.cls_token, self.pos_embed, self.sie_embed):
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=t.device) * TABLE_STD)

    def forward(self, images):
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        rgb = images.float() * std + mean
        x = ((rgb - 0.5) / 0.5).permute(0, 3, 1, 2)
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed + self.sie_coe * self.sie_embed[self.camera]
        for block in self.blocks:
            x = block(x)
        glob = self.b1(x)[:, 0]
        length = (x.shape[1] - 1) // self.divide
        token = x[:, 0:1]
        tokens = shuffle_unit(x, self.shift, self.groups)
        local = [self.b2(torch.cat(
            [token, tokens[:, j * length:(j + 1) * length]], dim=1))[:, 0]
            / self.divide for j in range(self.divide)]
        feat = torch.cat([glob] + local, dim=1)
        return feat / torch.clamp(torch.linalg.norm(feat, dim=-1,
                                                    keepdim=True), min=1e-12)
