"""TransReID body ReID encoder (He et al., ICCV 2021, arXiv:2102.04378;
github.com/damo-cv/TransReID), at inference as the release's MSMT17
``vit_transreid_stride`` configuration runs it: ViT-B/16 on overlapping
patches (stride 12), a side-information (camera) embedding (SIE) and the
jigsaw patch module (JPM), giving an L2-normalised 3840-d embedding.

  crops [N, H, W, 3] ImageNet-normalised RGB (``fastreid.preprocess``)
    -> TransReID's own pixels, (rgb - 0.5) / 0.5
    -> patch embedding: Conv2d 16x16 stride 12 (21 x 10 = 210 patches at
       256x128), class token first, + position table + sie_coe x the
       camera's SIE row
    -> ``depth - 1`` pre-LN blocks (12-head attention, GELU MLP)
    -> global branch ``b1`` (a block, then a LayerNorm): the class token
    -> jigsaw branch ``b2`` (a block of its own, then a LayerNorm): the
       patch tokens shifted by ``shift``, shuffled over ``groups`` and cut
       into ``divide`` groups, each run with the class token; each group's
       class token / ``divide``
    -> cat(global, 4 locals) (the neck feature "before": the BNNecks are
       unused at inference), L2-normalised.

The published base holds a twelfth block that inference never runs (the
branches are copies of it); it is not held here. Child names are the
release's (``patch_embed.proj``, ``blocks.<i>.attn.qkv``, ``b1.0``, ...,
its ``base.`` prefix dropped), so a state dict of the release maps onto
them by name.

Precision: the patch embedding and every dense layer run in the model's
compute dtype (``cast_compute``: bfloat16 on the card); the residual
stream, the LayerNorms (float32 parameters) and the tables are float32.
Attention is ``F.scaled_dot_product_attention`` in the compute dtype
(a fused attention kernel on the card, captured in the step's CUDA graph
like any other). The shift and shuffle are one precomputed index
(``jpm_index``) and one gather, and the four groups go through ``b2`` as
one batch of 4N sequences.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from botsort_tpu_torch.models.fastreid import IMAGENET_MEAN, IMAGENET_STD
from botsort_tpu_torch.utils.consts import const

# TransReID's own input normalisation (PIXEL_MEAN = PIXEL_STD = 0.5).
PIXEL_MEAN = 0.5
PIXEL_STD = 0.5
LN_EPS = 1e-6


def patch_grid(input_hw: Sequence[int], patch: int, stride: int
               ) -> Tuple[int, int]:
    """(rows, columns) of overlapping patches of an input."""
    return tuple((s - patch) // stride + 1 for s in input_hw)


def jpm_index(patches: int, shift: int = 5, groups: int = 2,
              divide: int = 4) -> Tuple[Tuple[int, ...], ...]:
    """The token indices (into [class token, patch 0, ..., patch P-1]) of
    each of the ``divide`` jigsaw groups, the class token first: the
    release's ``shuffle_unit`` (shift: tokens ``shift``.. then 1..shift-1;
    shuffle: viewed as ``groups`` rows and read column by column, after
    repeating the second-to-last token where the count does not divide),
    then ``P // divide`` tokens a group; tokens past ``divide`` groups are
    dropped."""
    order = list(range(shift, patches + 1)) + list(range(1, shift))
    if len(order) % groups:
        order.append(order[-2])
    if len(order) % groups:
        raise ValueError(f"{patches} patches do not shuffle into {groups} "
                         "groups")
    n = len(order) // groups
    shuffled = [order[g * n + i] for i in range(n) for g in range(groups)]
    length = patches // divide
    return tuple((0,) + tuple(shuffled[j * length:(j + 1) * length])
                 for j in range(divide))


class PatchEmbed(nn.Module):
    """Overlapping patches: one strided convolution, then the patches in
    row order as tokens."""

    def __init__(self, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride)

    def forward(self, x):                                   # [N, 3, H, W]
        return self.proj(x).flatten(2).transpose(1, 2)      # [N, P, C]


class Attention(nn.Module):
    """Multi-head self-attention: qkv, softmax(q k^T / sqrt(d)) v, proj."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):                                   # [N, T, C]
        n, t, c = x.shape
        qkv = self.qkv(x).view(n, t, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                # [N, h, T, d]
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(n, t, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN transformer block on a float32 residual stream: each
    LayerNorm in float32, its output cast to the compute dtype for the
    dense layers."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        dtype = self.attn.qkv.weight.dtype
        x = x + self.attn(self.norm1(x).to(dtype))
        return x + self.mlp(self.norm2(x).to(dtype))


def _branch(dim: int, heads: int, mlp_ratio: int) -> nn.Sequential:
    """A copy of the last block followed by a LayerNorm (``b1``, ``b2``)."""
    return nn.Sequential(Block(dim, heads, mlp_ratio),
                         nn.LayerNorm(dim, eps=LN_EPS))


class TransReID(nn.Module):
    """images [N, H, W, 3] ImageNet-normalised RGB -> [N, (1 + divide) x
    embed_dim] float32 L2-normalised embeddings. ``input_hw`` fixes the
    position table's length; ``camera`` is the SIE row every crop takes
    (a tracker's cameras are not the training set's)."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 heads: int = 12, mlp_ratio: int = 4, patch: int = 16,
                 stride: int = 12, input_hw: Sequence[int] = (256, 128),
                 cameras: int = 15, camera: int = 0, sie_coe: float = 3.0,
                 shift: int = 5, groups: int = 2, divide: int = 4):
        super().__init__()
        if not 0 <= camera < cameras:
            raise ValueError(f"camera {camera} not in [0, {cameras})")
        self.input_hw = tuple(input_hw)
        rows, cols = patch_grid(input_hw, patch, stride)
        self.patches = rows * cols
        self.camera = camera
        self.sie_coe = sie_coe
        self.divide = divide
        self.jpm = jpm_index(self.patches, shift, groups, divide)
        self.feature_dim = embed_dim * (1 + divide)
        self.patch_embed = PatchEmbed(embed_dim, patch, stride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + self.patches, embed_dim))
        self.sie_embed = nn.Parameter(torch.zeros(cameras, 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, heads, mlp_ratio)
                                    for _ in range(depth - 1))
        self.b1 = _branch(embed_dim, heads, mlp_ratio)
        self.b2 = _branch(embed_dim, heads, mlp_ratio)

    def draw_tables_(self, rng) -> None:
        """The class token, position table and SIE rows drawn normal x 0.02
        from the numpy generator ``rng`` (runtime/assets.py's seeded
        init), and every LayerNorm at scale 1, bias 0."""
        with torch.no_grad():
            for t in (self.cls_token, self.pos_embed, self.sie_embed):
                draw = rng.standard_normal(tuple(t.shape), np.float32)
                t.copy_(torch.from_numpy(draw * np.float32(0.02)))
            for m in self.modules():
                if isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self.patch_embed.proj.weight.dtype
        dev = images.device
        # x * std_in + mean_in is the crop's RGB in [0, 1]; then TransReID's
        # (rgb - 0.5) / 0.5, folded into one scale and shift a channel.
        scale = const(tuple(s / PIXEL_STD for s in IMAGENET_STD),
                      torch.float32, dev)
        offset = const(tuple((m - PIXEL_MEAN) / PIXEL_STD
                             for m in IMAGENET_MEAN), torch.float32, dev)
        x = images.float() * scale + offset
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(dtype))
        n, _, c = x.shape
        x = torch.cat([self.cls_token.expand(n, -1, -1), x.float()], dim=1)
        x = x + (self.pos_embed + self.sie_coe * self.sie_embed[self.camera])
        for block in self.blocks:
            x = block(x)
        # The branches' LayerNorms act token by token: only the class
        # tokens are normalised.
        glob = self.b1[1](self.b1[0](x)[:, 0])
        idx = const(sum(self.jpm, ()), torch.long, dev)
        groups = x.index_select(1, idx).view(n * self.divide, -1, c)
        local = self.b2[1](self.b2[0](groups)[:, 0]) / self.divide
        feat = torch.cat([glob, local.view(n, -1)], dim=1)
        norm = torch.linalg.norm(feat, dim=-1, keepdim=True)
        return feat / torch.clamp(norm, min=1e-12)


def refuse(model: nn.Module, what: str) -> None:
    """Raise NotImplementedError naming ``what`` where ``model`` is a
    TransReID encoder: a path written for the convolutional families."""
    if isinstance(model, TransReID):
        raise NotImplementedError(
            f"{what} is written for the convolutional encoders and does not "
            "take the TransReID body encoder")
