"""A toy body encoder of a family the benchmark does not know, reference
side: a patch embedding, a learned class token, a LayerNorm and one
self-attention, 96-d. The CPU test of a new family
(test_portbench_new_family.py) makes it importable as
``portbench.reference.toy_body`` and names it in a configuration.

It uses what a family brings: ``seed_`` for the tensors the seeded recipe
does not know (the LayerNorm, the token), and a module with a
``precision`` attribute and ``counted_flops`` for its products of two
activations (QK^T and PV)."""

import torch
from torch import nn

from portbench.reference.nets import QConv2d, QLinear, fp8_round


class Attention(nn.Module):
    """softmax(q k^T / sqrt(c)) v of [N, T, C] activations, rounded to
    float8 around each product at ``precision = "fp8"``."""

    precision = "float32"

    def forward(self, q, k, v):
        r = fp8_round if self.precision == "fp8" else (lambda t: t)
        a = torch.softmax(r(q) @ r(k).transpose(1, 2) * q.shape[-1] ** -0.5,
                          dim=-1)
        return r(r(a) @ r(v))

    def counted_flops(self, inputs, output):
        q, k, v = inputs
        n, t, c = q.shape
        return 2.0 * n * t * k.shape[1] * (c + v.shape[-1])


class ToyBody(nn.Module):
    """images [N, H, W, 3] normalised RGB -> [N, feature_dim]
    L2-normalised."""

    def __init__(self, width=96, patch=8, feature_dim=96):
        super().__init__()
        self.feature_dim = feature_dim
        self.Conv_0 = QConv2d(3, width, patch, patch)
        self.token = nn.Parameter(torch.empty(1, 1, width))
        self.LayerNorm_0 = nn.LayerNorm(width)
        self.Dense_0 = QLinear(width, 3 * width)
        self.Attention_0 = Attention()
        self.Dense_1 = QLinear(width, feature_dim)

    def seed_(self, generator):
        self.LayerNorm_0.weight.fill_(1.0)
        self.LayerNorm_0.bias.zero_()
        self.token.copy_(torch.randn(self.token.shape, generator=generator,
                                     device=self.token.device))

    def forward(self, images):
        x = self.Conv_0(images.permute(0, 3, 1, 2).float())
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.token.expand(x.shape[0], -1, -1), x], dim=1)
        x = self.LayerNorm_0(x)
        q, k, v = self.Dense_0(x).chunk(3, dim=-1)
        x = x + self.Attention_0(q, k, v)
        feat = self.Dense_1(x[:, 0])
        return feat / torch.clamp(torch.linalg.norm(feat, dim=-1,
                                                    keepdim=True), min=1e-12)
