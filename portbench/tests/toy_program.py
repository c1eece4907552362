"""The toy body encoder of toy_reference.py, program side: the same
network and child names, so that one state dict loads into both, in plain
layers at the model's compute dtype. The CPU test of a new family makes it
importable as ``botsort_tpu_torch.models.toy_body``."""

import torch
from torch import nn


class ToyBody(nn.Module):
    """images [N, H, W, 3] normalised RGB -> [N, feature_dim] float32
    L2-normalised."""

    def __init__(self, width=96, patch=8, feature_dim=96):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, width, patch, patch)
        self.token = nn.Parameter(torch.empty(1, 1, width))
        self.LayerNorm_0 = nn.LayerNorm(width)
        self.Dense_0 = nn.Linear(width, 3 * width)
        self.Dense_1 = nn.Linear(width, feature_dim)

    def forward(self, images):
        dtype = self.Conv_0.weight.dtype
        x = self.Conv_0(images.permute(0, 3, 1, 2).to(dtype)).float()
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.token.expand(x.shape[0], -1, -1), x], dim=1)
        x = self.LayerNorm_0(x)
        q, k, v = self.Dense_0(x.to(dtype)).float().chunk(3, dim=-1)
        a = torch.softmax(q @ k.transpose(1, 2) * q.shape[-1] ** -0.5, dim=-1)
        x = x + a @ v
        feat = self.Dense_1(x[:, 0].to(dtype)).float()
        return feat / torch.clamp(torch.linalg.norm(feat, dim=-1,
                                                    keepdim=True), min=1e-12)
