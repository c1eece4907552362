"""Batched constant-velocity Kalman filter (port of botsort_tpu/ops/kalman.py).

The reference's 8x8 covariance never couples the four measured
coordinates, so each track stores four independent 2x2 blocks:
mean [N, 8] = (pos 0:4, vel 4:8) and cov [N, 4, 3] = (P_pp, P_pv, P_vv)
per coordinate (cx, cy, w, h). Every step is closed-form elementwise
arithmetic. Block-diagonality is an invariant of every op here.
"""

from __future__ import annotations

from typing import Tuple

import torch

STD_WEIGHT_POSITION = 1.0 / 20
STD_WEIGHT_VELOCITY = 1.0 / 160

# chi-square 0.95 quantiles for 1..9 degrees of freedom (Mahalanobis gate).
CHI2INV95 = (3.8415, 5.9915, 7.8147, 9.4877, 11.070, 12.592, 14.067,
             15.507, 16.919)


def _noise_scales(wh: torch.Tensor) -> torch.Tensor:
    """(w, h, w, h) for (cx, cy, w, h): [..., 2] -> [..., 4]."""
    w = wh[..., 0]
    h = wh[..., 1]
    return torch.stack([w, h, w, h], dim=-1)


def initiate(measurement_xywh: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 4] -> (mean [..., 8], cov [..., 4, 3]): zero velocity,
    diagonal covariance with stds 2*w_p*scale and 10*w_v*scale."""
    pos = measurement_xywh
    mean = torch.cat([pos, torch.zeros_like(pos)], dim=-1)
    s = _noise_scales(measurement_xywh[..., 2:4])
    std_p = 2.0 * STD_WEIGHT_POSITION * s
    std_v = 10.0 * STD_WEIGHT_VELOCITY * s
    a = std_p * std_p
    c = std_v * std_v
    cov = torch.stack([a, torch.zeros_like(a), c], dim=-1)
    return mean, cov


def predict(mean: torch.Tensor, cov: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p' = p + v; a' = a + 2b + c + q_p, b' = b + c, c' = c + q_v with
    the noise evaluated at the previous mean's (w, h)."""
    pos = mean[..., :4]
    vel = mean[..., 4:8]
    new_mean = torch.cat([pos + vel, vel], dim=-1)
    s = _noise_scales(mean[..., 2:4])
    q_p = torch.square(STD_WEIGHT_POSITION * s)
    q_v = torch.square(STD_WEIGHT_VELOCITY * s)
    a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
    new_cov = torch.stack([a + 2.0 * b + c + q_p, b + c, c + q_v], dim=-1)
    return new_mean, new_cov


def project(mean: torch.Tensor, cov: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(measurement mean [..., 4], innovation variance S [..., 4])."""
    s = _noise_scales(mean[..., 2:4])
    r = torch.square(STD_WEIGHT_POSITION * s)
    return mean[..., :4], cov[..., 0] + r


def update(mean: torch.Tensor, cov: torch.Tensor,
           measurement_xywh: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form correction: K_p = a/S, K_v = b/S; a+ = a - a^2/S,
    b+ = b - ab/S, c+ = c - b^2/S. S is floored at 1e-12 so a degenerate
    zero-size track updates to a no-op instead of NaN."""
    z_pred, s_innov = project(mean, cov)
    e = measurement_xywh - z_pred
    a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
    inv_s = 1.0 / torch.clamp(s_innov, min=1e-12)
    k_p = a * inv_s
    k_v = b * inv_s
    new_mean = torch.cat([mean[..., :4] + k_p * e, mean[..., 4:8] + k_v * e],
                         dim=-1)
    new_cov = torch.stack(
        [a - a * a * inv_s, b - a * b * inv_s, c - b * b * inv_s], dim=-1)
    return new_mean, new_cov


def gating_distance(mean: torch.Tensor, cov: torch.Tensor,
                    measurements_xywh: torch.Tensor,
                    only_position: bool = False) -> torch.Tensor:
    """Squared Mahalanobis distance of M measurements [..., M, 4] to each
    track: [..., M] (diagonal S makes it a weighted squared error)."""
    z_pred, s_innov = project(mean, cov)
    d = measurements_xywh - z_pred[..., None, :]
    w = 1.0 / torch.clamp(s_innov[..., None, :], min=1e-12)
    k = 2 if only_position else 4
    return (d[..., :k] * d[..., :k] * w[..., :k]).sum(dim=-1)


def apply_affine(mean: torch.Tensor, cov: torch.Tensor,
                 affine_2x3: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-motion compensation with a [..., 2, 3] affine (one per
    leading index of mean [..., N, 8] / cov [..., N, 4, 3]): R applied to
    all four (x, y) state pairs plus t on the position; the covariance
    takes the similarity scale s^2 = |det R| per block (the x/y-mixing
    rotation terms are dropped — the block form cannot hold them)."""
    r = affine_2x3[..., :, :2]
    t = affine_2x3[..., None, :, 2]
    s = torch.sqrt(torch.abs(r[..., 0, 0] * r[..., 1, 1]
                             - r[..., 0, 1] * r[..., 1, 0]))
    rt = r.transpose(-1, -2)
    new_mean = torch.cat([mean[..., 0:2] @ rt + t, mean[..., 2:4] @ rt,
                          mean[..., 4:6] @ rt, mean[..., 6:8] @ rt], dim=-1)
    return new_mean, cov * (s * s)[..., None, None, None]
