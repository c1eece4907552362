"""Batched crop-and-resize (port of botsort_tpu/ops/crop.py).

cv2.resize INTER_LINEAR on an integer-cropped region: half-pixel-aligned
source coordinates ``src = (dst + 0.5) * region / out - 0.5``, clamped to
the region and then to the image, two taps per axis. The JAX package's
default is a one-hot-matrix contraction shaped for the TPU's matrix unit;
here each output pixel gathers its four source taps directly (the JAX
package's ``crop_and_resize_gather``), which touches only the pixels the
output reads.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sample_grid(img_hw: Tuple[int, int], boxes_tlbr: torch.Tensor,
                 out_hw: Tuple[int, int]):
    """(y0, x0, y1i, x1i, wy, wx, good): two integer taps per output
    row/col [..., N, out], their fractional weights, and the per-box
    validity (w and h >= 1), for boxes [..., N, 4]."""
    img_h, img_w = img_hw
    out_h, out_w = out_hw
    boxes = boxes_tlbr.to(torch.float32)
    x1 = boxes[..., 0, None]
    y1 = boxes[..., 1, None]
    w = boxes[..., 2, None] - x1
    h = boxes[..., 3, None] - y1
    good = (w[..., 0] >= 1.0) & (h[..., 0] >= 1.0)
    dev = boxes.device
    gy = torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5
    gx = torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
    sy = y1 + gy * (h / out_h) - 0.5
    sx = x1 + gx * (w / out_w) - 0.5
    # cv2 clamps sampling to the cropped region, then to the image.
    sy = torch.minimum(torch.maximum(sy, y1), y1 + h - 1.0)
    sx = torch.minimum(torch.maximum(sx, x1), x1 + w - 1.0)
    sy = torch.clamp(sy, 0.0, img_h - 1.0)
    sx = torch.clamp(sx, 0.0, img_w - 1.0)
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    wy = sy - y0f
    wx = sx - x0f
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1i = torch.clamp(y0 + 1, max=img_h - 1)
    x1i = torch.clamp(x0 + 1, max=img_w - 1)
    return y0, x0, y1i, x1i, wy, wx, good


def crop_and_resize_batched(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                            out_hw: Tuple[int, int]) -> torch.Tensor:
    """B frames at once, each with its own boxes: images [B, H, W, 3]
    (any dtype); boxes [B, N, 4] tlbr pixel corners -> [B, N, out_h,
    out_w, 3] float32, one gather over all frames. Degenerate boxes (w or
    h < 1) give zeros. Interpolation runs in float32: each output pixel
    lerps along x on both tap rows, then along y."""
    y0, x0, y1i, x1i, wy, wx, good = _sample_grid(
        (images.shape[1], images.shape[2]), boxes_tlbr, out_hw)
    frame = torch.arange(images.shape[0],
                         device=images.device)[:, None, None, None]
    yy0 = y0[..., :, None]
    yy1 = y1i[..., :, None]
    xx0 = x0[..., None, :]
    xx1 = x1i[..., None, :]
    wx_c = wx[..., None, :, None]
    wy_c = wy[..., :, None, None]

    def tap(yi, xi):
        return images[frame, yi, xi].to(torch.float32)  # [B, N, oh, ow, 3]

    p00 = tap(yy0, xx0)
    top = p00 + wx_c * (tap(yy0, xx1) - p00)
    p10 = tap(yy1, xx0)
    bot = p10 + wx_c * (tap(yy1, xx1) - p10)
    out = top + wy_c * (bot - top)
    return torch.where(good[..., None, None, None], out,
                       torch.zeros_like(out))


def crop_and_resize(image: torch.Tensor, boxes_tlbr: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """One frame: image [H, W, 3]; boxes [N, 4] -> [N, out_h, out_w, 3]
    float32 (``crop_and_resize_batched`` at B = 1)."""
    return crop_and_resize_batched(image[None], boxes_tlbr[None], out_hw)[0]
