"""Batched crop-and-resize (port of botsort_tpu/ops/crop.py): kernel K7.

cv2.resize INTER_LINEAR on an integer-cropped region: half-pixel-aligned
source coordinates ``src = (dst + 0.5) * region / out - 0.5``, clamped to
the region and then to the image, two taps per axis. The JAX package
computes it as two one-hot-matrix contractions shaped for the TPU's matrix
unit; here each output pixel gathers its four source taps directly, which
touches only the pixels the output reads.

Three modes, the JAX package's three numerics (``PipelineConfig.
compute_dtype`` and ``crop_int8``; ``crop_mode`` picks one as the JAX
frame step's ``_crop`` does):

- ``float32``: each output pixel lerps along x on both tap rows, then
  along y, in float32 (``crop_and_resize_batched``; the JAX float32
  contraction's values up to float32 rounding).
- ``bfloat16``: JAX's ``crop_and_resize(compute_dtype=bfloat16)``. Pixels
  and weights round to bfloat16; the x phase sums the two products in
  float32 and stores bfloat16, ``t = bf16(bf16(1-wx) p0 + bf16(wx) p1)``;
  the y phase is ``bf16(1-wy) t0 + bf16(wy) t1`` in float32.
- ``int8``: JAX's ``crop_and_resize_int8`` (uint8 frames only). The x
  weights round to q / 127, ``q = round(127 wx)`` half to even, and the x
  phase is the integer ``acc = (127-q)(p0-128) + q(p1-128)``, stored as
  ``bf16((acc + 16256) / 127)``; the y phase as in bfloat16.

Where the two taps of an axis are one pixel (the image's last row or
column), the JAX one-hot rows sum the two weights before the cast, so the
single weight is ``bf16((1-w) + w)`` (``127`` in int8). The bfloat16 and
int8 modes reproduce the jitted JAX functions bit for bit
(tests/test_torch_crop.py). Every mode returns float32, and zeros for
degenerate boxes (w or h < 1).

A CUDA tensor launches kernel K7 (csrc/crop_resize.cu,
``crop_resize_cuda``) in every mode, one launch that computes the sample
grid too; a CPU tensor takes ``crop_resize_plain``; any other device
raises. The two are the CUDA and CPU implementations of the custom op
``torch.ops.botsort_tpu_torch.crop_resize``, which a trace reaches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from botsort_tpu_torch.runtime import kernels
from botsort_tpu_torch.utils.consts import const, tracing

MODES = ("float32", "bfloat16", "int8")
_FRAME_DTYPES = {torch.uint8: 0, torch.float32: 1}
THREADS = 256  # output pixels a block of K7
MAX_GRID_YZ = 65535


def _recip(n: int) -> float:
    """1 / n rounded to float32 (a Python float that float32 holds
    exactly)."""
    return float(np.float32(1.0) / np.float32(n))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as an FMA gives it."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


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
    # ``y1 + gy * (h / out_h)`` as XLA compiles it in the JAX package's
    # jitted steps: the division by a constant becomes a product with its
    # float32 reciprocal, and the product and the sum contract into one
    # FMA. Emulated in float64, where the float32 product is exact.
    sy = _fma(gy, h * _recip(out_h), y1) - 0.5
    sx = _fma(gx, w * _recip(out_w), x1) - 0.5
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


def _taps(images, y0, x0, y1i, x1i):
    """The four source taps of every output pixel, [B, N, oh, ow, 3] in
    the frames' dtype: (p00, p01, p10, p11), row first."""
    frame = torch.arange(images.shape[0],
                         device=images.device)[:, None, None, None]
    rows = (y0[..., :, None], y1i[..., :, None])
    cols = (x0[..., None, :], x1i[..., None, :])
    return tuple(images[frame, r, c] for r in rows for c in cols)


def crop_and_resize_batched(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                            out_hw: Tuple[int, int]) -> torch.Tensor:
    """The float32 mode's plain version. B frames at once, each with its
    own boxes: images [B, H, W, 3] (any dtype); boxes [B, N, 4] tlbr pixel
    corners -> [B, N, out_h, out_w, 3] float32. Each output pixel lerps
    along x on both tap rows, then along y."""
    y0, x0, y1i, x1i, wy, wx, good = _sample_grid(
        (images.shape[1], images.shape[2]), boxes_tlbr, out_hw)
    p00, p01, p10, p11 = (p.to(torch.float32)
                          for p in _taps(images, y0, x0, y1i, x1i))
    wx_c = wx[..., None, :, None]
    wy_c = wy[..., :, None, None]
    top = p00 + wx_c * (p01 - p00)
    bot = p10 + wx_c * (p11 - p10)
    out = top + wy_c * (bot - top)
    return torch.where(good[..., None, None, None], out,
                       torch.zeros_like(out))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _pair_weights(w, edge):
    """The bfloat16 weights (of tap 0, of tap 1) of one axis, as float32:
    bf16(1-w) and bf16(w), or bf16((1-w)+w) and 0 where the two taps are
    one pixel."""
    w0 = 1.0 - w
    return (_bf16(torch.where(edge, w0 + w, w0)),
            _bf16(torch.where(edge, torch.zeros_like(w), w)))


def _crop_low(images, boxes_tlbr, out_hw, mode):
    """The bfloat16 and int8 modes' plain version (see the module
    docstring): the same float32 and integer operations as kernel K7, in
    the same order."""
    y0, x0, y1i, x1i, wy, wx, good = _sample_grid(
        (images.shape[1], images.shape[2]), boxes_tlbr, out_hw)
    p00, p01, p10, p11 = _taps(images, y0, x0, y1i, x1i)
    edge_x = x0 == x1i
    if mode == "int8":
        q = torch.round(wx * 127.0).to(torch.int32)
        w0 = torch.where(edge_x, 127, 127 - q)[..., None, :, None]
        w1 = torch.where(edge_x, 0, q)[..., None, :, None]
        # A tensor divisor: a CUDA division by a host scalar multiplies by
        # its reciprocal, which rounds differently.
        d127 = const(127.0, torch.float32, images.device)

        def x_phase(p0, p1):
            acc = w0 * (p0.to(torch.int32) - 128) + \
                w1 * (p1.to(torch.int32) - 128)
            return _bf16((acc.to(torch.float32) + 16256.0) / d127)
    else:
        a0, a1 = (a[..., None, :, None] for a in _pair_weights(wx, edge_x))

        def x_phase(p0, p1):
            return _bf16(a0 * _bf16(p0.to(torch.float32))
                         + a1 * _bf16(p1.to(torch.float32)))
    t0 = x_phase(p00, p01)
    t1 = x_phase(p10, p11)
    b0, b1 = (b[..., :, None, None] for b in _pair_weights(wy, y0 == y1i))
    out = b0 * t0 + b1 * t1
    return torch.where(good[..., None, None, None], out,
                       torch.zeros_like(out))


def _check_mode(mode: str, frame_dtype: torch.dtype) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown crop mode {mode!r}; expected one of "
                         f"{MODES}")
    if mode == "int8" and frame_dtype != torch.uint8:
        raise ValueError(f"the int8 crop takes uint8 frames, got "
                         f"{frame_dtype}")


def crop_resize_plain(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                      out_hw: Tuple[int, int], mode: str = "float32"
                      ) -> torch.Tensor:
    """K7's plain version: images [B, H, W, 3], boxes [B, N, 4] ->
    [B, N, out_h, out_w, 3] float32 in ``mode`` (``MODES``)."""
    _check_mode(mode, images.dtype)
    if mode == "float32":
        return crop_and_resize_batched(images, boxes_tlbr, out_hw)
    return _crop_low(images, boxes_tlbr, out_hw, mode)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("crop_resize")
    fn = lib.crop_resize_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def crop_resize_cuda(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                     out_hw: Tuple[int, int], mode: str = "float32"
                     ) -> torch.Tensor:
    """K7: ``crop_resize_plain`` on the card. images [B, H, W, 3] uint8
    (or float32, not in int8 mode) contiguous and boxes [B, N, 4] on one
    CUDA device -> [B, N, out_h, out_w, 3] float32. One launch on the
    current stream (the kernel computes ``_sample_grid``'s taps itself);
    nothing is synchronised. ``crop_resize_cuda.launches`` counts
    launches."""
    if not images.is_cuda:
        raise ValueError("crop_resize_cuda takes CUDA tensors; the plain "
                         "version is crop_resize_plain")
    if images.dtype not in _FRAME_DTYPES:
        raise ValueError(f"frames have dtype {images.dtype}, expected uint8 "
                         "or float32")
    _check_mode(mode, images.dtype)
    if images.dim() != 4 or images.shape[3] != 3 or images.numel() < 1:
        raise ValueError(f"frames must be a non-empty [B, H, W, 3], got "
                         f"{tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("frames must be contiguous")
    bsz, img_h, img_w = images.shape[:3]
    if boxes_tlbr.device != images.device or boxes_tlbr.dim() != 3 or \
            tuple(boxes_tlbr.shape[::2]) != (bsz, 4) or \
            not boxes_tlbr.is_floating_point():
        raise ValueError(f"boxes must be a floating [{bsz}, N, 4] on "
                         f"{images.device}, got {tuple(boxes_tlbr.shape)} "
                         f"{boxes_tlbr.dtype} on {boxes_tlbr.device}")
    out_h, out_w = (int(v) for v in out_hw)
    n = boxes_tlbr.shape[1]
    out = torch.empty((bsz, n, out_h, out_w, 3), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out
    if out_h < 1 or out_w < 1 or n > MAX_GRID_YZ or bsz > MAX_GRID_YZ or \
            images.numel() >= 2 ** 31:
        raise ValueError(f"no K7 launch for frames {tuple(images.shape)}, "
                         f"{n} boxes, output {out_h}x{out_w}")
    boxes = boxes_tlbr.to(torch.float32).contiguous()
    values = (bsz, n, img_h, img_w, out_h, out_w, MODES.index(mode),
              _FRAME_DTYPES[images.dtype], THREADS)
    params = (ctypes.c_int * len(values))(*values)
    with torch.cuda.device(images.device):
        rc = _lib().crop_resize_launch(
            images.data_ptr(), boxes.data_ptr(), out.data_ptr(), params,
            kernels.current_stream(images.device))
    if rc != 0:
        raise RuntimeError(f"crop_resize launch failed: CUDA error {rc}")
    crop_resize_cuda.launches += 1
    return out


crop_resize_cuda.launches = 0


@torch.library.custom_op("botsort_tpu_torch::crop_resize", mutates_args=(),
                        device_types="cpu")
def crop_resize_op(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                   out_h: int, out_w: int, mode: str) -> torch.Tensor:
    """K7 as a custom op: the plain version on the CPU, the kernel on the
    card (registered below)."""
    return crop_resize_plain(images, boxes_tlbr, (out_h, out_w), mode)


@crop_resize_op.register_kernel("cuda")
def _crop_resize_op_cuda(images, boxes_tlbr, out_h, out_w, mode):
    return crop_resize_cuda(images.contiguous(), boxes_tlbr, (out_h, out_w),
                            mode)


@crop_resize_op.register_fake
def _crop_resize_op_fake(images, boxes_tlbr, out_h, out_w, mode):
    _check_mode(mode, images.dtype)
    return images.new_empty((images.shape[0], boxes_tlbr.shape[1], out_h,
                             out_w, 3), dtype=torch.float32)


def crop_resize(images: torch.Tensor, boxes_tlbr: torch.Tensor,
                out_hw: Tuple[int, int], mode: str = "float32"
                ) -> torch.Tensor:
    """Crop-resize in ``mode``: CUDA tensors launch K7, CPU tensors take
    the plain version, any other device raises; under a trace, the custom
    op."""
    if tracing():
        return crop_resize_op(images, boxes_tlbr, int(out_hw[0]),
                              int(out_hw[1]), mode)
    if images.is_cuda:
        return crop_resize_cuda(images.contiguous(), boxes_tlbr, out_hw, mode)
    if images.device.type != "cpu":
        raise ValueError(f"crop_resize: no kernel for device {images.device}")
    return crop_resize_plain(images, boxes_tlbr, out_hw, mode)


def crop_mode(pipe_cfg, frame_dtype: torch.dtype) -> str:
    """The JAX frame step's ``_crop`` rule: int8 when ``crop_int8``, a
    bfloat16 ``compute_dtype`` and a uint8 frame; else ``compute_dtype``."""
    if pipe_cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"PipelineConfig.compute_dtype "
                         f"{pipe_cfg.compute_dtype!r}: the port interpolates "
                         "in float32 or bfloat16")
    if pipe_cfg.crop_int8 and pipe_cfg.compute_dtype == "bfloat16" and \
            frame_dtype == torch.uint8:
        return "int8"
    return pipe_cfg.compute_dtype


def _crop(frames: torch.Tensor, boxes_tlbr: torch.Tensor,
          out_hw: Tuple[int, int], pipe_cfg) -> torch.Tensor:
    """Every crop and resize of a step: frames [B, H, W, 3], boxes
    [B, N, 4] -> [B, N, out_h, out_w, 3] float32, in the mode the pipeline
    configuration gives (``crop_mode``)."""
    return crop_resize(frames, boxes_tlbr, out_hw,
                       crop_mode(pipe_cfg, frames.dtype))


def crop_and_resize(image: torch.Tensor, boxes_tlbr: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """One frame: image [H, W, 3]; boxes [N, 4] -> [N, out_h, out_w, 3]
    float32 (``crop_and_resize_batched`` at B = 1)."""
    return crop_and_resize_batched(image[None], boxes_tlbr[None], out_hw)[0]
