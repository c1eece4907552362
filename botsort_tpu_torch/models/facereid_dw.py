"""The face encoder's stride-1 depthwise 3x3 as kernel K5 (port of
botsort_tpu/models/facereid_pallas.py).

``dw_conv3x3_same(x, kernel)`` takes NCHW activations (on the card a
channels-last x, the networks' layout there, is first copied to NCHW)
and the depthwise conv weight [C, 1, 3, 3] (the parameter
``nn.Conv2d(groups=C)`` holds, so a state dict serves every lowering).
A CUDA tensor launches K5, csrc/dw_conv3x3.cu, through
``dw_conv3x3_cuda``; a CPU tensor takes ``dw_conv3x3_plain``; any other
device raises. Both compute the nine taps
in float32 from 0 in the TPU kernel's (dy, dx) order and store once in the
input's type, so they agree bit for bit. The two are the CUDA and CPU
implementations of the custom op ``torch.ops.botsort_tpu_torch.dw_conv3x3``
(on the taps), which is how a trace reaches them; eager calls skip the
dispatcher.

``dw_plan`` is the kernel's tiling, computed here and passed to the C entry
point: the one definition, checked on the CPU by the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from botsort_tpu_torch.runtime import kernels
from botsort_tpu_torch.utils.consts import tracing

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a Hopper block can use
SPAN_PIXELS = 256   # planes up to this many pixels are tiled whole
SPAN_ELEMS = 2048   # elements of a span tile, about
BAND_ELEMS = 2048   # elements of a band tile without its halo, about
THREADS = 256       # threads of a block, at most


class DwPlan(NamedTuple):
    """K5's tiling of x [N, C, H, W]. A span block takes ``planes`` whole
    planes (one contiguous span of memory); a band block takes ``rows``
    rows of one plane and a one-row halo above and below. A thread
    computes runs of ``rw`` outputs along x: one 16-byte store on the
    vector path (8 bfloat16 or 4 float32), or one element on the scalar
    path, for widths that are not a multiple of 8 or 4."""

    band: bool
    planes: int
    rows: int
    rw: int
    threads: int
    grid: Tuple[int, int]
    smem: int


def dw_plan(shape, itemsize: int, aligned: bool = True) -> DwPlan:
    """The tiling of x of ``shape`` [N, C, H, W] with ``itemsize``-byte
    elements; ``aligned``: x and out start on 16-byte boundaries."""
    n, c, h, w = shape
    vec = 16 // itemsize
    rw = vec if aligned and w % vec == 0 else 1
    n_planes = n * c
    if h * w <= SPAN_PIXELS:
        planes = min(n_planes, max(1, SPAN_ELEMS // (h * w)))
        rows = h
        grid = (-(-n_planes // planes), 1)
        smem = planes * h * w * itemsize
    else:
        planes = 1
        rows = min(h, max(1, BAND_ELEMS // w))
        grid = (n_planes, -(-h // rows))
        smem = (rows + 2) * w * itemsize
    runs = planes * rows * w // rw
    threads = min(THREADS, -(-runs // 32) * 32)
    return DwPlan(h * w > SPAN_PIXELS, planes, rows, rw, threads, grid, smem)


@functools.lru_cache(maxsize=None)
def _launch_params(shape, dtype: torch.dtype, aligned: bool):
    """The C entry point's parameter array for x of ``shape`` and
    ``dtype``: the dimensions, the dtype code and dw_plan, checked; cached,
    since a network calls K5 at a few shapes over and over."""
    plan = dw_plan(shape, dtype.itemsize, aligned)
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"W={shape[3]} needs {plan.smem} B of shared "
                         f"memory (limit {_SMEM_LIMIT})")
    if plan.grid[1] > 65535:
        raise ValueError(f"H={shape[2]} needs {plan.grid[1]} row bands "
                         "(limit 65535)")
    values = (*shape, _DTYPES[dtype], int(plan.band), plan.planes,
              plan.rows, plan.rw, plan.threads, *plan.grid,
              plan.smem)
    return (ctypes.c_int * len(values))(*values)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("dw_conv3x3")
    fn = lib.dw_conv3x3_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def taps_of(kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise weight [C, 1, 3, 3] -> taps [9, C] float32, row dy*3+dx
    (the TPU kernel's ``k9``)."""
    c = kernel.shape[0]
    if tuple(kernel.shape) != (c, 1, 3, 3):
        raise ValueError(f"depthwise kernel must be [C, 1, 3, 3], got "
                         f"{tuple(kernel.shape)}")
    return kernel.reshape(c, 9).t().float().contiguous()


def dw_conv3x3_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W], taps [9, C] float32 -> [N, C, H, W] in x's dtype.
    Nine shifted products added in float32 from 0 in (dy, dx) order; the
    multiply and the add stay separate operations (no fused multiply-add),
    as in the kernel."""
    n, c, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    k = taps.float()
    acc = torch.zeros((n, c, h, w), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, :, dy:dy + h, dx:dx + w]
            acc = acc + tap * k[dy * 3 + dx].view(1, c, 1, 1)
    return acc.to(x.dtype)


def dw_conv3x3_cuda(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W] float32 or bfloat16, taps [9, C] float32, both
    contiguous on one CUDA device -> [N, C, H, W] in x's dtype.

    Launched on the current stream; nothing is synchronised.
    """
    if not x.is_cuda:
        raise ValueError("dw_conv3x3_cuda takes CUDA tensors; the plain "
                         "version is dw_conv3x3_plain")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}, expected float32 or "
                         "bfloat16")
    n, c, h, w = x.shape
    if taps.device != x.device or taps.dtype != torch.float32 or \
            tuple(taps.shape) != (9, c):
        raise ValueError(f"taps must be [9, {c}] float32 on {x.device}, got "
                         f"{tuple(taps.shape)} {taps.dtype} on "
                         f"{taps.device}")
    if not (x.is_contiguous() and taps.is_contiguous()):
        raise ValueError("x and taps must be contiguous")
    out = torch.empty_like(x)
    params = _launch_params(tuple(x.shape), x.dtype,
                            (x.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(x.device):
        rc = _lib().dw_conv3x3_launch(x.data_ptr(), taps.data_ptr(),
                                      out.data_ptr(), params,
                                      kernels.current_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"dw_conv3x3 launch failed: CUDA error {rc}")
    return out


@torch.library.custom_op("botsort_tpu_torch::dw_conv3x3", mutates_args=(),
                        device_types="cpu")
def dw_conv3x3_op(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """K5 as a custom op: the plain version on the CPU, the kernel on the
    card (registered below). The output is contiguous."""
    return dw_conv3x3_plain(x, taps).contiguous()


@dw_conv3x3_op.register_kernel("cuda")
def _dw_conv3x3_op_cuda(x, taps):
    return dw_conv3x3_cuda(x.contiguous(), taps)


@dw_conv3x3_op.register_fake
def _dw_conv3x3_op_fake(x, taps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def dw_conv3x3(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3, stride 1, SAME: x [N, C, H, W], taps [9, C] float32
    -> [N, C, H, W] in x's dtype. CUDA tensors launch K5, CPU tensors take
    the plain version; under a trace, the custom op."""
    if tracing():
        return dw_conv3x3_op(x, taps)
    if x.is_cuda:
        return dw_conv3x3_cuda(x.contiguous(), taps)
    if x.device.type == "cpu":
        return dw_conv3x3_plain(x, taps)
    raise ValueError(f"dw_conv3x3_same: no kernel for device {x.device}")


def dw_conv3x3_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``dw_conv3x3`` with the depthwise weight [C, 1, 3, 3]."""
    return dw_conv3x3(x, taps_of(kernel))
