"""The face encoder's stride-1 depthwise 3x3 as kernel K5 (port of
botsort_tpu/models/facereid_pallas.py).

``dw_conv3x3_same(x, kernel)`` takes the port's NCHW activations and the
depthwise conv weight [C, 1, 3, 3] (the parameter ``nn.Conv2d(groups=C)``
holds, so a state dict serves every lowering). A CUDA tensor launches K5,
csrc/dw_conv3x3.cu, through ``dw_conv3x3_cuda``; a CPU tensor takes
``dw_conv3x3_plain``; any other device raises. Both compute the nine taps
in float32 from 0 in the TPU kernel's (dy, dx) order and store once in the
input's type, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from botsort_tpu_torch.runtime import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024  # static launch: no opt-in to more shared memory


def _lib() -> ctypes.CDLL:
    lib = kernels.load("dw_conv3x3")
    fn = lib.dw_conv3x3_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dw_conv3x3_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dw_conv3x3_smem_bytes.restype = ctypes.c_int
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
    ``dw_conv3x3_cuda.launches`` counts launches.
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
    lib = _lib()
    smem = lib.dw_conv3x3_smem_bytes(h, w)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"W={w} needs {smem} B of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dw_conv3x3_launch(x.data_ptr(), taps.data_ptr(),
                                   out.data_ptr(), n, c, h, w,
                                   _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"dw_conv3x3 launch failed: CUDA error {rc}")
    dw_conv3x3_cuda.launches += 1
    return out


dw_conv3x3_cuda.launches = 0


def dw_conv3x3_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3, stride 1, SAME: x [N, C, H, W], kernel [C, 1, 3, 3]
    -> [N, C, H, W] in x's dtype. CUDA tensors launch K5, CPU tensors take
    the plain version."""
    taps = taps_of(kernel)
    if x.is_cuda:
        return dw_conv3x3_cuda(x.contiguous(), taps)
    if x.device.type == "cpu":
        return dw_conv3x3_plain(x, taps)
    raise ValueError(f"dw_conv3x3_same: no kernel for device {x.device}")
