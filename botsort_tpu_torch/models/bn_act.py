"""Inference batch norm + activation as one pass: kernel K6.

``bn_act(x, mean, mul, bias, act)`` computes, per channel (dim 1 of a
contiguous [N, C, ...] tensor, so also the last dim of [N, C]),

    y   = ((x.float() - mean) * mul + bias).to(x.dtype)
    out = act(y)                 # computed in float32, rounded to x.dtype

with ``mul = rsqrt(var + eps) * scale`` (Flax's BatchNorm formula, as
models/common.py::BatchNorm has always computed it) and ``act`` one of
``ACTS``. The JAX package has no kernel for this: XLA fuses the norm and
the activation into the convolution before them. Eager PyTorch ran about
nine elementwise kernels a layer instead, so the port has a kernel of its
own, csrc/bn_act.cu: one read and one write of the activation.

A CUDA tensor launches the kernel through ``bn_act_cuda``; a CPU tensor
takes ``bn_act_plain``, the same float32 operations in the same order;
any other device raises. none, ReLU and ReLU6 agree bit for bit. SiLU
agrees to one unit in the last place of x's dtype: both compute
``v / (1 + exp(-v))`` in float32, but the exponential is the CUDA math
library's in the kernel and ATen's in the plain version, and the two may
round differently.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from botsort_tpu_torch.runtime import kernels

ACTS = ("none", "silu", "relu", "relu6")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
VECTORS_PER_THREAD = 4   # a thread's share of the grid-stride loop, about
MAX_ELEMENTS = 2 ** 31 - 1  # the kernel indexes with 32 bits


def bn_act_plan(total: int, itemsize: int, aligned: bool = True):
    """(vec, grid, threads) of K6's launch for ``total`` elements of
    ``itemsize`` bytes: 16-byte vectors where x and out start on 16-byte
    boundaries, ``VECTORS_PER_THREAD`` vectors a thread."""
    vec = 16 // itemsize if aligned else 1
    n_vec = max(total // vec, 1)
    grid = max(1, -(-n_vec // (THREADS * VECTORS_PER_THREAD)))
    return vec, grid, THREADS


@functools.lru_cache(maxsize=None)
def _launch_params(total: int, channels: int, inner: int,
                   dtype: torch.dtype, act: str, aligned: bool):
    """The C entry point's parameter array; cached, since a network calls
    K6 at a few shapes over and over."""
    vec, grid, threads = bn_act_plan(total, dtype.itemsize, aligned)
    values = (total, channels, inner, _DTYPES[dtype], ACTS.index(act), vec,
              grid, threads)
    return (ctypes.c_int * len(values))(*values)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("bn_act")
    fn = lib.bn_act_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of "
                         f"{ACTS}")


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                 bias: torch.Tensor, act: str = "none") -> torch.Tensor:
    """x [N, C, ...], mean / mul / bias [C] float32 -> x's shape and dtype.
    Subtract, multiply, add in float32, one rounding to x's dtype, then the
    activation on the rounded value (in float32, rounded again)."""
    _check_act(act)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x.float() - mean.view(shape)) * mul.view(shape)
    y = (y + bias.view(shape)).to(x.dtype)
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    return y


def bn_act_cuda(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                bias: torch.Tensor, act: str = "none") -> torch.Tensor:
    """x [N, C, ...] float32 or bfloat16, contiguous, and mean / mul / bias
    [C] float32 contiguous, all on one CUDA device -> x's shape and dtype.

    Launched on the current stream; nothing is synchronised.
    ``bn_act_cuda.launches`` counts launches.
    """
    _check_act(act)
    if not x.is_cuda:
        raise ValueError("bn_act_cuda takes CUDA tensors; the plain version "
                         "is bn_act_plain")
    if x.dim() < 2 or x.numel() < 1:
        raise ValueError(f"x must be a non-empty [N, C, ...], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}, expected float32 or "
                         "bfloat16")
    if x.numel() > MAX_ELEMENTS:
        raise ValueError(f"x has {x.numel()} elements (limit {MAX_ELEMENTS})")
    c = x.shape[1]
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous [{c}] float32 on {x.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    params = _launch_params(x.numel(), c, x.numel() // (x.shape[0] * c),
                            x.dtype, act,
                            (x.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(x.device):
        rc = _lib().bn_act_launch(x.data_ptr(), mean.data_ptr(),
                                  mul.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), params,
                                  kernels.current_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"bn_act launch failed: CUDA error {rc}")
    bn_act_cuda.launches += 1
    return out


bn_act_cuda.launches = 0


def bn_act(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
           bias: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Batch norm + activation: CUDA tensors launch K6, CPU tensors take
    the plain version, any other device raises."""
    if x.is_cuda:
        return bn_act_cuda(x.contiguous(), mean, mul, bias, act)
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, mul, bias, act)
    raise ValueError(f"bn_act: no kernel for device {x.device}")
