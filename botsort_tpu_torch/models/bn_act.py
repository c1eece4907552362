"""Inference batch norm + activation as one pass: kernel K6.

``bn_act(x, mean, mul, bias, act)`` computes, per channel (dim 1 of an
[N, C, ...] tensor, so also the last dim of [N, C]),

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
any other device raises. The output is laid out as x is. ``bn_act_cuda``
takes the path from x's strides: a contiguous x with more than one
element a plane (NCHW) takes ``bn_act_kernel``; an x whose channels are
innermost (the channels-last activations the networks run on the card,
and [N, C] or [N, C, 1, 1]) takes ``bn_act_kernel_cl``, a thread a
column of channels (``bn_act_cl_plan``); anything else raises. The two
are the CUDA and CPU implementations of the custom op
``torch.ops.botsort_tpu_torch.bn_act``, which is how a trace
(``torch.export``) reaches them; eager calls skip the dispatcher.
none, ReLU and ReLU6 agree bit for bit. SiLU agrees to one unit in the
last place of x's dtype on the card (two units between the card and the
CPU, whose SiLU is ATen's CPU one): both compute
``v / (1 + exp(-v))`` in float32, but the exponential is the CUDA math
library's in the kernel and ATen's in the plain version, and the two may
round differently.

Training differentiates it. ``bn_act_backward_plain`` and kernel K6b
(csrc/bn_act_backward.cu, ``bn_act_backward_cuda``) compute, from
``grad_out``, x and the three [C] vectors, ``grad_x`` and the two
per-channel sums that give the [C] gradients (``bn_act_grads``); K6's y is
recomputed there, not saved. A call that needs a gradient (grad enabled and
any input requiring one) goes through ``BnActFunction``, whose backward
launches K6b on a CUDA tensor and the plain backward on a CPU tensor; the
custom op ``bn_act`` has the same backward registered (through the op
``bn_act_backward``), so a traced graph differentiates too; the gradient
route hands K6 and K6b contiguous tensors. Inference calls keep the direct
route, in x's own layout, as the custom op does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from botsort_tpu_torch.runtime import kernels
from botsort_tpu_torch.utils.consts import tracing

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


# The channels-innermost launch covers the card with about this many blocks
# (4 per SM of an H100); its threads then stride over the rows.
CL_TARGET_BLOCKS = 4 * 132


def bn_act_cl_plan(rows: int, channels: int, itemsize: int,
                   aligned: bool = True):
    """(vec, tile, per_block, grid) of K6's channels-innermost launch for x
    [rows, channels]: a thread takes a column of ``vec`` channels (16 bytes
    where ``channels`` is a whole number of 16-byte vectors and the pointers
    are aligned, else one channel), a block ``per_block`` rows of ``tile``
    columns, the grid (row blocks, tiles of columns)."""
    vec = 16 // itemsize
    if not aligned or channels % vec:
        vec = 1
    cols = channels // vec
    tiles = -(-cols // THREADS)
    tile = -(-cols // tiles)
    per_block = THREADS // tile
    row_blocks = -(-rows // per_block)
    grid_x = min(row_blocks, max(1, CL_TARGET_BLOCKS // tiles))
    return vec, tile, per_block, (grid_x, tiles)


@functools.lru_cache(maxsize=None)
def _launch_params(total: int, channels: int, inner: int,
                   dtype: torch.dtype, act: str, aligned: bool):
    """The C entry point's parameter array; cached, since a network calls
    K6 at a few shapes over and over."""
    vec, grid, threads = bn_act_plan(total, dtype.itemsize, aligned)
    values = (total, channels, inner, _DTYPES[dtype], ACTS.index(act), vec,
              grid, threads)
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _cl_launch_params(rows: int, channels: int, dtype: torch.dtype,
                      act: str, aligned: bool):
    """The channels-innermost entry point's parameter array; cached."""
    vec, tile, per_block, grid = bn_act_cl_plan(rows, channels,
                                                dtype.itemsize, aligned)
    values = (rows, channels, _DTYPES[dtype], ACTS.index(act), vec, tile,
              per_block, *grid)
    return (ctypes.c_int * len(values))(*values)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("bn_act")
    for fn in (lib.bn_act_launch, lib.bn_act_cl_launch):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def channels_innermost(x: torch.Tensor) -> bool:
    """Whether x [N, C, ...] is dense with its channels innermost: a
    channels-last [N, C, H, W], a contiguous [N, C] or [N, C, 1, 1]."""
    if x.dim() == 4:  # the networks' case, without building a view
        return x.is_contiguous(memory_format=torch.channels_last)
    return x.movedim(1, -1).is_contiguous()


def bn_act_path(x: torch.Tensor) -> str:
    """K6's path for x [N, C, ...] by its strides: ``"contiguous"``
    (``bn_act_kernel``) for a contiguous x with more than one element a
    plane, ``"channels_last"`` (``bn_act_kernel_cl``) for one whose
    channels are innermost; any other layout raises."""
    if x.is_contiguous() and x.numel() > x.shape[0] * x.shape[1]:
        return "contiguous"
    if channels_innermost(x):
        return "channels_last"
    raise ValueError("x must be contiguous or have its channels innermost "
                     "(channels-last)")


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
    """x [N, C, ...] float32 or bfloat16, contiguous or with its channels
    innermost (``channels_innermost``), and mean / mul / bias [C] float32
    contiguous, all on one CUDA device -> x's shape, dtype and layout.

    ``bn_act_path`` picks the kernel from x's strides. Launched on the
    current stream; nothing is synchronised. ``bn_act_cuda.launches``
    counts launches, ``bn_act_cuda.launches_channels_last`` those of the
    channels-innermost kernel.
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
    path = bn_act_path(x)
    out = torch.empty_like(x)  # keeps x's layout
    if path == "contiguous":
        params = _launch_params(x.numel(), c, x.numel() // (x.shape[0] * c),
                                x.dtype, act,
                                (x.data_ptr() | out.data_ptr()) % 16 == 0)
        launch = _lib().bn_act_launch
    else:
        aligned = (x.data_ptr() | out.data_ptr() | mean.data_ptr()
                   | mul.data_ptr() | bias.data_ptr()) % 16 == 0
        params = _cl_launch_params(x.numel() // c, c, x.dtype, act, aligned)
        launch = _lib().bn_act_cl_launch
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), mean.data_ptr(), mul.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), params,
                    kernels.current_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"bn_act launch failed: CUDA error {rc}")
    bn_act_cuda.launches += 1
    if path == "channels_last":
        bn_act_cuda.launches_channels_last += 1
    return out


bn_act_cuda.launches = 0
bn_act_cuda.launches_channels_last = 0


# K6b's launch: blocks per channel are chosen so that about this many
# blocks cover the card (4 per SM of an H100).
BACKWARD_TARGET_BLOCKS = 4 * 132


def bn_act_backward_plan(planes: int, channels: int, inner: int,
                         itemsize: int, aligned: bool = True):
    """(vec, slices, planes per slice) of K6b's launch for x [planes,
    channels, inner]: 16-byte vectors where every plane is a whole number of
    them and the pointers are aligned, and each channel's planes cut into
    ``slices`` blocks."""
    vec = 16 // itemsize
    if not aligned or inner % vec:
        vec = 1
    want = max(1, -(-BACKWARD_TARGET_BLOCKS // channels))
    per = -(-planes // min(planes, want))
    return vec, -(-planes // per), per


def _backward_lib() -> ctypes.CDLL:
    lib = kernels.load("bn_act_backward")
    fn = lib.bn_act_backward_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def bn_act_backward_plain(grad_out: torch.Tensor, x: torch.Tensor,
                          mean: torch.Tensor, mul: torch.Tensor,
                          bias: torch.Tensor, act: str = "none"):
    """The backward of ``bn_act_plain``: (grad_x in x's dtype, sum_gy [C],
    sum_gyx [C] float32). K6's y is recomputed; g_y = grad_out * act'(y) is
    rounded to x's dtype (torch's activation backwards return it in that
    dtype), grad_x = g_y * mul rounded to x's dtype, and the sums are of
    g_y and of g_y * (x - mean) over every dim but 1, accumulated in
    float64."""
    _check_act(act)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    d = x.float() - mean.view(shape)
    g = grad_out
    if act != "none":
        y = (d * mul.view(shape) + bias.view(shape)).to(x.dtype)
        if act == "silu":
            g = torch.ops.aten.silu_backward(grad_out, y)
        elif act == "relu":
            g = torch.where(y > 0, grad_out, torch.zeros_like(grad_out))
        else:
            g = torch.where((y >= 0) & (y <= 6), grad_out,
                            torch.zeros_like(grad_out))
    gf = g.to(x.dtype).float()
    grad_x = (gf * mul.view(shape)).to(x.dtype)
    dims = [0] + list(range(2, x.dim()))
    sum_gy = gf.double().sum(dims).float()
    sum_gyx = (gf * d).double().sum(dims).float()
    return grad_x, sum_gy, sum_gyx


def bn_act_backward_cuda(grad_out: torch.Tensor, x: torch.Tensor,
                         mean: torch.Tensor, mul: torch.Tensor,
                         bias: torch.Tensor, act: str = "none"):
    """K6b: ``bn_act_backward_plain`` on the card. grad_out and x [N, C,
    ...] of one dtype (float32 or bfloat16), contiguous; mean / mul / bias
    [C] float32 contiguous; all on one CUDA device. Launched on the current
    stream (two kernels: the pass over the elements, then the sums of each
    channel's partials); nothing is synchronised.
    ``bn_act_backward_cuda.launches`` counts calls."""
    _check_act(act)
    if not x.is_cuda:
        raise ValueError("bn_act_backward_cuda takes CUDA tensors; the plain "
                         "version is bn_act_backward_plain")
    if x.dim() < 2 or x.numel() < 1:
        raise ValueError(f"x must be a non-empty [N, C, ...], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}, expected float32 or "
                         "bfloat16")
    if grad_out.shape != x.shape or grad_out.dtype != x.dtype or \
            grad_out.device != x.device:
        raise ValueError(f"grad_out must match x ({tuple(x.shape)} {x.dtype} "
                         f"on {x.device}), got {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} on {grad_out.device}")
    if x.numel() > MAX_ELEMENTS:
        raise ValueError(f"x has {x.numel()} elements (limit {MAX_ELEMENTS})")
    n, c = x.shape[0], x.shape[1]
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous [{c}] float32 on {x.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not x.is_contiguous() or not grad_out.is_contiguous():
        raise ValueError("x and grad_out must be contiguous")
    inner = x.numel() // (n * c)
    grad_x = torch.empty_like(x)
    aligned = (x.data_ptr() | grad_out.data_ptr() | grad_x.data_ptr()) \
        % 16 == 0
    vec, slices, per = bn_act_backward_plan(n, c, inner, x.element_size(),
                                            aligned)
    partial = torch.empty((2, c, slices), dtype=torch.float64,
                          device=x.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    values = (n, c, inner, _DTYPES[x.dtype], ACTS.index(act), vec, slices,
              per)
    params = (ctypes.c_int * len(values))(*values)
    with torch.cuda.device(x.device):
        rc = _backward_lib().bn_act_backward_launch(
            grad_out.data_ptr(), x.data_ptr(), mean.data_ptr(),
            mul.data_ptr(), bias.data_ptr(), grad_x.data_ptr(),
            partial[0].data_ptr(), partial[1].data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), params,
            kernels.current_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"bn_act_backward launch failed: CUDA error {rc}")
    bn_act_backward_cuda.launches += 1
    return grad_x, sums[0], sums[1]


bn_act_backward_cuda.launches = 0


def bn_act_grads(mul: torch.Tensor, sum_gy: torch.Tensor,
                 sum_gyx: torch.Tensor):
    """(grad_mean, grad_mul, grad_bias) from the backward's two sums."""
    return -mul * sum_gy, sum_gyx, sum_gy


@torch.library.custom_op("botsort_tpu_torch::bn_act", mutates_args=(),
                        device_types="cpu")
def bn_act_op(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
              bias: torch.Tensor, act: str) -> torch.Tensor:
    """K6 as a custom op: the plain version on the CPU, the kernel on the
    card (registered below); either output is laid out as x is, so an
    exported program runs the live networks' layouts."""
    return bn_act_plain(x, mean, mul, bias, act)


def _k6_input(x: torch.Tensor) -> torch.Tensor:
    """x as K6 reads it on the card: as it is where it is contiguous or
    has its channels innermost, else a contiguous copy."""
    if x.is_contiguous() or channels_innermost(x):
        return x
    return x.contiguous()  # neither layout K6 reads


@bn_act_op.register_kernel("cuda")
def _bn_act_op_cuda(x, mean, mul, bias, act):
    return bn_act_cuda(_k6_input(x), mean, mul, bias, act)


@bn_act_op.register_fake
def _bn_act_op_fake(x, mean, mul, bias, act):
    _check_act(act)
    if x.device.type == "cuda":
        return torch.empty_like(_k6_input(x))
    return torch.empty_like(x)


@torch.library.custom_op("botsort_tpu_torch::bn_act_backward",
                        mutates_args=(), device_types="cpu")
def bn_act_backward_op(grad_out: torch.Tensor, x: torch.Tensor,
                       mean: torch.Tensor, mul: torch.Tensor,
                       bias: torch.Tensor, act: str
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6b as a custom op: the plain backward on the CPU, the kernel on the
    card (registered below)."""
    return bn_act_backward_plain(grad_out, x, mean, mul, bias, act)


@bn_act_backward_op.register_kernel("cuda")
def _bn_act_backward_op_cuda(grad_out, x, mean, mul, bias, act):
    return bn_act_backward_cuda(grad_out.contiguous(), x.contiguous(), mean,
                                mul, bias, act)


@bn_act_backward_op.register_fake
def _bn_act_backward_op_fake(grad_out, x, mean, mul, bias, act):
    _check_act(act)
    c = x.shape[1]
    fmt = (torch.contiguous_format if x.device.type == "cuda"
           else torch.preserve_format)
    return (torch.empty_like(x, memory_format=fmt), mean.new_empty(c),
            mean.new_empty(c))


def _bn_act_op_setup(ctx, inputs, output):
    x, mean, mul, bias, act = inputs
    ctx.save_for_backward(x, mean, mul, bias)
    ctx.act = act


def _bn_act_op_backward(ctx, grad):
    x, mean, mul, bias = ctx.saved_tensors
    grad_x, sum_gy, sum_gyx = bn_act_backward_op(grad, x, mean, mul, bias,
                                                 ctx.act)
    return (grad_x, *bn_act_grads(mul, sum_gy, sum_gyx), None)


bn_act_op.register_autograd(_bn_act_op_backward,
                            setup_context=_bn_act_op_setup)


class BnActFunction(torch.autograd.Function):
    """``bn_act`` with a gradient, eagerly: forward K6 (the plain version on
    a CPU tensor), backward K6b (the plain backward on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias, act):
        if x.is_cuda:
            x = x.contiguous()
            out = bn_act_cuda(x, mean, mul, bias, act)
        else:
            out = bn_act_plain(x, mean, mul, bias, act)
        ctx.save_for_backward(x, mean, mul, bias)
        ctx.act = act
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mean, mul, bias = ctx.saved_tensors
        if x.is_cuda:
            grad_x, sum_gy, sum_gyx = bn_act_backward_cuda(
                grad.contiguous(), x, mean, mul, bias, ctx.act)
        else:
            grad_x, sum_gy, sum_gyx = bn_act_backward_plain(
                grad, x, mean, mul, bias, ctx.act)
        return (grad_x, *bn_act_grads(mul, sum_gy, sum_gyx), None)


def bn_act(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
           bias: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Batch norm + activation: CUDA tensors launch K6 in their own layout
    (contiguous or channels-last; other strides are made contiguous
    first), CPU tensors take the plain version, any other device raises.
    Under a trace, the custom op; where a gradient is needed,
    ``BnActFunction``."""
    if tracing():
        return bn_act_op(x, mean, mul, bias, act)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bn_act: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or mean.requires_grad
                                    or mul.requires_grad
                                    or bias.requires_grad):
        return BnActFunction.apply(x, mean, mul, bias, act)
    if x.is_cuda:
        return bn_act_cuda(_k6_input(x), mean, mul, bias, act)
    return bn_act_plain(x, mean, mul, bias, act)
