"""The body encoder's stem and stage 1 as kernel K4 (port of
botsort_tpu/models/fastreid_pallas.py).

``fold_stem_stage1(resnest)`` folds the three stem ``_ConvBN``s and the
three stage-1 ``SplAtBottleneck``s of a ``ResNeSt50`` at the JAX package's
fold and cast points: each conv keeps its bfloat16 kernel and gets float32
``s = scale / sqrt(var + eps)`` and ``b = bias - mean * s``; the grouped
SplAt conv keeps its two radix groups; the attention MLP's ``Dense_0``
weight is multiplied by its batch norm's ``s`` before the bfloat16 cast,
with bias ``Dense_0.bias * s + b`` in float32, and ``Dense_1`` is bfloat16
with a float32 bias.

``stem_stage1(x, folded)`` takes normalised NHWC bfloat16 images and
returns stage 1's output in the port's NCHW layout, [N, 4*width, H/4, W/4]
bfloat16. A CUDA tensor launches K4 (csrc/stem_stage1.cu) through
``stem_stage1_cuda``; a CPU tensor takes ``stem_stage1_plain``, which does
what the TPU kernel does, step by step; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from botsort_tpu_torch.runtime import kernels

# The kernel's tile: K padded to a multiple of 32, each group's output
# channels to a multiple of 64 (csrc/stem_stage1.cu, BK and BN).
_K_TILE, _N_TILE = 32, 64


class FoldedConv(NamedTuple):
    weight: torch.Tensor  # [cout, cin / groups, k, k] bfloat16
    scale: torch.Tensor   # [cout] float32
    bias: torch.Tensor    # [cout] float32
    stride: int
    groups: int
    packed: torch.Tensor  # the kernel's layout (pack_conv)


class FoldedBlock(NamedTuple):
    conv_in: FoldedConv
    conv_split: FoldedConv     # the radix-2 grouped 3x3
    dense0_w: torch.Tensor     # [inter, width] bfloat16, BN folded in
    dense0_b: torch.Tensor     # [inter] float32
    dense1_w: torch.Tensor     # [2 * width, inter] bfloat16
    dense1_b: torch.Tensor     # [2 * width] float32
    conv_out: FoldedConv
    shortcut: Optional[FoldedConv]  # block 0 only


class FoldedStemStage1(NamedTuple):
    stem: Tuple[FoldedConv, FoldedConv, FoldedConv]
    blocks: Tuple[FoldedBlock, FoldedBlock, FoldedBlock]
    stem_width: int
    width: int


def geometry_ok(h: int, w: int) -> bool:
    """Input geometries the JAX package's kernel supports: H divisible by
    4, W by 8 (pair columns at both resolutions), and at least 2 pair
    columns at stage-1 so horizontal taps exist."""
    return h % 4 == 0 and w % 8 == 0 and (w // 8) >= 2 and h >= 8


def _fold_bn(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * s
    return s, b


def pack_conv(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """Conv weight [cout, cin_g, k, k] -> [groups, K, N] bfloat16 with K =
    k*k*cin_g ordered (ky, kx, input channel) and padded to 32, N = cout /
    groups padded to 64, zeros in the padding."""
    cout, cin_g, kh, kw = weight.shape
    cout_g = cout // groups
    k = kh * kw * cin_g
    p = weight.to(torch.bfloat16).reshape(groups, cout_g, cin_g, kh, kw)
    p = p.permute(0, 3, 4, 2, 1).reshape(groups, k, cout_g)
    return F.pad(p, (0, -cout_g % _N_TILE, 0, -k % _K_TILE)).contiguous()


def _fold_convbn(m, stride: int = 1, groups: int = 1) -> FoldedConv:
    s, b = _fold_bn(m.BatchNorm_0)
    w = m.Conv_0.weight.detach().to(torch.bfloat16)
    return FoldedConv(w, s, b, stride, groups, pack_conv(w, groups))


@torch.no_grad()
def fold_stem_stage1(resnest) -> FoldedStemStage1:
    """Fold a ``ResNeSt50``'s stem and its first three blocks (no autograd
    history: the folded tensors are inference constants)."""
    stem = (_fold_convbn(resnest._ConvBN_0, 2),
            _fold_convbn(resnest._ConvBN_1),
            _fold_convbn(resnest._ConvBN_2))
    blocks = []
    for i in range(3):
        blk = getattr(resnest, f"SplAtBottleneck_{i}")
        sp = blk.SplAtConv_0
        s1, b1 = _fold_bn(sp.BatchNorm_0)
        d0, d1 = sp.Dense_0, sp.Dense_1
        blocks.append(FoldedBlock(
            conv_in=_fold_convbn(blk._ConvBN_0),
            conv_split=_fold_convbn(sp._ConvBN_0, groups=sp.radix),
            dense0_w=(d0.weight.float() * s1[:, None]).to(torch.bfloat16),
            dense0_b=d0.bias.float() * s1 + b1,
            dense1_w=d1.weight.detach().to(torch.bfloat16),
            dense1_b=d1.bias.detach().float(),
            conv_out=_fold_convbn(blk._ConvBN_1),
            shortcut=(_fold_convbn(blk._ConvBN_2) if blk.downsample
                      else None)))
    width = blocks[0].conv_in.weight.shape[0]
    return FoldedStemStage1(stem, tuple(blocks),
                            stem[0].weight.shape[0], width)


def _conv_acc(x: torch.Tensor, fc: FoldedConv) -> torch.Tensor:
    """acc * s + b in float32 of a bfloat16 NCHW input: bfloat16 products
    are exact in float32, so the float32 convolution sums them in float32."""
    k = fc.weight.shape[-1]
    acc = F.conv2d(x.float(), fc.weight.float(), stride=fc.stride,
                   padding=(k - 1) // 2, groups=fc.groups)
    return acc * fc.scale.view(1, -1, 1, 1) + fc.bias.view(1, -1, 1, 1)


def _conv_relu(x: torch.Tensor, fc: FoldedConv) -> torch.Tensor:
    return torch.relu(_conv_acc(x, fc)).to(torch.bfloat16)


def _split_attention(y: torch.Tensor, blk: FoldedBlock) -> torch.Tensor:
    """Radix-2 split attention of y [N, 2w, H, W] bfloat16 -> [N, w, H, W]
    bfloat16, in float32 as the TPU kernel computes it."""
    yf = y.float()
    w = yf.shape[1] // 2
    mean = yf.mean(dim=(2, 3))
    gap = mean[:, :w] + mean[:, w:]
    z = torch.relu(gap.to(torch.bfloat16).float() @ blk.dense0_w.float().T
                   + blk.dense0_b)
    att = (z.to(torch.bfloat16).float() @ blk.dense1_w.float().T
           + blk.dense1_b)
    a0, a1 = att[:, :w], att[:, w:]
    mx = torch.maximum(a0, a1)
    e0 = torch.exp(a0 - mx)
    e1 = torch.exp(a1 - mx)
    att0 = e0 / (e0 + e1)
    att1 = 1.0 - att0
    so = yf[:, :w] * att0[..., None, None] + yf[:, w:] * att1[..., None, None]
    return so.to(torch.bfloat16)


def stem_stage1_plain(x: torch.Tensor,
                      folded: FoldedStemStage1) -> torch.Tensor:
    """x [N, H, W, 3] bfloat16 NHWC -> [N, 4*width, H/4, W/4] bfloat16
    NCHW, step by step as the TPU kernel computes it."""
    h = x.permute(0, 3, 1, 2)
    for fc in folded.stem:
        h = _conv_relu(h, fc)
    h = F.max_pool2d(h.float(), 3, 2, 1).to(torch.bfloat16)
    for blk in folded.blocks:
        t = _conv_relu(h, blk.conv_in)
        so = _split_attention(_conv_relu(t, blk.conv_split), blk)
        out = _conv_acc(so, blk.conv_out)
        sc = (_conv_acc(h, blk.shortcut) if blk.shortcut is not None
              else h.float())
        h = torch.relu(out + sc).to(torch.bfloat16)
    return h


def _lib() -> ctypes.CDLL:
    lib = kernels.load("stem_stage1")
    fn = lib.stem_stage1_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.stem_stage1_scratch_bytes.argtypes = [ctypes.c_int] * 5
        lib.stem_stage1_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _kernel_tensors(folded: FoldedStemStage1):
    """The kernel's weight pointers' tensors in csrc/stem_stage1.cu's
    order; None stands for a null pointer."""
    out = []
    for fc in folded.stem:
        out += [fc.packed, fc.scale, fc.bias]
    for blk in folded.blocks:
        for fc in (blk.conv_in, blk.conv_split):
            out += [fc.packed, fc.scale, fc.bias]
        out += [blk.dense0_w, blk.dense0_b, blk.dense1_w, blk.dense1_b]
        out += [blk.conv_out.packed, blk.conv_out.scale, blk.conv_out.bias]
        sc = blk.shortcut
        out += [sc.packed, sc.scale, sc.bias] if sc is not None else [None] * 3
    return out


def stem_stage1_cuda(x: torch.Tensor,
                     folded: FoldedStemStage1) -> torch.Tensor:
    """x [N, H, W, 3] bfloat16 NHWC, contiguous on a CUDA device, the folded
    weights on the same device -> [N, 4*width, H/4, W/4] bfloat16 NCHW.

    One call runs 17 CUDA kernels on the current stream (13 convolutions,
    the max pool, three attention kernels); nothing is synchronised.
    ``stem_stage1_cuda.launches`` counts calls.
    """
    if not x.is_cuda:
        raise ValueError("stem_stage1_cuda takes CUDA tensors; the plain "
                         "version is stem_stage1_plain")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x has dtype {x.dtype}, expected bfloat16")
    if x.dim() != 4 or x.shape[3] != 3 or x.shape[0] < 1:
        raise ValueError(f"x must be [N, H, W, 3], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, h, w, _ = x.shape
    if not geometry_ok(h, w):
        raise ValueError(f"unsupported geometry {h}x{w} (geometry_ok)")
    sw, width = folded.stem_width, folded.width
    if 2 * width > 512 or width % 2:
        raise ValueError(f"stage-1 width {width} unsupported (even, <= 256)")
    inter = max(2 * width // 4, 32)  # SplAtConv's, as the kernel derives it
    if tuple(folded.blocks[0].dense0_w.shape) != (inter, width):
        raise ValueError(f"Dense_0 must be [{inter}, {width}]")
    tensors = _kernel_tensors(folded)
    for t in tensors:
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("the folded weights must be contiguous on "
                             f"{x.device}")
    lib = _lib()
    out = torch.empty((n, 4 * width, h // 4, w // 4), dtype=torch.bfloat16,
                      device=x.device)
    scratch = torch.empty(
        (lib.stem_stage1_scratch_bytes(n, h, w, sw, width),),
        dtype=torch.uint8, device=x.device)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    with torch.cuda.device(x.device):
        stream = kernels.current_stream(x.device)
        rc = lib.stem_stage1_launch(x.data_ptr(),
                                    ctypes.cast(ptrs, ctypes.c_void_p),
                                    out.data_ptr(),
                                    scratch.data_ptr(), n, h, w, sw, width,
                                    stream)
    if rc != 0:
        raise RuntimeError(f"stem_stage1 launch failed: CUDA error {rc}")
    stem_stage1_cuda.launches += 1
    return out


stem_stage1_cuda.launches = 0


def stem_stage1(x: torch.Tensor, folded: FoldedStemStage1) -> torch.Tensor:
    """Stem + stage 1: x [N, H, W, 3] bfloat16 NHWC -> [N, 4*width, H/4,
    W/4] bfloat16 NCHW. CUDA tensors launch K4, CPU tensors take the plain
    version."""
    if x.is_cuda:
        return stem_stage1_cuda(x.contiguous(), folded)
    if x.device.type == "cpu":
        return stem_stage1_plain(x, folded)
    raise ValueError(f"stem_stage1: no kernel for device {x.device}")
