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
what the TPU kernel does, step by step; any other device raises. The two
are the CUDA and CPU implementations of the custom op
``torch.ops.botsort_tpu_torch.stem_stage1``, which takes the folded
weights as a list of tensors and a plan string (``fold_tensors``), and is
how a trace reaches them; eager calls skip the dispatcher.

The kernel runs layer by layer through bfloat16 NHWC scratch, so the bytes
of that scratch bound it, not its operations; the design moves each
activation once, 16 bytes a thread, and fuses what shares data (the
block-0 shortcut and the attention's weighted sum into the block's last
1x1, the attention's pixel sums into the grouped conv). ``conv_plan`` is
the one definition of its tiling: which path each convolution takes (by its
shapes alone), its tile, K steps, stages, grid and shared memory. The
wrapper passes it to the C entry point with ``scratch_layout``'s offsets,
and the weights are packed for their path at fold time (``pack_conv``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from botsort_tpu_torch.runtime import kernels
from botsort_tpu_torch.utils.consts import tracing

# The paths of csrc/stem_stage1.cu, with the codes its launcher reads.
GENERAL, RING, STEM0, OUT, HALO = "general", "ring", "stem0", "out", "halo"
_PATH_CODES = {GENERAL: 0, RING: 1, STEM0: 2, OUT: 3, HALO: 4}
# The general path's tile (BM, BN, BK): K padded to a multiple of 32, each
# group's output channels to a multiple of 64.
_GEN_M, _N_TILE, _K_TILE = 64, 64, 32
_GEN_SMEM = 2 * (64 * 40 + 32 * 72) + 2 * 4 * 64 * 68  # static, bytes
# The fast paths: 128 pixels of one image a block (two warpgroups of 64
# rows), K in steps of 64 through a ring of three stages.
TILE_M, STEP_K, STAGES = 128, 64, 3
FAST_THREADS = 256
SMEM_LIMIT = 232_448   # dynamic shared memory a Hopper block can use
SM_SMEM = 233_472      # shared memory of an SM; a block reserves 1024 more
STEM0_ROWS = 16        # output rows of a stem0 block
OUT_WIDTH = 64         # the stage-1 width the fused last 1x1 is built for
SM_COUNT = 132         # the H100's; sizes the persistent 3x3 grids


class FoldedConv(NamedTuple):
    weight: torch.Tensor  # [cout, cin / groups, k, k] bfloat16
    scale: torch.Tensor   # [cout] float32
    bias: torch.Tensor    # [cout] float32
    stride: int
    groups: int
    packed: torch.Tensor  # the kernel's layout for ``path`` (pack_conv)
    path: str             # GENERAL, STEM0, HALO, RING or OUT (conv_path)


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


def conv_path(role: str, cin_g: int, cout_g: int, ksize: int,
              stride: int) -> str:
    """The kernel path of one convolution, from its shapes alone. ``role``
    is "stem0" (the 3-channel stride-2 conv), "conv", or "out" (a block's
    last 1x1, which carries the attention's weighted sum and, in block 0,
    the shortcut; ``cin_g`` is then the width of every input it reads)."""
    if role == "stem0":
        ok = (cin_g, ksize, stride) == (3, 3, 2) and cout_g % 8 == 0
        return STEM0 if ok else GENERAL
    if role == "out":
        ok = cin_g == OUT_WIDTH and cout_g == 4 * OUT_WIDTH
        return OUT if ok else GENERAL
    pow2 = cin_g >= 32 and cin_g & (cin_g - 1) == 0
    if pow2 and stride == 1 and ksize == 3 and cout_g in (32, 64):
        return HALO
    if pow2 and stride == 1 and ksize == 1 and cout_g == 64:
        return RING
    return GENERAL


def pack_conv(weight: torch.Tensor, groups: int,
              path: str = GENERAL) -> torch.Tensor:
    """Conv weight [cout, cin_g, k, k] -> the kernel's bfloat16 layout, K =
    k*k*cin_g ordered (ky, kx, input channel), zeros in the padding.

    GENERAL and STEM0: [groups, K padded to 32, cout / groups padded to
    64]. HALO, RING and OUT: [groups, K steps of 64, cout / groups, 64], one
    row of 64 consecutive K per output channel and step: the rows wgmma's B
    descriptor reads (the kernel swizzles them on the way into shared
    memory)."""
    cout, cin_g, kh, kw = weight.shape
    cout_g = cout // groups
    k = kh * kw * cin_g
    p = weight.to(torch.bfloat16).reshape(groups, cout_g, cin_g, kh, kw)
    if path in (GENERAL, STEM0):
        p = p.permute(0, 3, 4, 2, 1).reshape(groups, k, cout_g)
        return F.pad(p, (0, -cout_g % _N_TILE, 0, -k % _K_TILE)).contiguous()
    p = F.pad(p.permute(0, 1, 3, 4, 2).reshape(groups, cout_g, k),
              (0, -k % STEP_K))
    return p.reshape(groups, cout_g, -1, STEP_K).permute(0, 2, 1, 3) \
        .contiguous()


def unpack_conv(packed: torch.Tensor, shape, groups: int,
                path: str = GENERAL) -> torch.Tensor:
    """The inverse of ``pack_conv`` for a weight of ``shape``."""
    cout, cin_g, kh, kw = shape
    cout_g = cout // groups
    k = kh * kw * cin_g
    if path in (GENERAL, STEM0):
        p = packed[:, :k, :cout_g].permute(0, 2, 1)
    else:
        p = packed.permute(0, 2, 1, 3).reshape(groups, cout_g, -1)[..., :k]
    return p.reshape(groups, cout_g, kh, kw, cin_g).permute(0, 1, 4, 2, 3) \
        .reshape(cout, cin_g, kh, kw)


def _fold_convbn(m, stride: int = 1, groups: int = 1, role: str = "conv",
                 path: Optional[str] = None) -> FoldedConv:
    s, b = _fold_bn(m.BatchNorm_0)
    w = m.Conv_0.weight.detach().to(torch.bfloat16)
    if path is None:
        path = conv_path(role, w.shape[1], w.shape[0] // groups, w.shape[2],
                         stride)
    return FoldedConv(w, s, b, stride, groups, pack_conv(w, groups, path),
                      path)


@torch.no_grad()
def fold_stem_stage1(resnest) -> FoldedStemStage1:
    """Fold a ``ResNeSt50``'s stem and its first three blocks (no autograd
    history: the folded tensors are inference constants)."""
    stem = (_fold_convbn(resnest._ConvBN_0, 2, role="stem0"),
            _fold_convbn(resnest._ConvBN_1),
            _fold_convbn(resnest._ConvBN_2))
    blocks = []
    for i in range(3):
        blk = getattr(resnest, f"SplAtBottleneck_{i}")
        sp = blk.SplAtConv_0
        s1, b1 = _fold_bn(sp.BatchNorm_0)
        d0, d1 = sp.Dense_0, sp.Dense_1
        # The last 1x1 and the shortcut fused into it share one path.
        wo = blk._ConvBN_1.Conv_0.weight
        out_path = conv_path("out", wo.shape[1], wo.shape[0], 1, 1)
        if blk.downsample and blk._ConvBN_2.Conv_0.weight.shape[1] != \
                wo.shape[1]:
            out_path = GENERAL
        blocks.append(FoldedBlock(
            conv_in=_fold_convbn(blk._ConvBN_0),
            conv_split=_fold_convbn(sp._ConvBN_0, groups=sp.radix),
            dense0_w=(d0.weight.float() * s1[:, None]).to(torch.bfloat16),
            dense0_b=d0.bias.float() * s1 + b1,
            dense1_w=d1.weight.detach().to(torch.bfloat16),
            dense1_b=d1.bias.detach().float(),
            conv_out=_fold_convbn(blk._ConvBN_1, path=out_path),
            shortcut=(_fold_convbn(blk._ConvBN_2, path=out_path)
                      if blk.downsample else None)))
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
    NCHW, contiguous as the kernel's, step by step as the TPU kernel
    computes it."""
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
    return h.contiguous()


class ConvPlan(NamedTuple):
    """How one convolution of the call runs. ``m_tile`` pixels by ``n_tile``
    output channels of one group a block; the tensor-core instruction is
    ``n_inst`` wide (wgmma m64nNk16 on the fast paths: the fused last 1x1
    takes its 256 channels 64 at a time, 32 in block 0 with its two
    accumulators);
    ``k_steps`` steps of 64 of K (32 on the general path) through
    ``stages`` shared-memory stages (RING) or halo buffers (HALO);
    ``smem`` bytes of shared memory (dynamic on the fast paths). The
    block-0 shortcut has no launch of its own (``fused_into``)."""

    name: str
    path: str
    m_tile: int
    n_tile: int
    n_inst: int
    k_steps: int
    stages: int
    threads: int
    grid: Tuple[int, int, int]
    smem: int
    fused_into: Optional[str] = None


class ConvSpec(NamedTuple):
    name: str
    role: str
    cin: int
    cout: int
    groups: int
    ksize: int
    stride: int
    level: int   # the output is H / 2**level x W / 2**level


def conv_specs(sw: int, width: int) -> List[ConvSpec]:
    """The 13 convolutions of the call, in launch order."""
    specs = [ConvSpec("stem0", "stem0", 3, sw, 1, 3, 2, 1),
             ConvSpec("stem1", "conv", sw, sw, 1, 3, 1, 1),
             ConvSpec("stem2", "conv", sw, 2 * sw, 1, 3, 1, 1)]
    cin = 2 * sw
    for b in range(3):
        specs += [
            ConvSpec(f"block{b}.in", "conv", cin, width, 1, 1, 1, 2),
            ConvSpec(f"block{b}.split", "conv", width, 2 * width, 2, 3, 1, 2),
            ConvSpec(f"block{b}.out", "out", width, 4 * width, 1, 1, 1, 2)]
        if b == 0:
            specs.append(ConvSpec("block0.shortcut", "out", cin, 4 * width,
                                  1, 1, 1, 2))
        cin = 4 * width
    return specs


def ring_smem(n_tile: int) -> int:
    """Dynamic shared memory of the ring kernel: ``STAGES`` stages of a
    128-pixel A tile and an ``n_tile``-row B tile, 128 bytes a row, and
    1024 bytes to align them for the 128-byte swizzle."""
    return STAGES * (TILE_M + n_tile) * 2 * STEP_K + 1024


def halo_pixels(w: int) -> int:
    """Pixels of a 3x3 tile's halo: its 128 consecutive pixels and one row
    and one pixel before and after them."""
    return TILE_M + 2 * w + 2


def halo_pitch(cin_g: int) -> int:
    """Bytes between halo pixels in shared memory."""
    return 2 * cin_g + 16


def halo_smem(n_tile: int, cin_g: int, k_steps: int, w: int) -> int:
    """Dynamic shared memory of the 3x3 kernel: the group's whole weights,
    the epilogue's output tile, two halos, and 1024 bytes of alignment."""
    return (1024 + k_steps * n_tile * 2 * STEP_K + TILE_M * n_tile * 2
            + 2 * halo_pixels(w) * halo_pitch(cin_g))


def conv_plan(n: int, h: int, w: int, sw: int, width: int) -> List[ConvPlan]:
    """The tiling of every convolution of a call on x [n, h, w, 3]."""
    plans = []
    out_path = {}
    for sp in conv_specs(sw, width):
        ho, wo = h >> sp.level, w >> sp.level
        cin_g, cout_g = sp.cin // sp.groups, sp.cout // sp.groups
        k = sp.ksize * sp.ksize * cin_g
        path = conv_path(sp.role, cin_g, cout_g, sp.ksize, sp.stride)
        tiles = -(-(ho * wo) // TILE_M)
        if sp.role == "out":
            # The shortcut reads the block's input: the fused kernel takes
            # it only at the width it is built for.
            if sp.name == "block0.out" and 2 * sw != width:
                path = GENERAL
            block = sp.name.split(".")[0]
            path = out_path.setdefault(block, path)
        if path == STEM0:
            smem = 4 * 29 * sw + 2 * (2 * STEM0_ROWS + 1) * (3 * w + 8)
            plan = ConvPlan(sp.name, path, STEM0_ROWS * wo, sw, 8, 1, 1,
                            FAST_THREADS, (-(-ho // STEM0_ROWS), n, 1), smem)
        elif path == RING:
            plan = ConvPlan(sp.name, path, TILE_M, cout_g, cout_g,
                            -(-k // STEP_K), STAGES, FAST_THREADS,
                            (n * tiles, sp.groups, 1), ring_smem(cout_g))
        elif path == HALO:
            k_steps = -(-k // STEP_K)
            smem = halo_smem(cout_g, cin_g, k_steps, wo)
            # Persistent blocks: two an SM (the kernel's launch bounds),
            # or one where two do not fit its shared memory.
            per_sm = max(1, min(2, SM_SMEM // (smem + 1024)))
            blocks = max(1, min(n * tiles, SM_COUNT * per_sm // sp.groups))
            plan = ConvPlan(sp.name, path, TILE_M, cout_g, cout_g, k_steps,
                            2, FAST_THREADS, (blocks, sp.groups, 1), smem)
        elif path == OUT:
            fused = sp.name.endswith("shortcut")
            has_sc = sp.name == "block0.out"
            # The 256 channels 64 at a time, or 32 where the shortcut's
            # second accumulator shares the registers: two blocks an SM.
            n_inst = 32 if has_sc or fused else 64
            tile_bytes = TILE_M * 2 * STEP_K
            # The A tile, the shortcut's A tile or the residual's, an output
            # tile of n_inst channels; one or two 256-row B tiles.
            smem = (1024 + 2 * tile_bytes + TILE_M * n_inst * 2
                    + (1 + has_sc) * cout_g * 2 * STEP_K)
            plan = ConvPlan(sp.name, path, TILE_M, cout_g, n_inst, 1, 1,
                            FAST_THREADS,
                            (0, 0, 0) if fused else (n * tiles, 1, 1),
                            0 if fused else smem,
                            "block0.out" if fused else None)
        elif path == GENERAL:
            fused = sp.name.endswith("shortcut")
            plan = ConvPlan(sp.name, path, _GEN_M, _N_TILE, 16,
                            -(-k // _K_TILE), 1, 128,
                            (0, 0, 0) if fused else
                            (-(-(n * ho * wo) // _GEN_M),
                             -(-cout_g // _N_TILE), sp.groups),
                            0 if fused else _GEN_SMEM,
                            "block0.out" if fused else None)
        plans.append(plan)
    return plans


_SCRATCH = ("stem_a", "stem_b", "pooled", "t", "y", "partial", "att", "x1",
            "x2")


def scratch_layout(n: int, h: int, w: int, sw: int,
                   width: int) -> Tuple[Dict[str, int], int]:
    """Byte offsets of the call's scratch buffers, each 256-byte aligned,
    and their total: two stem buffers (H/2 x W/2 x 2sw), the pooled stem,
    ``t`` (the first 1x1's output), ``y`` (the grouped conv's), two block
    outputs, all NHWC bfloat16; the grouped conv's per-tile channel sums
    and the attention weights in float32."""
    s1 = n * (h // 2) * (w // 2)
    s2 = n * (h // 4) * (w // 4)
    tiles = -(-((h // 4) * (w // 4)) // TILE_M)
    sizes = dict(stem_a=s1 * 2 * sw * 2, stem_b=s1 * 2 * sw * 2,
                 pooled=s2 * 2 * sw * 2, t=s2 * width * 2,
                 y=s2 * 2 * width * 2, partial=n * tiles * 2 * width * 4,
                 att=n * 2 * width * 4, x1=s2 * 4 * width * 2,
                 x2=s2 * 4 * width * 2)
    offsets, total = {}, 0
    for name in _SCRATCH:
        offsets[name] = total
        total += -(-sizes[name] // 256) * 256
    return offsets, total


def stem_stage1_scratch_bytes(n: int, h: int, w: int, sw: int,
                              width: int) -> int:
    return scratch_layout(n, h, w, sw, width)[1]


@functools.lru_cache(maxsize=64)
def _launch_plan(n: int, h: int, w: int, sw: int, width: int):
    """The C entry point's plan array (the scratch offsets, then path, grid
    x and y, shared bytes and K steps of each launched convolution) and the
    scratch size; cached, since an encoder sees a few batch sizes."""
    offsets, total = scratch_layout(n, h, w, sw, width)
    values = [offsets[name] for name in _SCRATCH]
    for plan in conv_plan(n, h, w, sw, width):
        if plan.fused_into is None:
            if plan.smem > SMEM_LIMIT:
                raise ValueError(f"{plan.name} needs {plan.smem} B of shared "
                                 f"memory (limit {SMEM_LIMIT})")
            values += [_PATH_CODES[plan.path], plan.grid[0], plan.grid[1],
                       plan.smem, plan.k_steps]
    return (ctypes.c_longlong * len(values))(*values), total


def _lib() -> ctypes.CDLL:
    lib = kernels.load("stem_stage1")
    fn = lib.stem_stage1_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
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


def _folded_paths(folded: FoldedStemStage1) -> List[str]:
    """The path each conv of ``folded`` was packed for, in conv_specs'
    order."""
    out = [fc.path for fc in folded.stem]
    for blk in folded.blocks:
        out += [blk.conv_in.path, blk.conv_split.path, blk.conv_out.path]
        if blk.shortcut is not None:
            out.append(blk.shortcut.path)
    return out


# id(folded) -> (folded, device, pointer array): the checks of a folded
# object and its 57 pointers are made once. The entry holds the object, so
# its id cannot be reused while the entry lives; a model refolds rarely.
_PREPARED: Dict[int, tuple] = {}
_PREPARED_MAX = 8


def _prepared(folded: FoldedStemStage1, device: torch.device):
    """The checked pointer array of ``folded`` for ``device``."""
    hit = _PREPARED.get(id(folded))
    if hit is not None and hit[0] is folded and hit[1] == device:
        return hit[2]
    width = folded.width
    if 2 * width > 512 or width % 2:
        raise ValueError(f"stage-1 width {width} unsupported (even, <= 256)")
    inter = max(2 * width // 4, 32)  # SplAtConv's, as the kernel derives it
    if tuple(folded.blocks[0].dense0_w.shape) != (inter, width):
        raise ValueError(f"Dense_0 must be [{inter}, {width}]")
    # Each weight must be packed for the path the plan gives its conv
    # (STEM0 and GENERAL share a layout; the paths depend on widths alone).
    same = {STEM0: GENERAL}
    want = [p.path for p in conv_plan(1, 8, 16, folded.stem_width, width)]
    got = _folded_paths(folded)
    if [same.get(p, p) for p in got] != [same.get(p, p) for p in want]:
        raise ValueError(f"the folded weights are packed for {got}, the "
                         f"kernel's plan is {want}")
    tensors = _kernel_tensors(folded)
    for t in tensors:
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError("the folded weights must be contiguous on "
                             f"{device}")
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    while len(_PREPARED) >= _PREPARED_MAX:
        _PREPARED.pop(next(iter(_PREPARED)))
    _PREPARED[id(folded)] = (folded, device, ptrs)
    return ptrs


def stem_stage1_cuda(x: torch.Tensor,
                     folded: FoldedStemStage1) -> torch.Tensor:
    """x [N, H, W, 3] bfloat16 NHWC, contiguous on a CUDA device, the folded
    weights on the same device -> [N, 4*width, H/4, W/4] bfloat16 NCHW.

    One call runs 16 CUDA kernels on the current stream (12 convolution
    launches, the max pool, three attention kernels); nothing is
    synchronised.
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
    ptrs = _prepared(folded, x.device)
    plan, scratch_bytes = _launch_plan(n, h, w, sw, width)
    lib = _lib()
    out = torch.empty((n, 4 * width, h // 4, w // 4), dtype=torch.bfloat16,
                      device=x.device)
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8,
                          device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.stem_stage1_launch(x.data_ptr(),
                                    ctypes.cast(ptrs, ctypes.c_void_p),
                                    out.data_ptr(), scratch.data_ptr(), plan,
                                    n, h, w, sw, width,
                                    kernels.current_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"stem_stage1 launch failed: CUDA error {rc}")
    return out


def _conv_fields(fc: FoldedConv) -> List[torch.Tensor]:
    return [fc.weight, fc.scale, fc.bias, fc.packed]


def fold_tensors(folded: FoldedStemStage1) -> Tuple[List[torch.Tensor], str]:
    """``folded`` as (tensors, plan): every tensor in a fixed order (each
    conv's weight, scale, bias and packed weight; each block's input conv,
    grouped conv, the four attention tensors, last conv and shortcut), and
    the rest in a string, "stem_width,width" then "stride,groups,path" per
    conv ("-" for an absent shortcut). ``folded_from`` inverts it."""
    tensors, convs = [], []

    def conv(fc):
        if fc is None:
            convs.append("-")
            return
        tensors.extend(_conv_fields(fc))
        convs.append(f"{fc.stride},{fc.groups},{fc.path}")

    for fc in folded.stem:
        conv(fc)
    for blk in folded.blocks:
        conv(blk.conv_in)
        conv(blk.conv_split)
        tensors.extend([blk.dense0_w, blk.dense0_b, blk.dense1_w,
                        blk.dense1_b])
        conv(blk.conv_out)
        conv(blk.shortcut)
    return tensors, ";".join([f"{folded.stem_width},{folded.width}"] + convs)


def folded_from(tensors, plan: str) -> FoldedStemStage1:
    """The FoldedStemStage1 of ``fold_tensors``' (tensors, plan)."""
    head, *convs = plan.split(";")
    sw, width = (int(v) for v in head.split(","))
    it, specs = iter(tensors), iter(convs)

    def conv():
        spec = next(specs)
        if spec == "-":
            return None
        stride, groups, path = spec.split(",")
        w, s, b, packed = (next(it) for _ in range(4))
        return FoldedConv(w, s, b, int(stride), int(groups), packed, path)

    stem = (conv(), conv(), conv())
    blocks = []
    for _ in range(3):
        c_in, c_split = conv(), conv()
        dense = [next(it) for _ in range(4)]
        blocks.append(FoldedBlock(c_in, c_split, *dense, conv(), conv()))
    return FoldedStemStage1(stem, tuple(blocks), sw, width)


@torch.library.custom_op("botsort_tpu_torch::stem_stage1", mutates_args=(),
                         device_types="cpu")
def stem_stage1_op(x: torch.Tensor, tensors: List[torch.Tensor],
                   plan: str) -> torch.Tensor:
    """K4 as a custom op on ``fold_tensors``' (tensors, plan): the plain
    version on the CPU, the kernel on the card (registered below)."""
    return stem_stage1_plain(x, folded_from(tensors, plan))


@stem_stage1_op.register_kernel("cuda")
def _stem_stage1_op_cuda(x, tensors, plan):
    return stem_stage1_cuda(x.contiguous(), folded_from(tensors, plan))


@stem_stage1_op.register_fake
def _stem_stage1_op_fake(x, tensors, plan):
    width = int(plan.split(";")[0].split(",")[1])
    n, h, w, _ = x.shape
    return x.new_empty((n, 4 * width, h // 4, w // 4), dtype=torch.bfloat16)


def stem_stage1(x: torch.Tensor, folded: FoldedStemStage1) -> torch.Tensor:
    """Stem + stage 1: x [N, H, W, 3] bfloat16 NHWC -> [N, 4*width, H/4,
    W/4] bfloat16 NCHW. CUDA tensors launch K4, CPU tensors take the plain
    version; under a trace, the custom op."""
    if tracing():
        return stem_stage1_op(x, *fold_tensors(folded))
    if x.is_cuda:
        return stem_stage1_cuda(x.contiguous(), folded)
    if x.device.type == "cpu":
        return stem_stage1_plain(x, folded)
    raise ValueError(f"stem_stage1: no kernel for device {x.device}")
