"""Channels-last activations, as far as the CPU can check them.

Kernel K6's channels-innermost path (csrc/bn_act.cu::bn_act_kernel_cl):
its plain version keeps a channels-last layout, its launch plan
(``bn_act_cl_plan``) covers every element once with the vector width,
scalar fallback and alignment rules the kernel takes, and the path follows
x's strides (``bn_act_path``). The four networks: on the card
``cast_compute`` lays their convolution weights out channels-last;
here the same modules with channels-last weights give the outputs of the NCHW ones (a float32 CPU convolution in
either layout sums in another order: the tolerances of tests/
test_torch_models.py and tests/test_torch_transreid.py), and every norm of
a channels-last network reads a channels-last activation, so no layout
copy comes back between them. The kernel itself runs on the card in
tests/test_torch_cuda.py.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from botsort_tpu_torch.models import bn_act, common, fastreid, yolox
from botsort_tpu_torch.models.transreid import TransReID
from botsort_tpu_torch.runtime import assets

CL = torch.channels_last


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm_inputs(rng, shape, dtype):
    c = shape[1]
    x = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32)).to(dtype)
    mean = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32))
    mul = torch.from_numpy(rng.uniform(0.3, 1.8, c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32))
    return x, mean, mul, bias


@pytest.mark.parametrize("act", bn_act.ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_version_keeps_a_channels_last_layout(dtype, act):
    """bn_act_plain (and the CPU route of bn_act) on a channels-last x:
    the values of the contiguous copy's result, laid out as x is; SiLU
    within one unit in the last place (ATen's CPU SiLU takes its vector
    and scalar exponentials at other elements in another layout)."""
    x, mean, mul, bias = _norm_inputs(np.random.default_rng(1),
                                      (3, 24, 5, 7), dtype)
    x_cl = x.to(memory_format=CL)
    want = bn_act.bn_act_plain(x, mean, mul, bias, act)
    for fn in (bn_act.bn_act_plain, bn_act.bn_act):
        got = fn(x_cl, mean, mul, bias, act)
        assert got.is_contiguous(memory_format=CL)
        assert not got.is_contiguous()
        if act == "silu":
            assert _ulp_apart(got, want) <= 1
        else:
            assert torch.equal(got, want)


def _ulp_apart(got, want):
    """Largest distance of two tensors of one floating dtype in units in
    the last place (their bit patterns as ordered integers)."""
    int_t = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    mask = 2 ** (8 * got.element_size() - 1) - 1
    a, b = (t.contiguous().view(int_t).to(torch.int64) for t in (got, want))
    a, b = (torch.where(t < 0, -(t & mask), t) for t in (a, b))
    return int((a - b).abs().max())


def _visits(rows, channels, vec, tile, per_block, grid):
    """How often csrc/bn_act.cu::bn_act_kernel_cl touches each element of
    x [rows, channels] under this launch: its index arithmetic, thread by
    thread, in numpy."""
    grid_x, tiles = grid
    t = np.arange(tile * per_block)
    bx, by, t = np.meshgrid(np.arange(grid_x), np.arange(tiles), t,
                            indexing="ij")
    col = (by * tile + t % tile).ravel()
    r0 = (bx * per_block + t // tile).ravel()
    live = col * vec < channels
    col, r0 = col[live], r0[live]
    stride = grid_x * per_block
    count = np.zeros((rows, channels), np.int64)
    for k in range(-(-rows // stride)):
        r = r0 + k * stride
        keep = r < rows
        for j in range(vec):
            np.add.at(count, (r[keep], col[keep] * vec + j), 1)
    return count


@pytest.mark.parametrize("rows,channels,itemsize,aligned,vec", [
    (19200, 160, 2, True, 8),  # the one-frame detector at 120x160
    (300, 1280, 2, True, 8),   # its 15x20 plane, C = 1280: five warps
    (50, 2560, 2, True, 8),    # 320 columns: two tiles
    (128, 2048, 4, True, 4),   # the BNNeck, [N, C] float32: two tiles
    (7, 24, 2, True, 8),       # three columns a row
    (35, 7, 2, True, 1),       # C % 8 != 0: a channel a thread
    (12, 20, 2, True, 1),      # C % 8 != 0 in bfloat16 ...
    (12, 20, 4, True, 4),      # ... but whole float32 vectors
    (64, 64, 2, False, 1),     # an unaligned pointer
    (5, 3000, 4, True, 4),     # 750 columns: three tiles of 250
    (1, 1, 4, True, 1),
])
def test_channels_last_plan_covers_every_element_once(rows, channels,
                                                      itemsize, aligned,
                                                      vec):
    plan = bn_act.bn_act_cl_plan(rows, channels, itemsize, aligned)
    got_vec, tile, per_block, (grid_x, tiles) = plan
    assert got_vec == vec
    assert 16 % (vec * itemsize) == 0 and channels % vec == 0
    assert tile * per_block <= bn_act.THREADS and per_block >= 1
    assert 1 <= grid_x <= max(1, bn_act.CL_TARGET_BLOCKS // tiles)
    # Tiles of columns: enough, and none empty.
    assert tiles * tile * vec >= channels > (tiles - 1) * tile * vec
    assert (_visits(rows, channels, *plan) == 1).all()


def test_channels_last_plan_fills_the_card_at_the_busiest_shapes():
    """At the 8-stream detector stem, 614,400 rows of 80 bfloat16
    channels, the launch covers the card once and a thread walks rows:
    its parameters load once for up to 47 of them."""
    vec, tile, per_block, (grid_x, tiles) = bn_act.bn_act_cl_plan(
        8 * 240 * 320, 80, 2)
    assert (vec, tile, per_block, tiles) == (8, 10, 25, 1)
    assert grid_x == bn_act.CL_TARGET_BLOCKS
    assert -(-8 * 240 * 320 // (grid_x * per_block)) == 47


@pytest.mark.parametrize("make,path", [
    (lambda: torch.empty(2, 8, 3, 5), "contiguous"),
    (lambda: torch.empty(2, 8, 3, 5).to(memory_format=CL), "channels_last"),
    (lambda: torch.empty(4, 8), "channels_last"),          # [N, C]
    (lambda: torch.empty(4, 8, 1, 1), "channels_last"),    # inner = 1
    (lambda: torch.empty(2, 1, 3, 5), "contiguous"),        # C = 1
    (lambda: torch.empty(2, 8, 3, 4, 5).to(
        memory_format=torch.channels_last_3d), "channels_last"),
    (lambda: torch.empty(2, 8, 3, 5).permute(0, 1, 3, 2), None),
    (lambda: torch.empty(2, 8, 6, 5).to(memory_format=CL)[:, :, ::2], None),
    (lambda: torch.empty(8, 4).t(), None),
])
def test_the_path_follows_the_strides(make, path):
    x = make()
    if path is None:
        with pytest.raises(ValueError, match="channels innermost"):
            bn_act.bn_act_path(x)
    else:
        assert bn_act.bn_act_path(x) == path


def test_cast_compute_keeps_the_layout_of_cpu_modules():
    """On the CPU cast_compute leaves the weights' layout alone (on the
    card it lays the convolution weights out channels-last)."""
    face = assets.build_bundle(mini=True, device="cpu",
                               dtype=torch.float32).face_encoder
    common.cast_compute(face, torch.bfloat16)
    convs = [m for m in face.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.weight.is_contiguous() and m.weight.dtype == torch.bfloat16
               for m in convs)


def test_upsampling_copies_each_element_in_its_layout():
    x = torch.randn(2, 6, 3, 5)
    want = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    for t in (x, x.to(memory_format=CL)):
        got = yolox._up(t)
        assert torch.equal(got, want)
        assert got.is_contiguous(memory_format=torch.channels_last) == \
            t.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chained_spp_pools_equal_the_wide_pools(dtype):
    """SPP's 9- and 13-wide pools as 5-wide pools of the pool before:
    bit-equal to the wide pools (max is exact), at the detector's 15x20
    planes and an odd one, in either layout."""
    torch.manual_seed(5)
    spp = common.cast_compute(common.SPPBottleneck(16, 16), dtype)
    spp.eval().requires_grad_(False)
    for shape in ((2, 16, 15, 20), (1, 16, 7, 4)):
        x = torch.randn(shape).to(dtype)
        y = spp.ConvBN_0(x)
        want = [y] + [F.max_pool2d(y, k, 1, k // 2) for k in (5, 9, 13)]
        want = spp.ConvBN_1(torch.cat(want, dim=1))
        for t in (x, x.to(memory_format=CL)):
            assert torch.equal(spp(t), want)
    with pytest.raises(ValueError, match="odd and increasing"):
        common.SPPBottleneck(16, 16, (5, 13, 9))


def test_split_attention_sums_are_the_radix_sums():
    """SplAt's channel-slice adds are the old sums over the radix axis,
    bit for bit in bfloat16 (one float32 add of two splits, rounded)."""
    torch.manual_seed(3)
    m = common.cast_compute(fastreid.SplAtConv(16, 16), torch.bfloat16)
    m.eval().requires_grad_(False)
    x = torch.randn(3, 16, 6, 5).to(torch.bfloat16)
    y = m._ConvBN_0(x)
    b, _, h, w = y.shape
    splits = y.view(b, 2, -1, h, w)
    gap = splits.sum(dim=1).mean(dim=(2, 3))
    z = m.BatchNorm_0(m.Dense_0(gap), "relu")
    atten = torch.softmax(m.Dense_1(z).view(b, 2, -1).float(), dim=1)
    want = (splits * atten.to(y.dtype)[..., None, None]).sum(dim=1)
    assert torch.equal(m(x), want)


def _nchw_memory(images):
    """NHWC images whose permute to [N, C, H, W] is contiguous: the
    networks then run NCHW from their first convolution."""
    return images.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def _networks():
    mini = assets.build_bundle(mini=True, device="cpu", dtype=torch.float32,
                               seed=7)
    torch.manual_seed(7)
    trans = TransReID(embed_dim=64, depth=3, heads=4, input_hw=(64, 32))
    return {"detector": (mini.detector, (2, 96, 128), 1e-4),
            "body": (mini.body_encoder, (3, 64, 32), 1e-4),
            "face": (mini.face_encoder, (3, 32, 32), 1e-4),
            "transreid": (trans.eval(), (3, 64, 32), 2e-6)}


@pytest.mark.parametrize("name", ["detector", "body", "face", "transreid"])
def test_a_channels_last_network_equals_the_nchw_one(name):
    model, (n, h, w), tol = _networks()[name]
    model.requires_grad_(False)
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.uniform(-2, 2, (n, h, w, 3))
                              .astype(np.float32))
    if name == "detector":
        images = images * 60 + 120
    cl = copy.deepcopy(model).to(memory_format=CL)
    seen = {"nchw": [], "cl": []}

    def record(key):
        def hook(module, args):
            x = args[0]
            seen[key].append((x.dim() == 4 and x.shape[1] > 1
                              and x.shape[2] * x.shape[3] > 1,
                              x.is_contiguous(),
                              bn_act.channels_innermost(x)))
        return hook

    handles = [m.register_forward_pre_hook(record(key))
               for key, net in (("nchw", model), ("cl", cl))
               for m in net.modules() if isinstance(m, common.BatchNorm)]
    try:
        with torch.no_grad():
            want = model(_nchw_memory(images))
            got = cl(images)
    finally:
        for h in handles:
            h.remove()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, wt in zip(got, want):
        assert g.shape == wt.shape
        torch.testing.assert_close(g, wt, rtol=tol if tol > 1e-5 else 0,
                                   atol=tol)
    assert len(seen["cl"]) == len(seen["nchw"])
    # Every norm of the channels-last network reads channels innermost, and
    # every planar one of the NCHW network a contiguous tensor.
    assert all(inner for _, _, inner in seen["cl"])
    assert all(contig for planar, contig, _ in seen["nchw"] if planar)
    if name != "transreid":  # TransReID's norms are LayerNorms
        assert any(planar and not contig for planar, contig, _ in seen["cl"])
