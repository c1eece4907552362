"""Kernels K1-K6 on the card, against their plain PyTorch versions, and
the frame step replayed from a CUDA graph against the eager step.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card
and skips without one. The file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.models import bn_act, facereid, facereid_dw, fastreid
from botsort_tpu_torch.models import fastreid_fused
from botsort_tpu_torch.models.common import cast_compute
from botsort_tpu_torch.ops import assignment, assignment_cuda
from botsort_tpu_torch.pipeline import frame_step as fs
from botsort_tpu_torch.pipeline import host
from botsort_tpu_torch.runtime import assets, kernels

pytestmark = pytest.mark.cuda

LIMITS = (0.8, 0.5, 0.7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _instance(rng, n, d, p_row=0.6, p_col=0.6, quantum=None):
    costs = [rng.uniform(0, 1, (n, d)).astype(np.float32) for _ in range(3)]
    if quantum:
        costs = [(np.round(c / quantum) * quantum).astype(np.float32)
                 for c in costs]
    pool = rng.uniform(0, 1, n) < p_row
    tracked = pool & (rng.uniform(0, 1, n) < 0.7)
    unconf = (~pool) & (rng.uniform(0, 1, n) < 0.4 * p_row / 0.6)
    high = rng.uniform(0, 1, d) < p_col
    low = (~high) & (rng.uniform(0, 1, d) < 0.5)
    return (*costs, pool, tracked, unconf, high, low)


def _kernel_and_plain(inst, dev):
    tensors = [torch.from_numpy(a).to(dev) for a in inst]
    costs, masks, big = assignment.prepare_cascade(*tensors, LIMITS)
    args = (costs[None], masks[None], big[None], LIMITS)
    got = assignment_cuda.cascade_solve_cuda(*args)
    want = assignment.cascade_solve_plain(*args)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("n,d,quantum", [
    (64, 50, None), (64, 50, 0.05), (12, 9, None), (5, 14, None),
    (16, 16, 0.05), (3, 2, None), (1, 1, None)])
def test_k1_equals_plain(dev, n, d, quantum):
    rng = np.random.default_rng(n * 1000 + d)
    for _ in range(3):
        got, want = _kernel_and_plain(
            _instance(rng, n, d, quantum=quantum), dev)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_k1_strided_lanes_equal_plain(dev):
    """N + D > 1024: more columns than threads, each thread strides."""
    rng = np.random.default_rng(3)
    got, want = _kernel_and_plain(
        _instance(rng, 700, 400, p_row=0.05, p_col=0.1), dev)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,d", [(128, 128), (128, 129), (200, 56),
                                 (56, 201)])
def test_k1_warp_and_block_equal_plain(dev, n, d):
    """N + D = 256 (one warp, 8 columns a lane) and 257 (one block): the
    two instantiations of the pop loop."""
    rng = np.random.default_rng(n + 7 * d)
    for _ in range(2):
        got, want = _kernel_and_plain(
            _instance(rng, n, d, p_row=0.5, p_col=0.5, quantum=0.05), dev)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_k2_uneven_streams_equal_plain(dev):
    """Eight streams whose pop counts differ widely (live rows from none
    to nearly all), one warp each: equal to the plain version."""
    rng = np.random.default_rng(12)
    insts = [_instance(rng, 64, 50, p_row=p, p_col=p)
             for p in (0.0, 0.05, 0.2, 0.4, 0.6, 0.8, 0.95, 1.0)]
    batched = [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*insts)]
    costs, masks, big = assignment.prepare_cascade(*batched, LIMITS)
    got = assignment_cuda.cascade_solve_cuda(costs, masks, big, LIMITS)
    want = assignment.cascade_solve_plain(costs, masks, big, LIMITS)
    torch.cuda.synchronize()
    for k in range(2):
        assert torch.equal(got[k], want[k])


def test_wrappers_launch_on_the_current_stream(dev):
    """The raw handle every wrapper passes is the current stream's, on
    the default stream and inside a side stream."""
    assert kernels.current_stream(dev) == \
        torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert kernels.current_stream(dev) == side.cuda_stream


def test_dispatcher_launches_k1_for_cuda_tensors(dev):
    inst = _instance(np.random.default_rng(4), 64, 50)
    before = assignment_cuda.cascade_solve_cuda.launches
    got = assignment.solve_cascade_masked(
        *[torch.from_numpy(a).to(dev) for a in inst], LIMITS)
    assert assignment_cuda.cascade_solve_cuda.launches == before + 1
    want = assignment.solve_cascade_masked(
        *[torch.from_numpy(a) for a in inst], LIMITS)
    for g, w in zip(got, want):
        assert torch.equal(g.col_for_row.cpu(), w.col_for_row)
        assert torch.equal(g.row_for_col.cpu(), w.row_for_col)


def test_wrapper_rejects_malformed_inputs(dev):
    inst = _instance(np.random.default_rng(5), 6, 5)
    costs, masks, big = assignment.prepare_cascade(
        *[torch.from_numpy(a).to(dev) for a in inst], LIMITS)
    good = (costs[None], masks[None], big[None])
    bad = [
        (good[0].double(), good[1], good[2]),
        (good[0], good[1].long(), good[2]),
        (good[0], good[1][:, :-1], good[2]),
        (good[0].transpose(2, 3).contiguous().transpose(2, 3), good[1],
         good[2]),
        (good[0], good[1].cpu(), good[2]),
    ]
    before = assignment_cuda.cascade_solve_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            assignment_cuda.cascade_solve_cuda(*args, LIMITS)
    assert assignment_cuda.cascade_solve_cuda.launches == before


def test_k2_batch_equals_plain_and_k1(dev):
    """Eight streams at the main path's shape in one launch (K2): equal to
    the plain version and to eight one-stream launches (K1). One stream
    has no live rows."""
    rng = np.random.default_rng(6)
    insts = [_instance(rng, 64, 50) for _ in range(8)]
    insts[3] = _instance(rng, 64, 50, p_row=0.0)
    batched = [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*insts)]
    costs, masks, big = assignment.prepare_cascade(*batched, LIMITS)
    before = (assignment_cuda.cascade_solve_cuda.launches,
              assignment_cuda.cascade_solve_cuda.batched_launches)
    got = assignment_cuda.cascade_solve_cuda(costs, masks, big, LIMITS)
    assert assignment_cuda.cascade_solve_cuda.batched_launches == \
        before[1] + 1
    want = assignment.cascade_solve_plain(costs, masks, big, LIMITS)
    singles = [assignment_cuda.cascade_solve_cuda(
        costs[b:b + 1], masks[b:b + 1], big[b:b + 1], LIMITS)
        for b in range(8)]
    assert assignment_cuda.cascade_solve_cuda.launches == before[0] + 8
    torch.cuda.synchronize()
    for k in range(2):
        assert torch.equal(got[k], want[k])
        assert torch.equal(got[k], torch.cat([s[k] for s in singles]))


def _jv_problem(rng, s, n_live, quantum=None):
    ext = rng.uniform(0, 1, (s, s)).astype(np.float32)
    if quantum:
        ext = (np.round(ext / quantum) * quantum).astype(np.float32)
    p0 = np.where(np.arange(s) < n_live, -1, np.arange(s)).astype(np.int32)
    live_order = np.where(np.arange(s) < n_live, np.arange(s),
                          s).astype(np.int32)
    return ext, p0, live_order, np.int32(n_live)


@pytest.mark.parametrize("s,n_live,quantum", [
    (24, 7, None), (24, 0, None), (114, 60, None), (114, 114, 0.05),
    (5, 5, None), (1, 1, None), (1100, 40, None), (256, 200, 0.05),
    (257, 200, 0.05), (240, 120, None)])
def test_k3_equals_plain(dev, s, n_live, quantum):
    """Square solves: one warp up to S = 256 (S = 240 too wide to stage
    in shared memory), one block from 257, S > 1024 included."""
    rng = np.random.default_rng(s + n_live)
    probs = [_jv_problem(rng, s, n_live, quantum) for _ in range(3)]
    args = [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*probs)]
    got = assignment_cuda.jv_solve_cuda(*args)
    want = assignment.jv_solve_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sorted(got[0].tolist()) == list(range(s))


def test_solve_masked_launches_k3_for_cuda_tensors(dev):
    rng = np.random.default_rng(8)
    cost = rng.uniform(0, 1.2, (64, 50)).astype(np.float32)
    rv, cv = rng.uniform(0, 1, 64) < 0.7, rng.uniform(0, 1, 50) < 0.7
    before = assignment_cuda.jv_solve_cuda.launches
    got = assignment.solve_masked(
        *[torch.from_numpy(a).to(dev) for a in (cost, rv, cv)], 0.8)
    assert assignment_cuda.jv_solve_cuda.launches == before + 1
    want = assignment.solve_masked(
        *[torch.from_numpy(a) for a in (cost, rv, cv)], 0.8)
    assert torch.equal(got.col_for_row.cpu(), want.col_for_row)
    assert torch.equal(got.row_for_col.cpu(), want.row_for_col)


def test_jv_wrapper_rejects_malformed_inputs(dev):
    rng = np.random.default_rng(9)
    good = [torch.from_numpy(np.stack(x)).to(dev)
            for x in zip(_jv_problem(rng, 12, 5))]
    ext, p0, order, n_live = good
    bad = [
        (ext.double(), p0, order, n_live),
        (ext[:, :, :-1], p0, order, n_live),
        (ext, p0.long(), order, n_live),
        (ext, p0, order[:, :-1], n_live),
        (ext, p0, order, n_live.cpu()),
        (ext.transpose(1, 2), p0, order, n_live),
    ]
    before = assignment_cuda.jv_solve_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            assignment_cuda.jv_solve_cuda(*args)
    assert assignment_cuda.jv_solve_cuda.launches == before


# The face encoder's 13 stride-1 depthwise layers at 128x128, (H, W, C).
FACE_DW_SHAPES = [(64, 64, 32), (32, 32, 144), (16, 16, 192),
                  (16, 16, 192)] + [(8, 8, 384)] * 4 + [(8, 8, 576)] * 2 + [
                      (4, 4, 960)] * 3


def _dw_case(rng, shape, dtype, dev):
    n, c, h, w = shape
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    taps = torch.from_numpy(rng.normal(size=(9, c)).astype(np.float32))
    return x.to(dev, dtype), taps.to(dev)


@pytest.mark.parametrize("shape,dtype", [
    *[((50, c, h, w), torch.bfloat16) for h, w, c in FACE_DW_SHAPES[:2]],
    ((50, 960, 4, 4), torch.bfloat16),
    ((1, 8, 9, 13), torch.float32), ((1, 8, 9, 13), torch.bfloat16),
    ((4, 130, 6, 10), torch.float32), ((4, 130, 6, 10), torch.bfloat16),
    ((2, 1100, 5, 7), torch.bfloat16), ((1, 3, 40, 1500), torch.float32),
    ((2, 20, 40, 8), torch.bfloat16), ((2, 20, 24, 16), torch.bfloat16),
    ((3, 40, 12, 24), torch.bfloat16), ((1, 100, 16, 16), torch.bfloat16),
    ((2, 33, 4, 4), torch.bfloat16), ((2, 12, 6, 2), torch.float32),
    ((1, 5, 300, 8), torch.float32)])
def test_k5_equals_plain(dev, shape, dtype):
    """Bit for bit: the same float32 multiplies and adds in the same
    order, none contracted (C > 1024, a plane wider than a tile, widths 8,
    16 and 24, a partial span of planes, and 4-wide bfloat16 and 2-wide
    float32 planes on the scalar path included)."""
    x, taps = _dw_case(np.random.default_rng(shape[1]), shape, dtype, dev)
    got = facereid_dw.dw_conv3x3_cuda(x, taps)
    want = facereid_dw.dw_conv3x3_plain(x, taps)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


def test_k5_unaligned_input_takes_the_scalar_path(dev):
    """An input that does not start on a 16-byte boundary: equal to the
    plain version."""
    x, taps = _dw_case(np.random.default_rng(2), (1, 6, 8, 16),
                       torch.bfloat16, dev)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    x_off = flat[1:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 != 0
    got = facereid_dw.dw_conv3x3_cuda(x_off, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, facereid_dw.dw_conv3x3_plain(x, taps))


def test_face_kernel_mode_launches_k5_per_layer(dev):
    """FaceReID(dw_mode="kernel") at full width: 13 K5 launches per call,
    features equal to the same model with K5 replaced by its plain
    version on the card."""
    rng = np.random.default_rng(21)
    face = assets.seeded_init_(facereid.FaceReID(dw_mode="kernel"), rng)
    face = cast_compute(face, torch.bfloat16).to(dev).eval()
    img = torch.from_numpy(rng.uniform(0, 255, (4, 128, 128, 3)).astype(
        np.float32)).to(dev)
    before = facereid_dw.dw_conv3x3_cuda.launches
    with torch.no_grad():
        got = face(img)
    assert facereid_dw.dw_conv3x3_cuda.launches == before + 13
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(facereid_dw, "dw_conv3x3_cuda",
                   facereid_dw.dw_conv3x3_plain)
        want = face(img)
    assert torch.equal(got, want)


def test_k5_wrapper_rejects_malformed_inputs(dev):
    x, taps = _dw_case(np.random.default_rng(1), (2, 16, 8, 8),
                       torch.bfloat16, dev)
    bad = [(x.half(), taps), (x, taps.double()), (x, taps[:, :-1]),
           (x.transpose(2, 3), taps), (x.cpu(), taps), (x, taps.cpu()),
           (x[0], taps)]
    before = facereid_dw.dw_conv3x3_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            facereid_dw.dw_conv3x3_cuda(*args)
    assert facereid_dw.dw_conv3x3_cuda.launches == before


def _trunk(dev, seed, **layout):
    """A ResNeSt50 with seeded weights and perturbed norms, bfloat16."""
    rng = np.random.default_rng(seed)
    model = fastreid.ResNeSt50(fused_stem=True, **layout)
    assets.perturb_norms_(assets.seeded_init_(model, rng), rng)
    return cast_compute(model, torch.bfloat16).to(dev).eval()


def _rel(got, want):
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm().clamp(min=1e-6))
    worst = float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-6))
    return rel, worst


@pytest.mark.parametrize("n,h,w,layout", [
    (2, 256, 128, dict(stage_blocks=(3, 1, 1, 1))),
    (3, 384, 128, dict(stage_blocks=(3, 1, 1, 1))),
    (2, 32, 16, dict(stage_blocks=(3, 1, 1, 1), stage_widths=(8, 16, 32, 64),
                     stem_width=8))])
def test_k4_close_to_plain(dev, n, h, w, layout):
    """Full width at both body geometries, and the SMALL preset (its
    grouped conv has 4 input channels a group: the general WMMA path).
    Relative L2 1e-2, no element off by more than 5% of the largest."""
    model = _trunk(dev, 7, **layout)
    folded = model.folded_stem_stage1()
    x = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, (n, h, w, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    got = fastreid_fused.stem_stage1_cuda(x, folded)
    want = fastreid_fused.stem_stage1_plain(x, folded)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    rel, worst = _rel(got, want)
    assert rel <= 1e-2 and worst <= 0.05, (rel, worst)


FULL_STEM = dict(stage_blocks=(3, 1, 1, 1))


def _k4_input(dev, seed, n, h, w):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (n, h, w, 3)).astype(np.float32)).to(dev, torch.bfloat16)


@pytest.mark.parametrize("n,h,w", [
    (1, 256, 128),      # fewer tiles than persistent blocks
    (3, 40, 16),        # 40 stage-1 pixels an image: one partial tile
    (5, 72, 24),        # 432 and 108 pixels: partial last tiles, odd N
    (128, 256, 128)])   # the lowered 8-stream step's batch
def test_k4_close_to_plain_across_batches(dev, n, h, w):
    model = _trunk(dev, 12, **FULL_STEM)
    folded = model.folded_stem_stage1()
    x = _k4_input(dev, 13, n, h, w)
    got = fastreid_fused.stem_stage1_cuda(x, folded)
    want = fastreid_fused.stem_stage1_plain(x, folded)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, 256, h // 4, w // 4)
    rel, worst = _rel(got, want)
    assert rel <= 1e-2 and worst <= 0.05, (rel, worst)


def test_k4_block0_shortcut_fusion(dev):
    """Block 0's shortcut made to dominate its output (batch-norm scale x4,
    bias +1): the fused second product must carry it."""
    model = _trunk(dev, 14, **FULL_STEM)
    x = _k4_input(dev, 15, 3, 256, 128)
    before = fastreid_fused.stem_stage1_cuda(x, model.folded_stem_stage1())
    with torch.no_grad():
        bn = model.SplAtBottleneck_0._ConvBN_2.BatchNorm_0
        bn.weight.mul_(4.0)
        bn.bias.add_(1.0)
    folded = model.folded_stem_stage1()
    got = fastreid_fused.stem_stage1_cuda(x, folded)
    want = fastreid_fused.stem_stage1_plain(x, folded)
    torch.cuda.synchronize()
    rel, worst = _rel(got, want)
    assert rel <= 1e-2 and worst <= 0.05, (rel, worst)
    assert _rel(got, before)[0] > 0.1    # the perturbation shows


@pytest.mark.parametrize("n,h,w", [(7, 256, 128), (3, 40, 16)])
def test_k4_is_deterministic(dev, n, h, w):
    """No atomics anywhere: two calls on one input give the same bits."""
    model = _trunk(dev, 16, **FULL_STEM)
    folded = model.folded_stem_stage1()
    x = _k4_input(dev, 17, n, h, w)
    first = fastreid_fused.stem_stage1_cuda(x, folded)
    second = fastreid_fused.stem_stage1_cuda(x, folded)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_trunk_launches_k4_once(dev):
    model = _trunk(dev, 9, stage_blocks=(3, 1, 1, 1))
    x = torch.from_numpy(np.random.default_rng(10).normal(
        0, 1, (2, 3, 256, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    before = fastreid_fused.stem_stage1_cuda.launches
    with torch.no_grad():
        got = model(x)
    assert fastreid_fused.stem_stage1_cuda.launches == before + 1
    model.fused_stem = False
    with torch.no_grad():
        want = model(x)
    rel, worst = _rel(got, want)
    assert rel < 3e-2 and worst < 0.15, (rel, worst)


def test_k4_wrapper_rejects_malformed_inputs(dev):
    model = _trunk(dev, 11, stage_blocks=(3, 1, 1, 1),
                   stage_widths=(8, 16, 32, 64), stem_width=8)
    folded = model.folded_stem_stage1()
    x = torch.zeros((1, 32, 16, 3), dtype=torch.bfloat16, device=dev)
    cpu_folded = fastreid_fused.fold_stem_stage1(model.cpu())
    bad = [(x.float(), folded), (x.transpose(1, 2), folded),
           (x.cpu(), folded), (x[..., :2].contiguous(), folded),
           (torch.zeros((1, 32, 12, 3), dtype=torch.bfloat16, device=dev),
            folded), (x, cpu_folded)]
    before = fastreid_fused.stem_stage1_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            fastreid_fused.stem_stage1_cuda(*args)
    assert fastreid_fused.stem_stage1_cuda.launches == before


# --- K6: batch norm + activation ------------------------------------------


def _bn_inputs(rng, shape, dtype, dev):
    c = shape[1]
    x = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32)).to(
        dev, dtype)
    mean, bias = (torch.from_numpy(rng.normal(0, 0.5, c).astype(
        np.float32)).to(dev) for _ in range(2))
    mul = torch.from_numpy(rng.uniform(0.3, 2.0, c).astype(np.float32)).to(
        dev)
    return x, mean, mul, bias


def _ulp_apart(got, want):
    """Largest distance of two tensors of one floating dtype, in units in
    the last place (the bit patterns as ordered integers)."""
    int_t = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    a, b = (t.contiguous().view(int_t).to(torch.int64) for t in (got, want))
    a, b = (torch.where(t < 0, -(t & (2 ** (8 * got.element_size() - 1) - 1)),
                        t) for t in (a, b))
    return int((a - b).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (8, 80, 240, 320),   # the detector's stem at 8 streams
    (2, 1280, 15, 20),   # inner = 300: vectors straddle channels
    (128, 64, 64, 32),   # the body encoder's stage 1
    (50, 32, 64, 64),    # the face encoder's stem
    (128, 32),           # a dense layer's norm, [N, C]
    (3, 7, 5, 3),        # odd everything, a tail after the last vector
    (1, 1, 1, 1),
])
def test_k6_equals_plain(dev, shape, dtype):
    """none / ReLU / ReLU6 bit for bit; SiLU within one unit in the last
    place of the dtype (the two exponentials may round differently)."""
    rng = np.random.default_rng(sum(shape))
    x, mean, mul, bias = _bn_inputs(rng, shape, dtype, dev)
    for act in bn_act.ACTS:
        before = bn_act.bn_act_cuda.launches
        got = bn_act.bn_act(x, mean, mul, bias, act)
        assert bn_act.bn_act_cuda.launches == before + 1
        want = bn_act.bn_act_plain(x, mean, mul, bias, act)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == x.dtype
        if act == "silu":
            assert _ulp_apart(got, want) <= 1, act
        else:
            assert torch.equal(got, want), act


def test_k6_unaligned_view_and_nan(dev):
    """A contiguous view that starts off a 16-byte boundary takes the
    scalar path; NaN passes through every activation as in the plain
    version."""
    rng = np.random.default_rng(9)
    x, mean, mul, bias = _bn_inputs(rng, (5, 6, 4, 4), torch.bfloat16, dev)
    view = x.flatten()[16 * 6 + 0:].view(4, 6, 4, 4)
    odd = x.flatten()[3:3 + 4 * 6 * 16].view(4, 6, 4, 4)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    for t in (view, odd):
        t = t.clone() if t is view else t
        for act in ("none", "relu", "relu6"):
            assert torch.equal(bn_act.bn_act_cuda(t, mean, mul, bias, act),
                               bn_act.bn_act_plain(t, mean, mul, bias, act))
    x[0, 0, 0, 0] = float("nan")
    for act in bn_act.ACTS:
        got = bn_act.bn_act_cuda(x, mean, mul, bias, act)
        want = bn_act.bn_act_plain(x, mean, mul, bias, act)
        assert torch.isnan(got[0, 0, 0, 0]) and torch.isnan(want[0, 0, 0, 0])


def test_k6_refuses_what_it_does_not_take(dev):
    x, mean, mul, bias = _bn_inputs(np.random.default_rng(1), (2, 4, 3, 3),
                                    torch.float32, dev)
    with pytest.raises(ValueError):
        bn_act.bn_act_cuda(x.cpu(), mean, mul, bias)
    with pytest.raises(ValueError):
        bn_act.bn_act_cuda(x.half(), mean, mul, bias)
    with pytest.raises(ValueError):
        bn_act.bn_act_cuda(x, mean[:3], mul, bias)
    with pytest.raises(ValueError):
        bn_act.bn_act_cuda(x.permute(0, 1, 3, 2), mean, mul, bias)
    with pytest.raises(ValueError):
        bn_act.bn_act_cuda(x, mean, mul, bias, "gelu")


def test_batchnorm_mul_cache_follows_the_statistics(dev):
    from botsort_tpu_torch.models.common import BatchNorm

    bn = BatchNorm(8, 1e-3).to(dev).eval()
    x = torch.randn(2, 8, 4, 4, device=dev)
    first = bn(x, "relu")
    assert bn.mul() is bn.mul()
    with torch.no_grad():
        bn.running_var.fill_(4.0)
    second = bn(x, "relu")
    assert not torch.equal(first, second)
    want = torch.relu((x - bn.running_mean.view(1, -1, 1, 1))
                      * (torch.rsqrt(bn.running_var + 1e-3)
                         * bn.weight).view(1, -1, 1, 1)
                      + bn.bias.view(1, -1, 1, 1))
    assert torch.equal(second, want)


# --- the step under a CUDA graph and without synchronisation --------------

MINI_TRK = TrackerConfig(
    max_tracks=16, body_feature_dim=256, face_feature_dim=256,
    det_score_threshold=0.05, track_high_thresh=0.22, track_low_thresh=0.05,
    new_track_thresh=0.24, max_dets=8)
MINI_NMS = NMSConfig(max_boxes_per_class=8, score_threshold=0.01)
MINI_PIPE = PipelineConfig(detector_input_hw=(96, 128),
                           body_reid_input_hw=(64, 32),
                           face_reid_input_hw=(32, 32), max_reid_batch=4)


def _mini_frames(n, b, seed):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        img = rng.integers(0, 255, (b, 240, 320, 3), dtype=np.uint8)
        for k in range(3):
            x = 30 + 90 * k + 4 * t
            img[:, 60:200, x:x + 50] = (40 + 70 * k, 200, 120)
        out.append(img)
    return out


def _same_result(a, b):
    for name, x, y in zip(a._fields[:-1], a[:-1], b[:-1]):
        assert np.array_equal(x, y), name
    for name, x, y in zip(a.tracks._fields, a.tracks, b.tracks):
        assert np.array_equal(x, y), f"tracks.{name}"


@pytest.mark.parametrize("streams", [1, 3])
def test_mini_graphed_step_equals_eager(dev, streams):
    """The facades with and without CUDA graphs over the same frames:
    every FrameResult field and the final stores bit-equal, across bucket
    changes and a forced overflow re-run; K1 / K2 counted once per step run
    under replay."""
    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    cuda = assignment_cuda.cascade_solve_cuda

    def make(graphs):
        if streams == 1:
            return host.BoTSORTPipeline(bundle, MINI_TRK, MINI_NMS,
                                        MINI_PIPE, graphs=graphs)
        return host.BatchedBoTSORTPipeline(bundle, streams, MINI_TRK,
                                           MINI_NMS, MINI_PIPE,
                                           graphs=graphs)

    eager, graphed = make(False), make(True)
    assert eager._graphs is None and graphed._graphs is not None
    runs = []
    real = graphed._step
    graphed._step = lambda *a: runs.append(a[2:4]) or real(*a)
    for t, frames in enumerate(_mini_frames(6, streams, 5)):
        arg = frames[0] if streams == 1 else frames
        if t == 3:  # force an overflow: pretend the last step saw nothing
            for p in (eager, graphed):
                if streams == 1:
                    p._last_n_live, p._last_n_face = 0, 0
                else:
                    p._last_max_live, p._last_max_face = 0, 0
        eager.update(arg)
        before = (cuda.launches, cuda.batched_launches, len(runs))
        graphed.update(arg)
        torch.cuda.synchronize()
        _same_result(eager.last_result, graphed.last_result)
        n_runs = len(runs) - before[2]
        counted = (cuda.launches - before[0]) if streams == 1 else (
            cuda.batched_launches - before[1])
        # Every run replays once; a key's first use also warms up eagerly.
        assert n_runs <= counted <= 2 * n_runs, (t, n_runs, counted)
    assert len({r for r in runs}) >= 2, runs          # a bucket change
    assert len(runs) > 6, runs                        # the overflow re-run
    a = eager.store if streams == 1 else eager.stores
    b = graphed.store if streams == 1 else graphed.stores
    for x, y in zip(host._store_tensors(a), host._store_tensors(b)):
        assert (x is None and y is None) or torch.equal(x, y)
    g = graphed._graphs
    assert g.captures == len(g.keys()) and g.replays == len(runs)


def test_mini_step_never_synchronises(dev):
    """After one step has filled the caches, a whole eager step and a
    replayed one run under torch's synchronisation debug mode."""
    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    frames = [torch.from_numpy(f).to(dev) for f in _mini_frames(3, 2, 6)]
    stores = host.empty_stores(MINI_TRK, 2, dev)
    stores, _ = fs.frame_step_batched(bundle, stores, frames[0], MINI_TRK,
                                      MINI_NMS, MINI_PIPE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stores, result = fs.frame_step_batched(
            bundle, stores, frames[1], MINI_TRK, MINI_NMS, MINI_PIPE)
        packed = host.pack_result(result)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    res = packed.to_host()
    assert np.isfinite(res.det_boxes).all() and res.nms_converged.all()

    pipe = host.BatchedBoTSORTPipeline(bundle, 2, MINI_TRK, MINI_NMS,
                                       MINI_PIPE)
    for f in _mini_frames(3, 2, 6)[:2]:
        pipe.update(f)                       # captures the steady key
    keys = len(pipe._graphs.keys())
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = pipe.update_async(_mini_frames(3, 2, 6)[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(pipe._graphs.keys()) == keys  # a replay, not a capture
    assert len(handle.result()) == 2


# --- K1-K6 as custom ops; an exported step replayed from a graph ----------


def _op_pair(op, args, dev):
    """The op on the card's arguments and on their CPU copies."""
    on_card = [a.to(dev) if isinstance(a, torch.Tensor) else
               [t.to(dev) for t in a] if isinstance(a, list) and a and
               isinstance(a[0], torch.Tensor) else a for a in args]
    got = op(*on_card)
    want = op(*args)
    torch.cuda.synchronize()
    return got, want


def test_cascade_and_jv_ops_on_the_card_equal_their_cpu_implementation(dev):
    """torch.ops.botsort_tpu_torch.cascade_solve at B = 1 (K1) and B = 3
    (K2), and jv_solve (K3): the CUDA implementation (the kernel, counted)
    equal to the CPU one (the plain version)."""
    ops = torch.ops.botsort_tpu_torch
    rng = np.random.default_rng(31)
    for b in (1, 3):
        insts = [_instance(rng, 40, 30) for _ in range(b)]
        tensors = [torch.from_numpy(np.stack(x)) for x in zip(*insts)]
        costs, masks, big = assignment.prepare_cascade(*tensors, LIMITS)
        cuda = assignment_cuda.cascade_solve_cuda
        before = (cuda.launches, cuda.batched_launches)
        got, want = _op_pair(ops.cascade_solve,
                             [costs, masks, big, list(LIMITS), 4096], dev)
        assert (cuda.launches, cuda.batched_launches) == (
            before[0] + (b == 1), before[1] + (b > 1))
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)
    probs = [_jv_problem(rng, 60, 25) for _ in range(2)]
    args = [torch.from_numpy(np.stack(x)) for x in zip(*probs)] + [4096]
    before = assignment_cuda.jv_solve_cuda.launches
    got, want = _op_pair(ops.jv_solve, args, dev)
    assert assignment_cuda.jv_solve_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_encoder_ops_on_the_card_equal_their_cpu_implementation(dev):
    """bn_act (K6: bitwise, SiLU within two units in the last place: the
    CPU's SiLU and exponential against the kernel's),
    dw_conv3x3 (K5: bitwise) and stem_stage1 (K4: K4's tolerance) through
    torch.ops, each launch counted."""
    ops = torch.ops.botsort_tpu_torch
    rng = np.random.default_rng(32)
    for dtype in (torch.float32, torch.bfloat16):
        x, mean, mul, bias = _bn_inputs(rng, (2, 24, 6, 10), dtype, "cpu")
        for act in bn_act.ACTS:
            before = bn_act.bn_act_cuda.launches
            got, want = _op_pair(ops.bn_act, [x, mean, mul, bias, act], dev)
            assert bn_act.bn_act_cuda.launches == before + 1
            got = got.cpu()
            if act == "silu":
                assert _ulp_apart(got, want) <= 2
            else:
                assert torch.equal(got, want), act
    x, taps = _dw_case(rng, (3, 40, 12, 24), torch.bfloat16, "cpu")
    before = facereid_dw.dw_conv3x3_cuda.launches
    got, want = _op_pair(ops.dw_conv3x3, [x, taps], dev)
    assert facereid_dw.dw_conv3x3_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)
    model = _trunk("cpu", 7, **FULL_STEM)
    tensors, plan = fastreid_fused.fold_tensors(model.folded_stem_stage1())
    x = _k4_input("cpu", 8, 2, 64, 32)
    before = fastreid_fused.stem_stage1_cuda.launches
    got, want = _op_pair(ops.stem_stage1, [x, tensors, plan], dev)
    assert fastreid_fused.stem_stage1_cuda.launches == before + 1
    rel, worst = _rel(got.cpu(), want)
    assert rel <= 1e-2 and worst <= 0.05, (rel, worst)


def test_mini_exported_step_replayed_from_a_graph_equals_eager(dev,
                                                                tmp_path):
    """A MINI bfloat16 step exported on the card (both NMS programs of the
    det-width bucket pair), loaded and replayed from CUDA graphs by
    load_pipeline: every FrameResult field and the final store bit-equal to
    the eager live facade's; K1 and K6 counted on every replay."""
    from botsort_tpu_torch.runtime import exported

    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    out = str(tmp_path / "exported")
    exported.export_all(bundle, MINI_TRK, MINI_NMS, MINI_PIPE, out,
                        [(240, 320)], buckets=[8], log=lambda *_: None)
    loaded = exported.load_pipeline(out, bundle)
    assert loaded._graphs is not None
    eager = host.BoTSORTPipeline(bundle, MINI_TRK, MINI_NMS, MINI_PIPE,
                                 graphs=False)
    k1, k6 = assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda
    for t, frames in enumerate(_mini_frames(4, 1, 7)):
        eager.update(frames[0])
        before = (k1.launches, k6.launches, loaded._graphs.replays)
        loaded.update(frames[0])
        torch.cuda.synchronize()
        _same_result(eager.last_result, loaded.last_result)
        replays = loaded._graphs.replays - before[2]
        assert k1.launches - before[0] >= replays >= 1
        assert k6.launches - before[1] > replays
    for x, y in zip(host._store_tensors(eager.store),
                    host._store_tensors(loaded.store)):
        assert (x is None and y is None) or torch.equal(x, y)
