"""Kernels K1-K10 on the card, against their plain PyTorch versions, and
the frame step replayed from a CUDA graph against the eager step (also
with the encoders' bucket switch as conditional graph nodes).

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card
and skips without one. Which kernels a call ran, and how often, is read
from torch.profiler by the kernels' names (torch_profile.py). The file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.models import bn_act, facereid, facereid_dw, fastreid
from botsort_tpu_torch.models import fastreid_fused
from botsort_tpu_torch.models.common import cast_compute
from botsort_tpu_torch.ops import (assignment, assignment_cuda, crop,
                                   hierarchy, nms)
from botsort_tpu_torch.pipeline import frame_step as fs
from botsort_tpu_torch.pipeline import graphed, host
from botsort_tpu_torch.runtime import assets, kernels
from botsort_tpu_torch.track.state import empty_stores
# By its own name (pytest puts this directory on the path): a site package
# named ``tests`` would shadow the directory as ``tests.torch_scenes``.
from torch_profile import kernel_counts
from torch_scenes import (HIER_KINDS, HIER_ROUNDS, LIVE, REGIMES, WIDTH,
                          TorchCountDetector, boundary_boxes,
                          hierarchy_case, hierarchy_problems, level_frames)

pytestmark = pytest.mark.cuda

LIMITS = (0.8, 0.5, 0.7)

# The symbols of K6's two paths and K10's two forms.
K6 = ("bn_act_kernel", "bn_act_kernel_cl")
K10 = ("hierarchy_scan_warp", "hierarchy_scan_block")


def _k6(counts):
    return sum(counts[k] for k in K6)


def _k10(counts):
    return sum(counts[k] for k in K10)


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
    on_card = [torch.from_numpy(a).to(dev) for a in inst]
    got = assignment.solve_cascade_masked(*on_card, LIMITS)
    counts = kernel_counts(
        lambda: assignment.solve_cascade_masked(*on_card, LIMITS))
    assert counts["cascade_lap_kernel"] == 1, counts
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
    for args in bad:
        with pytest.raises(ValueError):
            assignment_cuda.cascade_solve_cuda(*args, LIMITS)


def test_k2_batch_equals_plain_and_k1(dev):
    """Eight streams at the main path's shape in one launch (K2): equal to
    the plain version and to eight one-stream launches (K1). One stream
    has no live rows."""
    rng = np.random.default_rng(6)
    insts = [_instance(rng, 64, 50) for _ in range(8)]
    insts[3] = _instance(rng, 64, 50, p_row=0.0)
    batched = [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*insts)]
    costs, masks, big = assignment.prepare_cascade(*batched, LIMITS)
    got = assignment_cuda.cascade_solve_cuda(costs, masks, big, LIMITS)
    counts = kernel_counts(lambda: assignment_cuda.cascade_solve_cuda(
        costs, masks, big, LIMITS))
    assert counts["cascade_lap_kernel"] == 1, counts
    want = assignment.cascade_solve_plain(costs, masks, big, LIMITS)

    def one_stream_launches():
        return [assignment_cuda.cascade_solve_cuda(
            costs[b:b + 1], masks[b:b + 1], big[b:b + 1], LIMITS)
            for b in range(8)]

    singles = one_stream_launches()
    counts = kernel_counts(one_stream_launches)
    assert counts["cascade_lap_kernel"] == 8, counts
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
    on_card = [torch.from_numpy(a).to(dev) for a in (cost, rv, cv)]
    got = assignment.solve_masked(*on_card, 0.8)
    counts = kernel_counts(lambda: assignment.solve_masked(*on_card, 0.8))
    assert counts["jv_lap_kernel"] == 1, counts
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
    for args in bad:
        with pytest.raises(ValueError):
            assignment_cuda.jv_solve_cuda(*args)


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
    with torch.no_grad():
        got = face(img)
        counts = kernel_counts(lambda: face(img))
    assert counts["dw3x3_kernel"] == 13, counts
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
    for args in bad:
        with pytest.raises(ValueError):
            facereid_dw.dw_conv3x3_cuda(*args)


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
    with torch.no_grad():
        got = model(x)
        counts = kernel_counts(lambda: model(x))
    assert counts["stem0_kernel"] == 1, counts
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
    for args in bad:
        with pytest.raises(ValueError):
            fastreid_fused.stem_stage1_cuda(*args)


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
    counts = kernel_counts(lambda: [bn_act.bn_act(x, mean, mul, bias, act)
                                    for act in bn_act.ACTS])
    assert _k6(counts) == len(bn_act.ACTS), counts
    for act in bn_act.ACTS:
        got = bn_act.bn_act(x, mean, mul, bias, act)
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


def _k6_nchw_reference(x, mean, mul, bias, act):
    """K6's NCHW path (``bn_act_kernel``) on x's values: x made contiguous,
    or, where x has one element a plane ([N, C], [N, C, 1, 1]), each element
    twice along a new last axis (inner = 2) and the first copy kept."""
    planes = x.numel() // (x.shape[0] * x.shape[1])
    if planes > 1:
        src = x.contiguous()
        assert bn_act.bn_act_path(src) == "contiguous"
        return bn_act.bn_act_cuda(src, mean, mul, bias, act)
    src = torch.stack([x, x], dim=-1).contiguous()
    assert bn_act.bn_act_path(src) == "contiguous"
    return bn_act.bn_act_cuda(src, mean, mul, bias, act)[..., 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (8, 80, 240, 320),   # the 8-stream detector stem
    (1, 1280, 15, 20),   # the one-frame detector's smallest plane
    (128, 256, 96, 32),  # the 8-stream body encoder's stage 1 at 384x128
    (50, 24, 64, 64),    # the face encoder, C = 24: three columns a row
    (3, 20, 5, 7),       # C % 8 != 0: whole vectors in float32 only
    (3, 7, 5, 3),        # C odd: a channel a thread
    (128, 2048),         # the BNNeck, [N, C]
    (50, 1280, 1, 1),    # [N, C, 1, 1]
])
def test_k6_channels_last_equals_its_nchw_result(dev, shape, dtype):
    """K6's channels-innermost path (``bn_act_kernel_cl``) against its NCHW
    path on the same values, bit for bit for all four activations (one
    ``bn_act_one``), its output laid out as x; the kernels' symbols tell
    the two paths apart."""
    rng = np.random.default_rng(sum(shape) + 7)
    x, mean, mul, bias = _bn_inputs(rng, shape, dtype, dev)
    if x.dim() == 4:
        x = x.to(memory_format=torch.channels_last)
    assert bn_act.bn_act_path(x) == "channels_last"
    counts = kernel_counts(lambda: [bn_act.bn_act(x, mean, mul, bias, act)
                                    for act in bn_act.ACTS])
    assert counts["bn_act_kernel_cl"] == len(bn_act.ACTS), counts
    assert counts["bn_act_kernel"] == 0, counts
    for act in bn_act.ACTS:
        want = _k6_nchw_reference(x, mean, mul, bias, act)
        got = bn_act.bn_act(x, mean, mul, bias, act)
        torch.cuda.synchronize()
        assert got.stride() == x.stride() and got.dtype == x.dtype
        assert torch.equal(got, want), act


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k6_channels_last_unaligned_view_and_nan(dev, dtype):
    """A channels-last view that starts off a 16-byte boundary takes the
    scalar form (a channel a thread) and still equals the NCHW path; NaN
    passes through every activation."""
    rng = np.random.default_rng(21)
    x, mean, mul, bias = _bn_inputs(rng, (4, 16, 6, 5), dtype, dev)
    x = x.to(memory_format=torch.channels_last)
    base = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    odd = base[1:].as_strided(x.shape, x.stride())
    odd.copy_(x)
    assert odd.data_ptr() % 16 != 0
    assert bn_act.bn_act_path(odd) == "channels_last"
    for t in (odd, x):
        t[0, 3, 2, 1] = float("nan")
        for act in bn_act.ACTS:
            got = bn_act.bn_act_cuda(t, mean, mul, bias, act)
            assert got.is_contiguous(memory_format=torch.channels_last)
            torch.testing.assert_close(
                got, _k6_nchw_reference(t, mean, mul, bias, act), rtol=0,
                atol=0, equal_nan=True)
            assert torch.isnan(got[0, 3, 2, 1])


# (body name, streams, bucket): the benchmark's three configurations.
LAYOUT_STEPS = [("mot17_sbs_S50_NMx3x256x128", 1, 50),
                ("mot20_sbs_S50_NMx3x384x128", 8, 16),
                ("transreid_vit_base_s12_msmt17_NMx3x256x128", 1, 50)]


@pytest.mark.parametrize("body,streams,bucket", LAYOUT_STEPS,
                         ids=["mot17_256", "mot20_384", "transreid_256"])
def test_graphed_step_runs_channels_last_without_layout_transposes(
        dev, body, streams, bucket):
    """A full-width step of each configuration (both encoders at a full
    bucket), captured in a CUDA graph and replayed under torch.profiler:
    no cuDNN layout transpose (nchwToNhwc / nhwcToNchw), and every K6
    launch of the replay on the channels-innermost path."""
    bundle = assets.build_bundle(body_reid_name=body, seed=3, device=dev,
                                 dtype=torch.bfloat16)
    hw = assets.parse_body_reid_input_hw(body)
    trk = TrackerConfig(max_dets=bucket,
                        body_feature_dim=bundle.body_encoder.feature_dim)
    nms_cfg = NMSConfig(max_boxes_per_class=bucket)
    pipe_cfg = PipelineConfig(body_reid_input_hw=hw)
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.integers(
        0, 255, (streams, 1080, 1920, 3), dtype=np.uint8)).to(dev)
    stores = host.empty_stores(trk, streams, dev)

    def step():
        return fs.frame_step_batched(bundle, stores, frames, trk, nms_cfg,
                                     pipe_cfg, None, bucket, bucket)

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        counts = kernel_counts(graph.replay)
    print(f"{body}: K6 launches {_k6(counts)}, channels-last "
          f"{counts['bn_act_kernel_cl']}; {sum(counts.values())} kernels")
    assert counts["bn_act_kernel_cl"] > 0
    assert counts["bn_act_kernel_cl"] == _k6(counts), counts
    transposes = [n for n in counts
                  if "nchwToNhwc" in n or "nhwcToNchw" in n]
    assert not transposes, transposes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (64, 32, 128, 64),   # the body encoder's stem in training, batch 64
    (64, 2048),          # the BNNeck, [N, C]: one element a thread
    (2, 1280, 15, 20),   # inner = 300: no whole vectors
    (3, 7, 5, 3),
    (1, 1, 1, 1),
])
def test_k6b_equals_plain(dev, shape, dtype):
    """K6b against bn_act_backward_plain on the card: grad_x bit for bit
    (SiLU within two units in the last place), the sums within 1e-5
    relative; two calls give the same bits."""
    rng = np.random.default_rng(sum(shape) + 1)
    x, mean, mul, bias = _bn_inputs(rng, shape, dtype, dev)
    grad = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, dtype)
    counts = kernel_counts(lambda: [bn_act.bn_act_backward_cuda(
        grad, x, mean, mul, bias, act) for act in bn_act.ACTS])
    for kernel in ("bn_act_backward_kernel", "bn_act_backward_sums"):
        assert counts[kernel] == len(bn_act.ACTS), counts
    for act in bn_act.ACTS:
        got = bn_act.bn_act_backward_cuda(grad, x, mean, mul, bias, act)
        again = bn_act.bn_act_backward_cuda(grad, x, mean, mul, bias, act)
        want = bn_act.bn_act_backward_plain(grad, x, mean, mul, bias, act)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), act
        assert got[0].dtype == dtype and got[0].shape == x.shape
        if act == "silu":
            assert _ulp_apart(got[0], want[0]) <= 2, act
        else:
            assert torch.equal(got[0], want[0]), act
        for g, w in zip(got[1:], want[1:]):
            assert torch.all((g - w).abs() <= 1e-5 * w.abs() + 1e-7), act


def test_training_route_launches_k6b(dev):
    """A norm whose statistics and scale require grad goes through
    BnActFunction: K6 forward, K6b backward, the plain backward's [C]
    gradients."""
    from botsort_tpu_torch.models.common import BatchNorm

    rng = np.random.default_rng(12)
    bn = BatchNorm(16, 1e-5).to(dev)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 1.5)
        bn.running_mean.normal_()
    bn.running_mean.requires_grad_()
    bn.running_var.requires_grad_()
    x = torch.from_numpy(rng.normal(size=(4, 16, 8, 8)).astype(
        np.float32)).to(dev, torch.bfloat16).requires_grad_()

    def forward_backward():
        for t in (x, *bn.parameters(), bn.running_mean, bn.running_var):
            t.grad = None
        bn(x, "relu").float().sum().backward()

    counts = kernel_counts(forward_backward)
    assert _k6(counts) == 1, counts
    assert counts["bn_act_backward_kernel"] == 1, counts
    with torch.no_grad():
        g = torch.ones_like(x)
        gx, s_gy, s_gyx = bn_act.bn_act_backward_plain(
            g, x.detach(), bn.running_mean, bn.mul(), bn.bias, "relu")
    assert torch.equal(x.grad, gx)
    assert torch.allclose(bn.bias.grad, s_gy, rtol=1e-5, atol=1e-6)
    assert bn.weight.grad is not None and bn.running_var.grad is not None


def test_k6b_refuses_what_it_does_not_take(dev):
    x, mean, mul, bias = _bn_inputs(np.random.default_rng(2), (2, 4, 3, 3),
                                    torch.float32, dev)
    g = torch.ones_like(x)
    with pytest.raises(ValueError):
        bn_act.bn_act_backward_cuda(g.cpu(), x.cpu(), mean, mul, bias)
    with pytest.raises(ValueError):
        bn_act.bn_act_backward_cuda(g.bfloat16(), x, mean, mul, bias)
    with pytest.raises(ValueError):
        bn_act.bn_act_backward_cuda(g, x, mean[:3], mul, bias)
    with pytest.raises(ValueError):
        bn_act.bn_act_backward_cuda(g, x.permute(0, 1, 3, 2), mean, mul,
                                    bias)


def _crop_case(rng, b, hw, n, dtype, dev):
    """Seeded frames [b, H, W, 3] and boxes [b, n, 4]: full-frame,
    edge-clamped, one pixel wide, degenerate and random."""
    h, w = hw
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    if dtype == torch.float32:
        frames = (frames + rng.uniform(0, 1, frames.shape)).astype(np.float32)
    fixed = [[0, 0, w, h], [w - 37, 5, w, 90], [3, h - 40, 70, h],
             [5, 7, 6, 60], [0, 0, 0, 0], [10, 10, 10.5, 40],
             [w - 1, h - 1, w, h]]
    boxes = []
    for _ in range(b):
        rows = list(fixed)
        while len(rows) < n:
            x1, y1 = rng.integers(0, w - 2), rng.integers(0, h - 2)
            rows.append([x1, y1, rng.integers(x1 + 1, w + 1),
                         rng.integers(y1 + 1, h + 1)])
        boxes.append(rows[:n])
    return (torch.from_numpy(frames).to(dev),
            torch.tensor(boxes, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("mode", crop.MODES)
@pytest.mark.parametrize("b,hw,n,out_hw", [
    (1, (1080, 1920), 1, (480, 640)),   # the detector input
    (2, (1080, 1920), 50, (256, 128)),  # body crops
    (2, (1080, 1920), 50, (128, 128)),  # face crops
    (3, (37, 53), 9, (20, 30)),         # odd sizes, a partial last tile
], ids=["det", "body", "face", "odd"])
def test_k7_equals_plain(dev, mode, b, hw, n, out_hw):
    """K7 bit for bit against its plain version on the card and on the
    CPU (which the CPU tests hold to the JAX package)."""
    rng = np.random.default_rng(b + n)
    frames, boxes = _crop_case(rng, b, hw, max(n, 7), torch.uint8, dev)
    got = crop.crop_resize(frames, boxes, out_hw, mode)
    counts = kernel_counts(lambda: crop.crop_resize(frames, boxes, out_hw,
                                                    mode))
    assert counts["crop_resize_kernel"] == 1, counts
    want = crop.crop_resize_plain(frames, boxes, out_hw, mode)
    torch.cuda.synchronize()
    assert got.shape == (b, max(n, 7)) + out_hw + (3,)
    assert torch.equal(got, want)
    if b * max(n, 7) * out_hw[0] * out_hw[1] <= 2 ** 22:
        assert torch.equal(got.cpu(), crop.crop_resize_plain(
            frames.cpu(), boxes.cpu(), out_hw, mode))


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_k7_takes_float_frames(dev, mode):
    rng = np.random.default_rng(4)
    frames, boxes = _crop_case(rng, 2, (60, 80), 9, torch.float32, dev)
    got = crop.crop_resize_cuda(frames, boxes, (32, 24), mode)
    assert torch.equal(got, crop.crop_resize_plain(frames, boxes, (32, 24),
                                                   mode))


def test_k7_refuses_what_it_does_not_take(dev):
    frames, boxes = _crop_case(np.random.default_rng(2), 1, (40, 50), 7,
                               torch.uint8, dev)
    with pytest.raises(ValueError):
        crop.crop_resize_cuda(frames.cpu(), boxes.cpu(), (8, 8))
    with pytest.raises(ValueError):
        crop.crop_resize_cuda(frames.float(), boxes, (8, 8), "int8")
    with pytest.raises(ValueError):
        crop.crop_resize_cuda(frames.half(), boxes, (8, 8))
    with pytest.raises(ValueError):
        crop.crop_resize_cuda(frames.transpose(1, 2), boxes, (8, 8))
    with pytest.raises(ValueError):
        crop.crop_resize_cuda(frames, boxes[:, :, :3], (8, 8))
    with pytest.raises(ValueError):
        crop.crop_resize_cuda(frames, boxes, (8, 8), "float16")


def test_k7_op_on_the_card_equals_its_cpu_implementation(dev):
    """torch.ops.botsort_tpu_torch.crop_resize in each mode: the CUDA
    implementation (the kernel, counted) equal to the CPU one."""
    frames, boxes = _crop_case(np.random.default_rng(6), 2, (90, 120), 9,
                               torch.uint8, "cpu")
    for mode in crop.MODES:
        got, want, counts = _op_pair(
            torch.ops.botsort_tpu_torch.crop_resize,
            [frames, boxes, 48, 64, mode], dev)
        assert counts["crop_resize_kernel"] == 1, counts
        assert torch.equal(got.cpu(), want), mode


def test_batchnorm_mul_cache_follows_the_statistics(dev):
    from botsort_tpu_torch.models.common import BatchNorm

    # An inference module, as build_bundle leaves it: no grad required, so
    # mul() is the cached multiplier (tests/test_torch_train.py covers the
    # training route).
    bn = BatchNorm(8, 1e-3).to(dev).eval().requires_grad_(False)
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


@pytest.mark.parametrize("pipe_cfg", [
    MINI_PIPE, dataclasses.replace(MINI_PIPE, compute_dtype="float32",
                                   crop_int8=False)],
    ids=["default", "float32"])
def test_mini_step_crops_with_k7(dev, pipe_cfg):
    """A step launches K7 three times (the detector input, the body and
    the face crops), in the mode the configuration gives, and its crops
    equal the plain version's on the same frames and boxes."""
    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    frames = torch.from_numpy(_mini_frames(1, 2, 3)[0]).to(dev)
    modes = []
    real = crop.crop_resize

    def checked(images, boxes, out_hw, mode="float32"):
        out = real(images, boxes, out_hw, mode)
        want = crop.crop_resize_plain(images, boxes, out_hw, mode)
        assert torch.equal(out, want), (out_hw, mode)
        modes.append(mode)
        return out

    def step():
        modes.clear()
        fs.frame_step_batched(bundle, empty_stores(MINI_TRK, 2, dev),
                              frames, MINI_TRK, MINI_NMS, pipe_cfg, None, 8,
                              8)

    with mock.patch.object(crop, "crop_resize", checked):
        counts = kernel_counts(step)
    assert counts["crop_resize_kernel"] == 3, counts
    assert modes == [crop.crop_mode(pipe_cfg, torch.uint8)] * 3


@pytest.mark.parametrize("streams", [1, 3])
def test_mini_graphed_step_equals_eager(dev, streams):
    """The facades with and without CUDA graphs over the same frames:
    every FrameResult field and the final stores bit-equal, across bucket
    changes and a forced overflow re-run; each captured step launches the
    cascade once a replay (K2: one launch for every stream)."""
    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)

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
        graphed.update(arg)
        torch.cuda.synchronize()
        _same_result(eager.last_result, graphed.last_result)
    assert len({r for r in runs}) >= 2, runs          # a bucket change
    assert len(runs) > 6, runs                        # the overflow re-run
    a = eager.store if streams == 1 else eager.stores
    b = graphed.store if streams == 1 else graphed.stores
    for x, y in zip(host._store_tensors(a), host._store_tensors(b)):
        assert (x is None and y is None) or torch.equal(x, y)
    g = graphed._graphs
    assert g.captures == len(g.keys()) and g.replays == len(runs)
    for key in g.keys():
        counts = kernel_counts(g._entries[key].replay)
        assert counts["cascade_lap_kernel"] == 1, (key, counts)


def test_profile_counts_are_exact_after_an_earlier_profile(dev):
    """``kernel_counts`` in a process that has already run torch.profiler
    (a second run can lose its first events), three rounds in a row:
    exactly N K6 launches from N eager calls, and N times a step's K6
    launches (counted at the wrapper while the step ran eagerly) from N
    replays of the captured MINI step."""
    x, mean, mul, bias = _bn_inputs(np.random.default_rng(3), (2, 8, 6, 5),
                                    torch.float32, dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        bn_act.bn_act_cuda(x, mean, mul, bias)
        torch.cuda.synchronize()
    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    frames = torch.from_numpy(_mini_frames(1, 2, 4)[0]).to(dev)
    stores = host.empty_stores(MINI_TRK, 2, dev)

    def step():
        fs.frame_step_batched(bundle, stores, frames, MINI_TRK, MINI_NMS,
                              MINI_PIPE, None, 8, 8)

    calls = []
    real = bn_act.bn_act_cuda

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    with torch.no_grad():
        with mock.patch.object(bn_act, "bn_act_cuda", counted):
            step()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
    per_step = len(calls)
    assert per_step > 1
    for _ in range(3):
        for n in (1, 5):
            counts = kernel_counts(lambda: [bn_act.bn_act_cuda(
                x, mean, mul, bias) for _ in range(n)])
            assert _k6(counts) == counts["bn_act_kernel"] == n, counts
            counts = kernel_counts(lambda: [graph.replay()
                                            for _ in range(n)])
            assert _k6(counts) == n * per_step, (n, per_step, counts)


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


def _full_hd_pools(seed, pools=2, per_pool=3, streams=8):
    """Frame pools of 1080p frames: noise under _mini_frames' bars."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(pools):
        pool = rng.integers(0, 255, (per_pool, streams, 1080, 1920, 3),
                            dtype=np.uint8)
        for t in range(per_pool):
            for k in range(3):
                x = 250 + 700 * k + 30 * t
                pool[t, :, 270:900, x:x + 220] = (40 + 70 * k, 200, 120)
        out.append(pool)
    return out


def test_banded_upload_lands_every_frame_on_the_card(dev):
    """20 graphed 8-stream 1080p updates with affines, drawing from two
    frame pools in turn (the staging buffer rewritten with other bytes
    every update): the frames on the card equal the input bytes on every
    update, every frame upload is split into bands and no affine upload
    is, and each FrameResult equals the same run's with the frames handed
    as a list. Once the staging buffers exist, no upload synchronises."""
    from botsort_tpu_torch.pipeline import upload

    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    pools = _full_hd_pools(21)
    gmc = np.tile(np.eye(2, 3, dtype=np.float32), (8, 1, 1))
    as_array, as_list = (host.BatchedBoTSORTPipeline(
        bundle, 8, MINI_TRK, MINI_NMS, MINI_PIPE) for _ in range(2))
    on_card, strict = [], []
    real = host._Facade._upload

    def kept(self, name, array):
        if strict:  # once the staging buffers exist
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(self, name, array)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if name == "frames":  # after the H2Ds, on the same stream
            on_card.append(out.clone())
        return out

    n = 20
    with mock.patch.object(host._Facade, "_upload", kept):
        for u in range(n):
            frames = pools[u % 2][(u // 2) % len(pools[0])]
            strict[:] = [True] * (u >= 2)
            as_array.update(frames, gmc)
            assert np.array_equal(on_card[-1].cpu().numpy(), frames), u
            as_list.update(list(frames), gmc)
            assert np.array_equal(on_card[-1].cpu().numpy(), frames), u
            _same_result(as_array.last_result, as_list.last_result)
    bands = len(upload._bands(frames.nbytes))
    assert (as_array.uploads, as_array.uploads_split,
            as_array.upload_chunks) == (2 * n, n, n * bands)
    per_frame = len(upload._bands(frames[0].nbytes))
    assert (as_list.uploads, as_list.uploads_split,
            as_list.upload_chunks) == (2 * n, n, n * 8 * per_frame)
    assert as_array._graphs.replays >= n


# --- K1-K6 as custom ops; an exported step replayed from a graph ----------


def _op_pair(op, args, dev):
    """The op on the card's arguments and on their CPU copies, and the
    kernels the card's call runs."""
    on_card = [a.to(dev) if isinstance(a, torch.Tensor) else
               [t.to(dev) for t in a] if isinstance(a, list) and a and
               isinstance(a[0], torch.Tensor) else a for a in args]
    got = op(*on_card)
    want = op(*args)
    torch.cuda.synchronize()
    return got, want, kernel_counts(lambda: op(*on_card))


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
        got, want, counts = _op_pair(
            ops.cascade_solve, [costs, masks, big, list(LIMITS), 4096], dev)
        assert counts["cascade_lap_kernel"] == 1, (b, counts)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)
    probs = [_jv_problem(rng, 60, 25) for _ in range(2)]
    args = [torch.from_numpy(np.stack(x)) for x in zip(*probs)] + [4096]
    got, want, counts = _op_pair(ops.jv_solve, args, dev)
    assert counts["jv_lap_kernel"] == 1, counts
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
            got, want, counts = _op_pair(ops.bn_act,
                                         [x, mean, mul, bias, act], dev)
            assert _k6(counts) == 1, counts
            got = got.cpu()
            if act == "silu":
                assert _ulp_apart(got, want) <= 2
            else:
                assert torch.equal(got, want), act
    x, taps = _dw_case(rng, (3, 40, 12, 24), torch.bfloat16, "cpu")
    got, want, counts = _op_pair(ops.dw_conv3x3, [x, taps], dev)
    assert counts["dw3x3_kernel"] == 1, counts
    assert torch.equal(got.cpu(), want)
    model = _trunk("cpu", 7, **FULL_STEM)
    tensors, plan = fastreid_fused.fold_tensors(model.folded_stem_stage1())
    x = _k4_input("cpu", 8, 2, 64, 32)
    got, want, counts = _op_pair(ops.stem_stage1, [x, tensors, plan], dev)
    assert counts["stem0_kernel"] == 1, counts
    rel, worst = _rel(got.cpu(), want)
    assert rel <= 1e-2 and worst <= 0.05, (rel, worst)


def test_mini_exported_step_replayed_from_a_graph_equals_eager(dev,
                                                                tmp_path):
    """A MINI bfloat16 step exported on the card (the program of the
    det-width bucket pair), loaded and replayed from CUDA graphs by
    load_pipeline: every FrameResult field and the final store bit-equal to
    the eager live facade's; every captured program launches K1 once a
    replay and K6 more than once."""
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
    for t, frames in enumerate(_mini_frames(4, 1, 7)):
        eager.update(frames[0])
        replays = loaded._graphs.replays
        loaded.update(frames[0])
        torch.cuda.synchronize()
        _same_result(eager.last_result, loaded.last_result)
        assert loaded._graphs.replays > replays
    for key in loaded._graphs.keys():
        counts = kernel_counts(loaded._graphs._entries[key].replay)
        assert counts["cascade_lap_kernel"] == 1, (key, counts)
        assert _k6(counts) > 1, (key, counts)
    for x, y in zip(host._store_tensors(eager.store),
                    host._store_tensors(loaded.store)):
        assert (x is None and y is None) or torch.equal(x, y)


# --- K8: the NMS fixpoint; K9: the bucket switch as conditional nodes -----


def _k8_case(rng, problems, p, kind):
    if kind == "chain":   # each box dominates the next: a chain of p
        x = np.arange(p, dtype=np.float32) * 3.0
        one = np.stack([x, np.zeros(p, np.float32), x + 10.0,
                        np.full(p, 10.0, np.float32)], axis=1)
        return np.stack([one] * problems), np.ones((problems, p), bool)
    span = 200.0 if kind == "random" else 40.0
    tl = rng.uniform(0, span, (problems, p, 2))
    boxes = np.concatenate([tl, tl + rng.uniform(5, 60, (problems, p, 2))],
                           -1).astype(np.float32)
    if kind == "tied":   # duplicated boxes: IoU exactly 1
        boxes[:, 1::2] = boxes[:, ::2][:, :p // 2]
    return boxes, rng.uniform(0, 1, (problems, p)) < 0.9


@pytest.mark.parametrize("problems,p,kind", [
    (32, 512, "random"), (4, 512, "dense"), (1, 512, "chain"),
    (2, 1024, "chain"), (8, 252, "tied"), (3, 33, "random"),
    ("c16", 512, "random"), ("c8", 512, "dense"), ("c4", 300, "tied"),
    ("c2", 512, "random"), ("c1", 97, "random"), (6, 2, "boundary"),
    (2, 1025, "random"), (4, 2048, "random"), (2, 2048, "tied"),
    (1, 2048, "chain"), (4, 6300, "random"), (32, 1100, "dense")])
def test_k8_equals_plain(dev, problems, p, kind):
    """K8 against its plain version, bit for bit, at three thresholds
    (one launch each, counted from the profile), shaped [G, C, P] and flat. "cN": a problem
    count that takes cluster size N on the H100 (its SM count // N, or
    fewer where the card holds fewer clusters of N at once); "boundary":
    the pairs of tests/torch_scenes.py::boundary_boxes, whose IoU is each
    threshold one ulp down, exactly and one ulp up. P above 1,024: the
    dominance words in the scratch buffer (a 2,048-chain at 0.3 and 0.5;
    6,300, the anchors of a 480x640 input)."""
    if isinstance(problems, str):
        cluster = int(problems[1:])
        props = torch.cuda.get_device_properties(dev)
        problems = min(props.multi_processor_count // cluster,
                       nms.max_active_clusters(cluster, p, dev))
        assert nms.launch_shape(problems, p, dev) == cluster
    rng = np.random.default_rng(p + problems)
    boxes, valid = _k8_case(rng, problems, p, kind) \
        if kind != "boundary" else (None, None)
    cases = []
    for thr in (0.3, 0.5, 0.8):
        if kind == "boundary":
            boxes, _ = boundary_boxes(thr)
            valid = np.ones(boxes.shape[:2], bool)
        cases.append((torch.from_numpy(boxes).to(dev),
                      torch.from_numpy(valid).to(dev), thr))
    counts = kernel_counts(lambda: [nms.nms_fixpoint_cuda(*c)
                                    for c in cases])
    assert counts["nms_fixpoint_kernel"] == len(cases), counts
    for tb, tv, thr in cases:
        got = nms.nms_fixpoint_cuda(tb, tv, thr)
        want = nms.nms_fixpoint_plain(tb, tv, thr)
        assert torch.equal(got, want), thr
    if problems % 2 == 0:
        shaped = nms.nms_fixpoint(tb.reshape(2, -1, p, 4),
                                  tv.reshape(2, -1, p), 0.5)
        assert torch.equal(shaped.reshape(problems, p),
                           nms.nms_fixpoint_plain(tb, tv, 0.5))


@pytest.mark.parametrize("problems,p,kinds,thr", [
    (4, 512, ("dense", "random"), 0.8), (2, 1025, ("random", "dense"), 0.5),
    (4, 2048, ("random", "tied"), 0.5), (1, 2048, ("chain", "dense"), 0.5),
    (4, 6300, ("dense", "random"), 0.5)])
def test_k8_replayed_from_a_graph_equals_eager(dev, problems, p, kinds, thr):
    """K8 captured in a CUDA graph by pipeline/graphed.py::GraphCache, as
    the facades capture a step, and replayed on two inputs: equal to the
    eager launch and to the plain version, and launched once a replay.
    Above 1,024
    candidates the dominance words go to a scratch tensor the wrapper
    allocates on the current stream (the graph's pool under capture)."""
    rng = np.random.default_rng(13)
    inputs = [[torch.from_numpy(a).to(dev)
               for a in _k8_case(rng, problems, p, kind)]
              for kind in kinds]
    cache = graphed.GraphCache(dev)

    def step(boxes, valid):
        return [nms.nms_fixpoint(boxes, valid, thr)]

    for tb, tv in inputs + inputs:
        eager = nms.nms_fixpoint_cuda(tb, tv, thr)
        got, = cache.run(("k8",), step, [tb, tv])
        assert torch.equal(got, eager)
        assert torch.equal(got, nms.nms_fixpoint_plain(tb, tv, thr))
    assert cache.captures == 1 and cache.replays == 4
    counts = kernel_counts(lambda: cache.run(("k8",), step, inputs[0]))
    assert counts["nms_fixpoint_kernel"] == 1, counts


def test_k8_wrapper_refuses_and_op_equals_its_cpu_implementation(dev):
    rng = np.random.default_rng(41)
    boxes, valid = _k8_case(rng, 4, 96, "random")
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    got, want, counts = _op_pair(torch.ops.botsort_tpu_torch.nms_fixpoint,
                                 [tb, tv, 0.5], dev)
    assert counts["nms_fixpoint_kernel"] == 1, counts
    assert got.is_cuda and torch.equal(got.cpu(), want)
    # No size is refused: 1,025 candidates, one above the shared-memory
    # words, launch and equal the plain version.
    big, big_valid = (torch.from_numpy(a).to(dev) for a in _k8_case(
        rng, 1, 1025, "dense"))
    assert torch.equal(nms.nms_fixpoint_cuda(big, big_valid, 0.5),
                       nms.nms_fixpoint_plain(big, big_valid, 0.5))
    counts = kernel_counts(lambda: nms.nms_fixpoint_cuda(big, big_valid,
                                                         0.5))
    assert counts["nms_fixpoint_kernel"] == 1, counts
    with pytest.raises(ValueError, match="float32"):
        nms.nms_fixpoint_cuda(tb.to(dev).double(), tv.to(dev), 0.5)


def _count_bundle(dev):
    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    return fs.ModelBundle(TorchCountDetector().to(dev), bundle.body_encoder,
                          bundle.face_encoder)


# Per step, the regime of each of three streams (the step's is the busiest).
SWITCH_ROWS = (("none", "none", "none"), ("chunk", "none", "none"),
               ("full", "chunk", "none"), ("none", "none", "chunk"),
               ("none", "none", "none"))


@pytest.mark.parametrize("streams", [1, 3])
def test_mini_switch_graph_equals_static_bucket_graphs(dev, streams):
    """host_bucket_dispatch=False replayed from one CUDA graph whose
    encoder batches are conditional nodes behind K9: over loads that take
    every branch, each step bit-equal to the static-bucket graph at the
    buckets the branches encode (0, 4, 8), one capture for every load, K9
    twice a replay (body and face switch), K7 once a step plus once a
    branch taken."""
    bundle = _count_bundle(dev)
    pipe_cfg = dataclasses.replace(MINI_PIPE, compute_dtype="float32",
                                   crop_int8=False)
    sw_cfg = dataclasses.replace(pipe_cfg, host_bucket_dispatch=False)

    def make(cfg):
        if streams == 1:
            return host.BoTSORTPipeline(bundle, MINI_TRK, MINI_NMS, cfg)
        return host.BatchedBoTSORTPipeline(bundle, streams, MINI_TRK,
                                           MINI_NMS, cfg)

    sw, st = make(sw_cfg), make(pipe_cfg)
    seen = set()
    for t, row in enumerate(SWITCH_ROWS):
        frames = np.stack(level_frames([REGIMES[r] for r in
                                        row[:streams]], seed=30 + t))
        arg = frames[0] if streams == 1 else frames
        store_before = st.store if streams == 1 else st.stores
        sw.update(arg)
        torch.cuda.synchronize()
        values = fs.switch_values(sw.last_result, MINI_TRK, MINI_NMS,
                                  sw_cfg)
        # The program replayed on this step's inputs (still in the cache's
        # input buffers): K9 once a switch, K7 once for the detector input
        # and once inside each branch taken.
        cache = sw._graphs
        counts = kernel_counts(cache._entries[cache.keys()[0]].replay)
        print(f"switch step {t}: values {values}, K9 "
              f"{counts['set_conditionals_kernel']}, K7 "
              f"{counts['crop_resize_kernel']}")
        assert counts["set_conditionals_kernel"] == 2, counts
        assert counts["crop_resize_kernel"] == 1 + sum(v > 0
                                                       for v in values)
        buckets = [0 if v == 0 else 4 if v <= 4 else 8 for v in values]
        seen.add(buckets[0])
        new, packed = st._step(store_before, st._upload("f", frames if
                                                        streams > 1 else
                                                        frames[0]),
                               *buckets)
        _same_result(sw.last_result, packed.to_host())
        for x, y in zip(host._store_tensors(sw.store if streams == 1
                                            else sw.stores),
                        host._store_tensors(new)):
            assert (x is None and y is None) or torch.equal(x, y)
        if streams == 1:
            st.store = new
        else:
            st.stores = new
    assert seen == {0, 4, 8}
    assert sw._graphs.captures == 1 and sw._graphs.keys()[0][5:7] == (
        None, None)


def test_mini_eager_switch_zeroes_beyond_the_branch_without_waiting(dev):
    """On the card without graphs the switch embeds the full width and
    zeroes the slots beyond the branch the device's count picks, with no
    synchronisation between upload and readback."""
    bundle = _count_bundle(dev)
    cfg = dataclasses.replace(MINI_PIPE, host_bucket_dispatch=False)
    with torch.no_grad():
        fs._perception_batched(bundle, torch.from_numpy(np.stack(
            level_frames([70]))).to(dev), MINI_TRK, MINI_NMS, cfg, None,
            None)
    torch.cuda.synchronize()
    for regime in REGIMES:
        frames = torch.from_numpy(np.stack(level_frames(
            [REGIMES[regime]], seed=9))).to(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                p = fs._perception_batched(bundle, frames, MINI_TRK,
                                           MINI_NMS, cfg, None, None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert int(p.det_valid[:, 0].sum()) == LIVE[regime]
        assert not bool(p.body_feats[:, WIDTH[regime]:].any())
        if LIVE[regime]:
            assert bool(p.body_feats[:, :LIVE[regime]].abs().sum(-1)
                        .gt(0).all())


# --- the tracer's stage marks inside a captured step ------------------------


def _event_record_nodes(graph) -> int:
    """Event-record nodes (``cudaGraphNodeTypeEventRecord``, 7) of a
    ``torch.cuda.CUDAGraph`` captured with ``keep_graph=True``."""
    import ctypes
    import glob

    try:
        rt = ctypes.CDLL("libcudart.so")
    except OSError:
        rt = ctypes.CDLL(sorted(glob.glob(
            "/usr/local/cuda/lib64/libcudart.so*"))[0])
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert rt.cudaGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(0)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds.count(7)


@pytest.mark.parametrize("switched,graphs", [(False, True), (True, True),
                                             (False, False)],
                         ids=["static", "switch", "eager"])
def test_traced_graph_times_five_stages_untraced_has_no_event_nodes(
        dev, switched, graphs):
    """A step captured with tracing on holds one event-record node a stage
    mark and two a part (the body encoder's), none in a switch branch, and
    every replay reads five positive stage times whose sum is at most the
    update's wall time and a body-encoder time within its embed stage's;
    captured with tracing off it holds no event-record node. Both give the
    same results. Without graphs the marks are plain events, timed
    alike."""
    import time

    from botsort_tpu_torch.utils.profiling import MARKS, PARTS

    bundle = _count_bundle(dev) if switched else assets.build_bundle(
        mini=True, seed=2, device=dev, dtype=torch.bfloat16)
    cfg = dataclasses.replace(MINI_PIPE, host_bucket_dispatch=not switched)
    plain = host.BoTSORTPipeline(bundle, MINI_TRK, MINI_NMS, cfg,
                                 graphs=graphs)
    traced = host.BoTSORTPipeline(bundle, MINI_TRK, MINI_NMS, cfg,
                                  graphs=graphs, trace=True)
    frames = (level_frames([REGIMES[r] for r in ("chunk", "full", "none",
                                                 "full")], seed=11)
              if switched else [f[0] for f in _mini_frames(4, 1, 7)])
    for frame in frames:
        plain.update(frame)
        t0 = time.perf_counter()
        traced.update(frame)
        wall_ms = (time.perf_counter() - t0) * 1e3
        _same_result(plain.last_result, traced.last_result)
        u = traced.timers.update
        runs = [dict(st) for v, st in traced.timers.export()["stages"]
                if v == u]
        assert runs and all(list(r) == list(MARKS[1:]) for r in runs)
        stage_ms = [sum(r[s] for r in runs) for s in MARKS[1:]]
        assert all(ms > 0 for ms in stage_ms[:5]), stage_ms
        assert sum(stage_ms) <= wall_ms, (stage_ms, wall_ms)
        body = [ms for v, ms in traced.timers.export()["body_encoder"]
                if v == u]
        assert len(body) == len(runs)
        assert all(0 <= b <= r["embed"] for b, r in zip(body, runs))
    if not graphs:
        return
    for pipe, want in ((traced, len(MARKS) + 2 * len(PARTS)), (plain, 0)):
        for entry in pipe._graphs._entries.values():
            segments = [it[1] for it in entry.keep if it[0] == "segment"]
            assert sum(_event_record_nodes(g) for g in segments) == want
            for it in entry.keep:
                if it[0] == "switch":
                    assert all(_event_record_nodes(g) == 0 for g in it[3])



# --- K10: the hierarchy's greedy claims ------------------------------------


def _k10_args(problems, n_bases, n_targets, kind, dev, seed=0,
              pattern=HIER_ROUNDS):
    case = hierarchy_case(np.random.default_rng(seed), problems, n_bases,
                          n_targets, kind, pattern)
    return hierarchy.scan_inputs(hierarchy_problems(
        case, lambda a: torch.from_numpy(a).to(dev)))


@pytest.mark.parametrize("problems,n_bases,n_targets,kind",
                         [(3, 50, 50, k) for k in HIER_KINDS]
                         + [(24, 50, 50, k) for k in HIER_KINDS]
                         + [(48, 50, 50, "dupes"), (1, 50, 50, "grid"),
                            (5, 37, 45, "random"), (6, 20, 70, "grid"),
                            (4, 16, 300, "dupes"), (2, 8, 1024, "random"),
                            (9, 1, 1, "random"), (3, 4, 1025, "random"),
                            (3, 6, 2048, "dupes"), (3, 4, 2048, "grid"),
                            (24, 5, 1500, "invalid")])
def test_k10_equals_plain(dev, problems, n_bases, n_targets, kind):
    """K10 against greedy_scan_plain on the card, bit for bit (one launch,
    counted): b = T = 50 at one frame's (3), eight frames' (24) and the
    temporal step's (48) problems with rounds (1, 1, 2), duplicate boxes
    and grid boxes (IoU and distance ties: the lowest index wins), invalid
    bases and targets and all-invalid problems, T at every slot count a
    lane can hold (1 to 32 targets a lane), and T above 1,024 (a block a
    problem)."""
    args = _k10_args(problems, n_bases, n_targets, kind, dev,
                     seed=problems + n_targets)
    got = hierarchy.greedy_scan_cuda(*args)
    counts = kernel_counts(lambda: hierarchy.greedy_scan_cuda(*args))
    assert _k10(counts) == 1, counts
    want = hierarchy.greedy_scan_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(hierarchy.greedy_scan(*args), want)


def test_k10_nan_follows_the_plain_version(dev):
    """A NaN IoU in a row claims nothing; a NaN distance among the
    candidates is the argmin (torch's rule), on the card as in the plain
    version."""
    iou, dist, used0, active = _k10_args(3, 40, 40, "random", dev, seed=3)
    iou[0, 3, 5] = float("nan")
    dist[1, 2, :] = float("nan")
    dist[2, 7, 9] = float("nan")
    assert torch.equal(hierarchy.greedy_scan_cuda(iou, dist, used0, active),
                       hierarchy.greedy_scan_plain(iou, dist, used0, active))


@pytest.mark.parametrize("problems,n_bases,n_targets,kinds,pattern", [
    (24, 50, 50, ("dupes", "grid"), HIER_ROUNDS),
    (3, 6, 1025, ("random", "dupes"), HIER_ROUNDS),
    (6, 4, 2048, ("dupes", "grid"), HIER_ROUNDS),
    (6, 3, 120, ("dupes", "random"), (1, 1, 33)),
    (3, 2, 1100, ("random", "dupes"), (1, 1, 33))])
def test_k10_captured_without_synchronising(dev, problems, n_bases,
                                            n_targets, kinds, pattern):
    """K10 captured in a CUDA graph by pipeline/graphed.py::GraphCache (a
    capture fails on any wait), then launched eagerly and replayed under
    set_sync_debug_mode("error") on two inputs: equal to each other and to
    the plain version, and K10 launched once a replay. Also above 1,024
    targets (a block a problem, its scratch tensor from the graph's pool
    under capture; random boxes and ties) and at R = 33 (claims past round
    32), in the warp and the block form."""
    inputs = [list(_k10_args(problems, n_bases, n_targets, kind, dev,
                             seed=7, pattern=pattern))
              for kind in kinds]
    cache = graphed.GraphCache(dev)

    def step(*args):
        return [hierarchy.greedy_scan(*args)]

    got, = cache.run(("k10",), step, inputs[0])   # the capture
    for args in inputs + inputs:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = hierarchy.greedy_scan_cuda(*args)
            got, = cache.run(("k10",), step, args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
        want = hierarchy.greedy_scan_plain(*args)
        assert torch.equal(got, want) and (want >= 0).any()
        if max(pattern) > 32:
            assert (want[:, :, 32:] >= 0).any()
    assert cache.captures == 1 and cache.replays == 5
    counts = kernel_counts(lambda: cache.run(("k10",), step, inputs[0]))
    assert _k10(counts) == 1, counts


def test_k10_reached_once_a_step_and_through_its_op(dev):
    """The step's hierarchy (fs.attach_hierarchy_batched, 3B problems)
    launches K10 once; the op on the card (the kernel, counted) equals its
    CPU implementation; the wrapper refuses what it does not take."""
    boxes = torch.from_numpy(np.stack([hierarchy_case(
        np.random.default_rng(s), 4, 50, 50, "dupes")[0] for s in range(3)]))
    valid = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (3, 4, 50)) < 0.8)
    boxes_dev, valid_dev = boxes.to(dev), valid.to(dev)
    on_card = fs.attach_hierarchy_batched(boxes_dev, valid_dev)
    counts = kernel_counts(
        lambda: fs.attach_hierarchy_batched(boxes_dev, valid_dev))
    assert _k10(counts) == 1, counts
    for g, w in zip(on_card, fs.attach_hierarchy_batched(boxes, valid)):
        assert torch.equal(g.cpu(), w)
    args = list(_k10_args(6, 50, 50, "grid", torch.device("cpu"), seed=4))
    got, want, counts = _op_pair(
        torch.ops.botsort_tpu_torch.hierarchy_scan, args, dev)
    assert _k10(counts) == 1, counts
    assert got.is_cuda and torch.equal(got.cpu(), want)
    iou, dist, used0, active = (a.to(dev) for a in args)
    # No size is refused: 1,025 targets (a block a problem) launch and
    # equal the plain version.
    big = _k10_args(1, 2, 1025, "dupes", dev, seed=9)
    assert torch.equal(hierarchy.greedy_scan_cuda(*big),
                       hierarchy.greedy_scan_plain(*big))
    counts = kernel_counts(lambda: hierarchy.greedy_scan_cuda(*big))
    assert counts["hierarchy_scan_block"] == 1, counts
    with pytest.raises(ValueError, match="float32"):
        hierarchy.greedy_scan_cuda(iou.double(), dist, used0, active)
    with pytest.raises(ValueError, match="float32"):
        hierarchy.greedy_scan_cuda(iou, dist, used0[:, :-1], active)


def test_mini_graphed_step_at_6300_candidates_equals_the_plain_nms(dev):
    """NMSConfig(pre_nms_top_k=6300) at a 480x640 detector input (6,300
    anchors, all candidates: K8 with its dominance words in the scratch
    buffer): the graphed one-stream facade equals the eager facade with
    nms_fixpoint_plain patched in for K8, on every FrameResult field of 3
    frames and the final stores."""
    bundle = assets.build_bundle(mini=True, seed=2, device=dev,
                                 dtype=torch.bfloat16)
    nms_cfg = dataclasses.replace(MINI_NMS, pre_nms_top_k=6300)
    pipe_cfg = dataclasses.replace(MINI_PIPE, detector_input_hw=(480, 640))
    widths = []
    real = nms.nms_fixpoint

    def recorded(boxes, valid, thr):
        widths.append(valid.shape[-1])
        return real(boxes, valid, thr)

    def plain(boxes, valid, thr):
        return nms.nms_fixpoint_plain(boxes, valid, thr)

    graphed_pipe = host.BoTSORTPipeline(bundle, MINI_TRK, nms_cfg, pipe_cfg,
                                        graphs=True)
    reference = host.BoTSORTPipeline(bundle, MINI_TRK, nms_cfg, pipe_cfg,
                                     graphs=False)
    for frames in _mini_frames(3, 1, 9):
        with mock.patch.object(nms, "nms_fixpoint", recorded):
            graphed_pipe.update(frames[0])
        with mock.patch.object(nms, "nms_fixpoint", plain):
            reference.update(frames[0])
        torch.cuda.synchronize()
        _same_result(reference.last_result, graphed_pipe.last_result)
        assert graphed_pipe.last_result.det_valid.any()
    assert widths and set(widths) == {6300}
    cache = graphed_pipe._graphs
    for key in cache.keys():
        counts = kernel_counts(cache._entries[key].replay)
        assert counts["nms_fixpoint_kernel"] == 1, (key, counts)
    for x, y in zip(host._store_tensors(reference.store),
                    host._store_tensors(graphed_pipe.store)):
        assert (x is None and y is None) or torch.equal(x, y)
