"""The port's encoder lowerings (K4 and K5) against the JAX package's.

K5, the depthwise 3x3 stencil: ``dw_conv3x3_plain`` (what the kernel
computes, on the CPU) against the JAX package's Pallas stencil in
interpret mode on the JAX test's shapes, float32 atol 1e-5 (the two sum
the same nine products in the same order; XLA:CPU may still contract or
reorder), and one bfloat16 case, equal to within one bfloat16 rounding
of the float32 sum. ``FaceReID(dw_mode="kernel")`` against the JAX
``dw_mode="pallas"`` model and against the port's ``"conv"`` mode, MINI
layout in float32, atol 2e-5 (the JAX test's bound between its modes).

K4, the fused stem + stage 1: ``stem_stage1_plain`` against the JAX
package's Pallas kernel in interpret mode at the JAX test's SMALL preset
(batch 2, 32x16, perturbed BN so the fold is exercised), relative L2
1e-2: both sides fold at the same points and round to bfloat16 after
every conv, but sum in other orders, so a rounding can flip. The fused
trunk against JAX's fused trunk and the port's unfused trunk: relative L2
3e-2, max 0.15 of scale, the JAX test's bound between its modes (the
unfused path computes BN after a bfloat16 conv store). JAX interpret runs
are shared through module-scoped fixtures and kept at batch <= 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu.models import facereid as jface
from botsort_tpu.models import fastreid as jbody
from botsort_tpu.models.facereid_pallas import dw_conv3x3_same as jdw
from botsort_tpu.models.fastreid_pallas import stem_stage1 as jstem
from botsort_tpu.ops import crop as jcrop
from botsort_tpu.pipeline import frame_step as jfs
from botsort_tpu_torch import config as tconfig
from botsort_tpu_torch.models import facereid as tface
from botsort_tpu_torch.models import facereid_dw, fastreid_fused
from botsort_tpu_torch.models import fastreid as tbody
from botsort_tpu_torch.models.common import cast_compute
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.runtime.from_flax import load_flax_variables

SMALL = dict(stage_blocks=(3, 1, 1, 1), stage_widths=(8, 16, 32, 64),
             stem_width=8)
FACE_MINI = dict(feature_dim=16, layout=((1, 8, 1, 1), (6, 12, 2, 2),
                                         (6, 16, 2, 2)), head_width=32)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _perturbed_vars(model, x, seed=0):
    """The JAX test's recipe (tests/test_fastreid_pallas.py): init, then
    randomise every parameter and BN statistic so the fold's scale and
    bias are exercised."""
    variables = model.init(jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed + 1)

    def perturb(leaf):
        a = np.asarray(leaf, np.float32)
        return jnp.asarray(rng.normal(0.1, 0.4, a.shape).astype(np.float32),
                           leaf.dtype)

    def perturb_var(leaf):
        a = np.asarray(leaf, np.float32)
        return jnp.asarray(rng.uniform(0.3, 1.8, a.shape).astype(np.float32),
                           leaf.dtype)

    params = jax.tree_util.tree_map(perturb, variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, l: perturb_var(l) if p[-1].key == "var" else perturb(l),
        variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _port(module, variables, dtype=torch.bfloat16):
    """A port module holding the Flax variables, convs and dense layers in
    ``dtype``."""
    cast_compute(module, dtype).eval().requires_grad_(False)
    return load_flax_variables(module, jax.device_get(variables))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-6)
    worst = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
    return rel, worst


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


# --- K5 ------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 8, 16), "float32"), ((1, 9, 13, 8), "float32"),
    ((4, 6, 10, 130), "float32"), ((1, 9, 13, 8), "bfloat16")])
def test_dw_plain_matches_jax_stencil(shape, dtype):
    rng = np.random.default_rng(5 + shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, shape[-1])).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = _nchw(jdw(jx, jnp.asarray(k), interpret=True))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    # The Flax kernel (3, 3, 1, C) is the port's weight (C, 1, 3, 3).
    tk = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = facereid_dw.dw_conv3x3_same(tx.contiguous(), tk)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        # One bfloat16 rounding of float32 sums that agree to 1e-5.
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-5)


# The face encoder's 13 stride-1 depthwise layers at 128x128, (H, W, C),
# and the odd shapes the card tests run.
FACE_DW_SHAPES = ([(64, 64, 32), (32, 32, 144)] + [(16, 16, 192)] * 2
                  + [(8, 8, 384)] * 4 + [(8, 8, 576)] * 2 + [(4, 4, 960)] * 3)
PLAN_CASES = sorted({(50, c, h, w, 2) for h, w, c in FACE_DW_SHAPES}) + [
    (1, 8, 9, 13, 4), (1, 8, 9, 13, 2), (4, 130, 6, 10, 2),
    (2, 1100, 5, 7, 2), (1, 3, 40, 1500, 4), (2, 20, 40, 8, 2),
    (2, 20, 24, 16, 2), (3, 40, 12, 24, 2), (1, 100, 16, 16, 2),
    (2, 33, 4, 4, 2), (2, 12, 6, 2, 4), (1, 5, 300, 8, 4), (1, 1, 1, 1, 2)]


def _plan_block(plan, shape, bx, by):
    """What one block of csrc/dw_conv3x3.cu does under ``plan``, in the
    kernel's own index arithmetic: (p0, the loaded span's first element
    and length, where it lands in the tile, and every run as arrays of
    plane-in-tile, output row, first column)."""
    n, c, h, w = shape
    if plan.band:
        p0, y0 = bx, by * plan.rows
        rows, planes = min(plan.rows, h - y0), 1
        tile_y0, tile_rows = y0 - 1, plan.rows + 2
        lo, hi = max(y0 - 1, 0), min(y0 + rows + 1, h)
    else:
        p0, y0, rows = bx * plan.planes, 0, h
        planes = min(plan.planes, n * c - p0)
        tile_y0, tile_rows, lo, hi = 0, h, 0, h * planes
    load = ((p0 * h + lo) * w, (hi - lo) * w, (lo - tile_y0) * w)
    rpr = w // plan.rw
    runs = []
    stride = plan.threads
    sc, sr = stride % rpr, stride // rpr
    sp, sr = sr // rows, sr % rows
    for t in range(plan.threads):
        rc, rr = t % rpr, t // rpr
        lp, rr = rr // rows, rr % rows
        while lp < planes:
            runs.append((lp, y0 + rr, rc * plan.rw))
            rc += sc
            carry = int(rc >= rpr)
            rc -= carry * rpr
            rr += sr + carry
            carry = int(rr >= rows)
            rr -= carry * rows
            lp += sp + carry
    runs = np.array(runs, np.int64).reshape(-1, 3)
    return p0, load, (tile_y0, tile_rows), runs


@pytest.mark.parametrize("case", PLAN_CASES)
def test_dw_plan_writes_every_output_once_and_reads_in_bounds(case):
    """K5's launch plan on the face encoder's shapes at 50 faces and the
    card tests' odd shapes: every output is written by exactly one run,
    every tile read lies in the loaded span or is masked as padding, and
    the vector path's loads and stores are aligned. Blocks of one kind
    differ only by their offset, so each kind is walked once."""
    *shape, itemsize = case
    n, c, h, w = shape
    plan = facereid_dw.dw_plan(shape, itemsize)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.smem <= 227 * 1024 and w % plan.rw == 0
    if plan.rw > 1:
        assert plan.rw * itemsize == 16
    n_planes = n * c
    gx, gy = plan.grid
    count = np.zeros((n_planes, h, w), np.int32)
    kinds = {}
    for bx in range(gx):
        for by in range(gy):
            full = (bx + 1) * plan.planes <= n_planes
            key = (by, full) if not plan.band else by
            if key not in kinds:
                kinds[key] = _plan_block(plan, shape, bx, by)
            p0_kind, load, (tile_y0, tile_rows), runs = kinds[key]
            p0 = bx * (1 if plan.band else plan.planes)
            shift = (p0 - p0_kind) * h * w
            start, length, dst = load
            assert 0 <= start + shift and \
                start + shift + length <= n_planes * h * w
            assert 0 <= dst and (dst + length) * itemsize <= plan.smem
            lp, y, x0 = runs.T
            for j in range(plan.rw):
                np.add.at(count, (p0 + lp, y, x0 + j), 1)
    assert (count == 1).all()
    for key, (p0, (start, length, dst), (tile_y0, tile_rows),
              runs) in kinds.items():
        lp, y, x0 = runs.T
        if plan.rw > 1:
            assert (((p0 + lp) * h * w + y * w + x0) % plan.rw == 0).all()
        for r in range(3):
            wy = y - 1 + r
            inside = (wy >= 0) & (wy < h)
            tile_at = (lp * tile_rows + wy - tile_y0) * w
            loaded = (tile_at >= dst) & (tile_at + w <= dst + length)
            assert (loaded | ~inside).all()
            assert ((tile_at + w) * itemsize <= plan.smem)[inside].all()
            assert ((tile_at + x0) % plan.rw == 0)[inside].all()
        assert ((x0 >= 0) & (x0 + plan.rw <= w)).all()


@pytest.fixture(scope="module")
def faces():
    x = np.random.default_rng(11).uniform(0, 255, (3, 32, 32, 3)).astype(
        np.float32)
    conv = jface.FaceReID(**FACE_MINI, dtype=jnp.float32, dw_mode="conv")
    params = jax.jit(conv.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    pall = jface.FaceReID(**FACE_MINI, dtype=jnp.float32, dw_mode="pallas")
    want = np.asarray(jax.jit(pall.apply)(params, jnp.asarray(x)))
    return x, params, pall, want


def test_face_kernel_mode_matches_jax_pallas_and_conv_mode(faces):
    x, params, _, want = faces
    kern = _port(tface.FaceReID(**FACE_MINI, dw_mode="kernel"), params,
                 torch.float32)
    conv = _port(tface.FaceReID(**FACE_MINI), params, torch.float32)
    with torch.no_grad():
        got = kern(torch.from_numpy(x))
        ref = conv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5)


def test_face_encode_and_compare_matches_jax(faces):
    x, params, pall, _ = faces
    targets = np.random.default_rng(12).normal(size=(5, 16)).astype(
        np.float32)
    want_f, want_s = jface.encode_and_compare(pall, params, jnp.asarray(x),
                                              jnp.asarray(targets))
    kern = _port(tface.FaceReID(**FACE_MINI, dw_mode="kernel"), params,
                 torch.float32)
    with torch.no_grad():
        got_f, got_s = tface.encode_and_compare(
            kern, torch.from_numpy(x), torch.from_numpy(targets))
    assert got_f.shape == (3, 16) and got_s.shape == (3, 5)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-4)


def test_face_taps_follow_weight_updates(faces):
    """The depthwise layers' [9, C] taps are built once per weight and
    rebuilt after an in-place write, a load_state_dict, a new tensor
    assigned to the weight's data and a dtype round trip; the features
    still equal the JAX lowered model."""
    x, params, _, want = faces
    kern = _port(tface.FaceReID(**FACE_MINI, dw_mode="kernel"), params,
                 torch.float32)
    layers = [m for m in kern.modules() if getattr(m, "dw_kernel", False)]
    assert layers
    layer = layers[0]
    first = layer.taps()
    assert layer.taps() is first
    state = {k: v.clone() for k, v in kern.state_dict().items()}
    with torch.no_grad():
        layer.Conv_0.weight.mul_(2.0)
    second = layer.taps()
    assert second is not first
    assert torch.equal(second, facereid_dw.taps_of(layer.Conv_0.weight))
    assert torch.equal(second, 2.0 * first)
    kern.load_state_dict(state)
    third = layer.taps()
    assert third is not second and torch.equal(third, first)
    # A new tensor behind the parameter, and a dtype round trip: both
    # replace the weight's data without an in-place write.
    weight = layer.Conv_0.weight
    kept = weight.data
    weight.data = 3.0 * kept
    assert torch.equal(layer.taps(), 3.0 * first)
    weight.data = kept.clone()
    assert torch.equal(layer.taps(), first)
    kern.to(torch.bfloat16).to(torch.float32)
    rounded = layer.taps()
    assert torch.equal(rounded, facereid_dw.taps_of(layer.Conv_0.weight))
    assert not torch.equal(rounded, first)
    kern.load_state_dict(state)
    assert torch.equal(layer.taps(), first)
    with torch.no_grad():
        got = kern(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("mode", ["shift", "skip"])
def test_face_probe_modes_are_not_ported(mode):
    with pytest.raises(ValueError, match="not ported"):
        tface.FaceReID(**FACE_MINI, dw_mode=mode)


def test_state_dicts_identical_across_modes():
    def layout(module):
        return [(k, tuple(v.shape), v.dtype)
                for k, v in module.state_dict().items()]

    assert layout(tface.FaceReID(dw_mode="kernel")) == \
        layout(tface.FaceReID())
    assert layout(tbody.FastReIDSBS(fused_stem=True)) == \
        layout(tbody.FastReIDSBS())


@pytest.mark.parametrize("fn,args", [
    (facereid_dw.dw_conv3x3_same, lambda: (torch.zeros(1, 4, 5, 5),
                                           torch.zeros(4, 1, 3, 3))),
    (fastreid_fused.stem_stage1, lambda: (
        torch.zeros(1, 32, 16, 3, dtype=torch.bfloat16), None))])
def test_dispatchers_refuse_other_devices(fn, args):
    x, w = args()
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(x.to("meta"), w)


# --- K4 ------------------------------------------------------------------

@pytest.fixture(scope="module")
def trunk():
    """JAX's SMALL ResNeSt50 with perturbed variables: the Pallas stem in
    interpret mode, the fused trunk and the plain trunk on one batch."""
    x = np.random.default_rng(2).normal(0, 1, (2, 32, 16, 3)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    plain = jbody.ResNeSt50(**SMALL, dtype=jnp.bfloat16, fused_stem=False)
    fused = jbody.ResNeSt50(**SMALL, dtype=jnp.bfloat16, fused_stem=True)
    variables = _perturbed_vars(plain, jx)
    v = variables
    stem_vars = [{"params": v["params"][f"_ConvBN_{i}"],
                  "batch_stats": v["batch_stats"][f"_ConvBN_{i}"]}
                 for i in range(3)]
    block_vars = [{"params": v["params"][f"SplAtBottleneck_{i}"],
                   "batch_stats": v["batch_stats"][f"SplAtBottleneck_{i}"]}
                  for i in range(3)]
    return dict(
        x=x, variables=variables,
        stem=np.asarray(jstem(jx, stem_vars, block_vars, SMALL["stem_width"],
                              SMALL["stage_widths"][0], interpret=True),
                        np.float32),
        fused=np.asarray(fused.apply(variables, jx), np.float32),
        plain=np.asarray(plain.apply(variables, jx), np.float32))


def _port_trunk(trunk, **kw):
    return _port(tbody.ResNeSt50(**{**SMALL, **kw}), trunk["variables"])


def _nchw_input(x, dtype=torch.bfloat16):
    return torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)


def test_stem_plain_matches_jax_kernel(trunk):
    folded = fastreid_fused.fold_stem_stage1(_port_trunk(trunk))
    x = torch.from_numpy(trunk["x"]).to(torch.bfloat16)
    got = fastreid_fused.stem_stage1(x, folded)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 32, 8, 4)
    rel, worst = _rel(got.float().numpy(), _nchw(trunk["stem"]))
    assert rel <= 1e-2, f"relative L2 {rel:.5f}"
    assert worst <= 0.05, f"max error {worst:.4f} of scale"


def test_fused_trunk_matches_jax_fused_and_port_unfused(trunk):
    fused = _port_trunk(trunk, fused_stem=True)
    unfused = _port_trunk(trunk)
    with torch.no_grad():
        got = fused(_nchw_input(trunk["x"])).float().numpy()
        ref = unfused(_nchw_input(trunk["x"])).float().numpy()
    for want, what in ((_nchw(trunk["fused"]), "JAX fused"),
                       (ref, "port unfused"), (_nchw(trunk["plain"]),
                                               "JAX plain")):
        rel, worst = _rel(got, want)
        assert rel < 3e-2 and worst < 0.15, (what, rel, worst)


@pytest.mark.parametrize("case", ["geometry", "float32", "stage_blocks"])
def test_fused_dispatch_takes_the_plain_modules(trunk, case):
    """The JAX model's static dispatch: an unsupported geometry, float32
    convs or a stage 1 without three blocks run the unfused modules, with
    exactly their output."""
    x = trunk["x"]
    kw, dtype = {}, torch.bfloat16
    if case == "geometry":
        x = np.random.default_rng(3).normal(0, 1, (1, 32, 12, 3)).astype(
            np.float32)
    elif case == "float32":
        dtype = torch.float32
    else:
        kw = dict(stage_blocks=(2, 1, 1, 1))
    layout = {**SMALL, **kw}
    fused = cast_compute(tbody.ResNeSt50(**layout, fused_stem=True), dtype)
    plain = cast_compute(tbody.ResNeSt50(**layout), dtype)
    plain.load_state_dict(fused.state_dict())
    xi = _nchw_input(x, dtype)
    assert not fused.uses_fused_stem(xi.shape[2], xi.shape[3])
    with torch.no_grad():
        assert torch.equal(fused.eval()(xi), plain.eval()(xi))


def test_fold_follows_weight_updates(trunk):
    """The folded weights are refolded when a weight is written in place."""
    model = _port_trunk(trunk, fused_stem=True)
    first = model.folded_stem_stage1()
    assert model.folded_stem_stage1() is first
    with torch.no_grad():
        model._ConvBN_1.BatchNorm_0.running_var.mul_(2.0)
    second = model.folded_stem_stage1()
    assert second is not first
    assert not torch.equal(second.stem[1].scale, first.stem[1].scale)


# K4's tiling (fastreid_fused.conv_plan), walked on the CPU: the kernels'
# index arithmetic in numpy, no card.

FULL_W = dict(sw=32, width=64)
SMALL_W = dict(sw=SMALL["stem_width"], width=SMALL["stage_widths"][0])


def _group_width(spec):
    return spec.cout // spec.groups


@pytest.mark.parametrize("n,h,w", [(128, 256, 128), (8, 384, 128),
                                   (1, 256, 128), (7, 40, 16)])
def test_conv_plan_full_width_takes_the_fast_paths(n, h, w):
    ff = fastreid_fused
    plans = ff.conv_plan(n, h, w, **FULL_W)
    specs = ff.conv_specs(**FULL_W)
    assert [p.name for p in plans] == [s.name for s in specs]
    assert len(plans) == 13 and plans[0].path == ff.STEM0
    for plan, spec in zip(plans[1:], specs[1:]):
        want = {("conv", 3): ff.HALO, ("conv", 1): ff.RING,
                ("out", 1): ff.OUT}[(spec.role, spec.ksize)]
        assert plan.path == want, plan
        # Nothing is padded: the tile is the group's own output width.
        assert plan.n_tile == _group_width(spec), plan
        assert plan.m_tile == ff.TILE_M and plan.n_inst in (32, 64)
        assert plan.threads == ff.FAST_THREADS
        assert plan.smem <= ff.SMEM_LIMIT
        if plan.path == ff.RING:
            assert plan.stages >= 3
    # K steps of 64: two taps of 32 channels, a quarter of a 256-wide 1x1.
    steps = {p.name: p.k_steps for p in plans}
    assert steps["stem1"] == steps["block1.split"] == 5
    assert steps["block0.in"] == 1 and steps["block1.in"] == 4
    fused = [p for p in plans if p.fused_into]
    assert [p.name for p in fused] == ["block0.shortcut"]
    assert fused[0].fused_into == "block0.out" and fused[0].smem == 0
    tiles = -(-(h // 4) * (w // 4) // ff.TILE_M)
    out = {p.name: p for p in plans}["block2.out"]
    assert out.grid == (n * tiles, 1, 1)


def test_conv_plan_small_preset_takes_the_general_path():
    ff = fastreid_fused
    plans = ff.conv_plan(2, 32, 16, **SMALL_W)
    assert plans[0].path == ff.STEM0      # 8 output channels: one chunk
    assert all(p.path == ff.GENERAL for p in plans[1:])
    # ... and so do the folded weights' packings, conv for conv.
    model = cast_compute(tbody.ResNeSt50(**SMALL), torch.bfloat16)
    folded = fastreid_fused.fold_stem_stage1(model)
    assert ff._folded_paths(folded) == [p.path for p in plans]
    full = cast_compute(tbody.ResNeSt50(stage_blocks=(3, 1, 1, 1)),
                        torch.bfloat16)
    assert ff._folded_paths(fastreid_fused.fold_stem_stage1(full)) == [
        p.path for p in ff.conv_plan(1, 256, 128, **FULL_W)]


def test_launch_plan_refuses_what_does_not_fit():
    ff = fastreid_fused
    plan, total = ff._launch_plan(2, 256, 128, 32, 64)
    assert total == ff.stem_stage1_scratch_bytes(2, 256, 128, 32, 64)
    assert len(plan) == 9 + 12 * 5
    assert list(plan[9:14]) == [2, 8, 2, ff.conv_plan(
        2, 256, 128, 32, 64)[0].smem, 1]
    with pytest.raises(ValueError, match="shared memory"):
        ff._launch_plan(1, 64, 8192, 32, 64)   # a 2048-pixel-wide halo


@pytest.mark.parametrize("shape,groups,path", [
    ((32, 3, 3, 3), 1, "stem0"), ((8, 3, 3, 3), 1, "general"),
    ((32, 32, 3, 3), 1, "halo"), ((64, 32, 3, 3), 1, "halo"),
    ((128, 32, 3, 3), 2, "halo"), ((64, 256, 1, 1), 1, "ring"),
    ((256, 64, 1, 1), 1, "out"), ((16, 4, 3, 3), 2, "general"),
    ((72, 40, 1, 1), 1, "general")])
def test_pack_conv_round_trips(shape, groups, path):
    rng = np.random.default_rng(sum(shape))
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    packed = fastreid_fused.pack_conv(w, groups, path)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    k = shape[1] * shape[2] * shape[3]
    if path in ("halo", "ring", "out"):
        assert packed.shape == (groups, -(-k // 64), shape[0] // groups, 64)
    assert int((packed != 0).sum()) == int((w != 0).sum())  # zeros pad
    back = fastreid_fused.unpack_conv(packed, shape, groups, path)
    assert torch.equal(back, w)


def _halo_conv_walk(x, weight, groups):
    """The 3x3 kernel's arithmetic (csrc/stem_stage1.cu::halo_conv_kernel)
    in numpy: per block the table of every k16 slice's tap and halo byte
    offset, per tile of 128 consecutive pixels the halo span with
    zero-fill, per row the nine taps' validity bits from a row mask and a
    column mask. Returns the float32 sums [n, h, w, cout], how often each
    output was written, and checks every read."""
    ff = fastreid_fused
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    cin_g, n_tile = cin // groups, cout // groups
    assert ff.conv_path("conv", cin_g, n_tile, 3, 1) == ff.HALO
    lg = cin_g.bit_length() - 1
    packed = ff.pack_conv(weight, groups, ff.HALO).float().numpy()
    k_steps = packed.shape[1]
    hw = h * w
    tiles = -(-hw // ff.TILE_M)
    halo_px = ff.halo_pixels(w)
    pitch = ff.halo_pitch(cin_g)
    assert 4 * k_steps <= 128                   # the table's room
    table = []
    for k in range(0, 64 * k_steps, 16):
        tap = k >> lg
        at = min(tap, 8)        # K past the ninth tap: read tap 8, masked
        ky = (at * 11) >> 5
        assert ky == at // 3
        off = (ky * w + at - 3 * ky) * pitch + (k & (cin_g - 1)) * 2
        assert off < 1 << 24
        table.append(tap << 24 | off)
    xf = x.reshape(n, hw, cin)
    out = np.zeros((n, hw, cout), np.float32)
    written = np.zeros((n, hw, cout), np.int32)
    for t in range(n * tiles):
        img, tile = divmod(t, tiles)
        p0 = tile * ff.TILE_M
        for g in range(groups):
            halo = np.zeros((halo_px, cin_g), np.float32)
            for hq in range(halo_px):
                q = p0 - w - 1 + hq
                if 0 <= q < hw:             # else zero-filled, nothing read
                    halo[hq] = xf[img, q, g * cin_g:(g + 1) * cin_g]
            acc = np.zeros((ff.TILE_M, n_tile), np.float32)
            for row in range(ff.TILE_M):
                p = p0 + row
                oy, ox = divmod(p, w)
                rows = (0x007 if oy > 0 else 0) | 0x038 | (
                    0x1C0 if oy + 1 < h else 0)
                cols = (0x049 if ox > 0 else 0) | 0x092 | (
                    0x124 if ox + 1 < w else 0)
                taps_ok = rows & cols if p < hw else 0
                for tp in range(9):
                    iy, ix = oy + tp // 3 - 1, ox + tp % 3 - 1
                    inside = p < hw and 0 <= iy < h and 0 <= ix < w
                    assert bool((taps_ok >> tp) & 1) == inside
                for ks in range(k_steps):
                    for kk in range(4):
                        tap, off = divmod(table[ks * 4 + kk], 1 << 24)
                        hq, ci = row + off // pitch, off % pitch // 2
                        assert 0 <= hq < halo_px       # ldmatrix's read
                        assert ci + 16 <= cin_g
                        a = halo[hq, ci:ci + 16]
                        assert a.shape == (16,)
                        if not (taps_ok >> tap) & 1:
                            a = np.zeros(16, np.float32)
                        acc[row] += a @ packed[g, ks, :, kk * 16:kk * 16 + 16].T
            rows_valid = hw - p0
            for row in range(min(ff.TILE_M, rows_valid)):
                sl = slice(g * n_tile, (g + 1) * n_tile)
                out[img, p0 + row, sl] = acc[row]
                written[img, p0 + row, sl] += 1
    return out.reshape(n, h, w, cout), written


@pytest.mark.parametrize("n,h,w,cin,cout,groups", [
    (1, 10, 16, 32, 32, 1),     # 160 pixels: a partial second tile
    (3, 6, 8, 64, 128, 2),      # odd N, one partial tile, two groups
    (1, 16, 8, 64, 64, 1)])     # a tap of 64 channels a K step
def test_halo_conv_walk_covers_every_output_once(n, h, w, cin, cout, groups):
    rng = np.random.default_rng(n * 100 + h)
    x = rng.integers(-4, 5, (n, h, w, cin)).astype(np.float32)
    weight = torch.from_numpy(rng.integers(-3, 4, (
        cout, cin // groups, 3, 3)).astype(np.float32))
    got, written = _halo_conv_walk(x, weight, groups)
    assert (written == 1).all()
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), weight, padding=1,
        groups=groups).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)   # small integers: exact


@pytest.mark.parametrize("n,h,w", [(1, 256, 128), (3, 40, 16), (2, 384, 128)])
def test_tiles_cover_every_stage1_pixel_once(n, h, w):
    """The ring and last-1x1 kernels' tiles: image x tile of 128 pixels,
    chunk tid % 8 of rows tid / 8 + 32 i, rows past the image masked."""
    ff = fastreid_fused
    hw = (h // 4) * (w // 4)
    tiles = -(-hw // ff.TILE_M)
    plan = {p.name: p for p in ff.conv_plan(n, h, w, **FULL_W)}["block1.out"]
    assert plan.grid[0] == n * tiles
    seen = np.zeros((n, hw, 8), np.int32)
    for block in range(plan.grid[0]):
        img, tile = divmod(block, tiles)
        p0 = tile * ff.TILE_M
        rows_valid = hw - p0
        for tid in range(ff.FAST_THREADS):
            for i in range(4):
                r = (tid >> 3) + 32 * i
                if r < rows_valid:
                    seen[img, p0 + r, tid & 7] += 1
    assert (seen == 1).all()


def test_scratch_layout_matches_the_plan():
    ff = fastreid_fused
    n, h, w = 5, 256, 128
    offsets, total = ff.scratch_layout(n, h, w, **FULL_W)
    assert list(offsets) == ["stem_a", "stem_b", "pooled", "t", "y",
                             "partial", "att", "x1", "x2"]
    assert all(o % 256 == 0 for o in offsets.values())
    s1, s2 = n * 128 * 64, n * 64 * 32
    tiles = {p.name: p for p in ff.conv_plan(n, h, w, **FULL_W)}[
        "block0.split"]
    assert tiles.m_tile == 128
    sizes = [s1 * 64 * 2, s1 * 64 * 2, s2 * 64 * 2, s2 * 64 * 2,
             s2 * 128 * 2, n * (64 * 32 // 128) * 128 * 4, n * 128 * 4,
             s2 * 256 * 2, s2 * 256 * 2]
    assert total == sum(-(-b // 256) * 256 for b in sizes)
    assert total == ff.stem_stage1_scratch_bytes(n, h, w, **FULL_W)
    # Gone: the float32 shortcut [N, H/4, W/4, 256] and the attention's
    # bfloat16 output [N, H/4, W/4, 64].
    assert total < sum(sizes[:5] + sizes[7:]) + s2 * 64 * 2


def test_prepared_pointers_are_cached_per_folded_object():
    ff = fastreid_fused
    model = cast_compute(tbody.ResNeSt50(**SMALL), torch.bfloat16)
    folded = ff.fold_stem_stage1(model)
    cpu = torch.device("cpu")
    first = ff._prepared(folded, cpu)
    assert ff._prepared(folded, cpu) is first and len(first) == 57
    again = ff.fold_stem_stage1(model)
    assert ff._prepared(again, cpu) is not first
    # Weights packed for another path than the plan's are refused.
    blk = again.blocks[0]
    bad = blk._replace(conv_in=blk.conv_in._replace(path=ff.RING))
    with pytest.raises(ValueError, match="packed for"):
        ff._prepared(again._replace(blocks=(bad,) + again.blocks[1:]), cpu)


def test_k4_probe_layers_end_in_the_plain_output():
    """cli/k4_probe.py holds each scratch buffer against the plain version
    layer by layer: its layer walk must end in stem_stage1_plain's output
    and name the buffers scratch_layout keeps."""
    from botsort_tpu_torch.cli import k4_probe

    model = cast_compute(tbody.ResNeSt50(**SMALL), torch.bfloat16).eval()
    folded = fastreid_fused.fold_stem_stage1(model)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 32, 16, 3)).astype(np.float32)).to(torch.bfloat16)
    kept = k4_probe.plain_layers(x, folded)
    assert torch.equal(kept["x2"],
                       fastreid_fused.stem_stage1_plain(x, folded))
    assert kept["stem1"].shape == (2, 8, 16, 8)
    assert kept["y2"].shape == (2, 16, 8, 4)


def test_body_encode_and_compare_matches_jax():
    """The body contract's order, (similarities, features), on the MINI
    float32 encoder."""
    mini = dict(stage_blocks=(1, 1, 1, 1), stage_widths=(8, 16, 32, 64),
                stem_width=8)
    model = jbody.FastReIDSBS(**mini, dtype=jnp.float32)
    x = np.random.default_rng(4).normal(0, 1, (3, 64, 32, 3)).astype(
        np.float32)
    targets = np.random.default_rng(5).normal(size=(4, 256)).astype(
        np.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want_s, want_f = jbody.encode_and_compare(model, params, jnp.asarray(x),
                                              jnp.asarray(targets))
    port = _port(tbody.FastReIDSBS(**mini), params, torch.float32)
    with torch.no_grad():
        got_s, got_f = tbody.encode_and_compare(port, torch.from_numpy(x),
                                                torch.from_numpy(targets))
    assert got_s.shape == (3, 4) and got_f.shape == (3, 256)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-3)


# --- the slice: the embed stage with both lowered encoders ---------------

TRK = TrackerConfig(max_dets=2, body_feature_dim=256, face_feature_dim=16)
NMSC = NMSConfig(max_boxes_per_class=4)
PIPE = PipelineConfig(body_reid_input_hw=(32, 16), face_reid_input_hw=(32, 32),
                      max_reid_batch=2, compute_dtype="float32",
                      crop_int8=False)


def _port_cfg(cfg):
    cls = getattr(tconfig, type(cfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items()
                  if k in names})


def test_embed_with_lowered_encoders_matches_jax(trunk, faces):
    """embed_batched with FastReIDSBS(fused_stem=True) (SMALL, bfloat16)
    and FaceReID(dw_mode="kernel") (MINI, float32) against the JAX embed
    stage with the same lowerings, on injected detections: two bodies, one
    with a face. Body features: relative L2 3e-2 (K4's tolerance carried
    through bfloat16 stages 2-4, where Flax computes BN in bfloat16);
    face features: atol 1e-4, as tests/test_torch_pipeline.py holds them."""
    body_j = jbody.FastReIDSBS(**SMALL, dtype=jnp.bfloat16, fused_stem=True)
    jv = trunk["variables"]
    body_params = body_j.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 16, 3)))
    body_params = {"params": {**body_params["params"],
                              "ResNeSt50_0": jv["params"]},
                   "batch_stats": {**body_params["batch_stats"],
                                   "ResNeSt50_0": jv["batch_stats"]}}
    _, face_params, face_j, _ = faces

    rng = np.random.default_rng(9)
    frame = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
    boxes = np.zeros((4, 4, 4), np.float32)
    boxes[0, 0], boxes[0, 1] = (10, 5, 40, 60), (50, 8, 90, 62)  # bodies
    boxes[1, 0] = (15, 6, 30, 20)                                # head
    boxes[3, 0] = (17, 8, 28, 19)                                # face
    face_for_head = np.array([0, -1, -1, -1], np.int32)
    head_for_body = np.array([0, -1, -1, -1], np.int32)

    @jax.jit
    def jembed(frame, boxes, face_for_head, head_for_body):
        def body(tlbr):
            crops = jcrop.crop_and_resize(frame, tlbr,
                                          PIPE.body_reid_input_hw)
            return body_j.apply(body_params, jbody.preprocess(crops))

        def face(tlbr):
            crops = jcrop.crop_and_resize(frame, tlbr,
                                          PIPE.face_reid_input_hw)
            return face_j.apply(face_params, crops)

        bf = jfs._encode_chunked(body, boxes[0][:2], 2, 2, 256, 2)
        hb = head_for_body[:2]
        fb = jnp.where(hb >= 0, face_for_head[jnp.clip(hb, 0, None)], -1)
        face_tlbr = jnp.where((fb >= 0)[:, None],
                              boxes[3][jnp.clip(fb, 0, None)], 0.0)
        ff = jfs._encode_faces(face, face_tlbr, fb >= 0, 2, 2, 16, 2)
        return bf, ff

    want_b, want_f = jembed(jnp.asarray(frame), jnp.asarray(boxes),
                            jnp.asarray(face_for_head),
                            jnp.asarray(head_for_body))

    body_t = _port(tbody.FastReIDSBS(**SMALL, fused_stem=True), body_params)
    face_t = _port(tface.FaceReID(**FACE_MINI, dw_mode="kernel"),
                   face_params, torch.float32)
    assert body_t.ResNeSt50_0.uses_fused_stem(*PIPE.body_reid_input_hw)
    bundle = tfs.ModelBundle(None, body_t, face_t)
    with torch.no_grad():
        got_b, got_f = tfs.embed_batched(
            bundle, torch.from_numpy(frame)[None],
            torch.from_numpy(boxes)[None],
            torch.from_numpy(face_for_head)[None],
            torch.from_numpy(head_for_body)[None], _port_cfg(TRK),
            _port_cfg(NMSC), _port_cfg(PIPE), 2, 2)
    rel, _ = _rel(got_b[0].numpy(), np.asarray(want_b))
    assert rel <= 3e-2, f"body features: relative L2 {rel:.5f}"
    np.testing.assert_allclose(got_f[0].numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-4)
