"""The port's crop-and-resize modes (kernel K7's plain versions) and its
steps at the JAX package's default ``PipelineConfig`` against the JAX
package.

At the JAX default (``compute_dtype="bfloat16"``, ``crop_int8=True``) the
JAX steps crop a uint8 frame with ``crop_and_resize_int8`` and a float
frame with ``crop_and_resize(compute_dtype=bfloat16)``. The port's
bfloat16 and int8 modes equal those jitted JAX functions bit for bit on
seeded frames, with full-frame, edge-clamped, one-pixel and degenerate
boxes at B = 1 and 3; the float32 mode stays within the resize tolerance
of tests/test_torch_pipeline.py (1e-3). ``frame_step``,
``frame_step_batched`` and the temporal step then run at the JAX default
on both sides (MINI float32 networks with the JAX weights carried over):
every detector input and crop the step makes is bit-equal, read from
inside the jitted JAX step with ``jax.debug.callback``; downstream, the
tolerances of the end-to-end step tests (ids and validity exact, track
boxes atol 1e-3).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.config import PipelineConfig
from botsort_tpu.ops import crop as jcrop
from botsort_tpu.pipeline import frame_step as jfs
from botsort_tpu.track import state as jstate
from botsort_tpu_torch.ops import crop as tcrop
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.track import cascade as tcascade
from botsort_tpu_torch.track import state as tstate
from tests.test_torch_cascade import jax_tpu_cascade
from tests.test_torch_multistream import _stream_frames
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    NMSC,
    PIPE,
    SRC_HW,
    TRK,
    T_NMSC,
    T_TRK,
    _close,
    _eq,
    _frames,
    _port,
    bundles,
)
from tests.test_torch_temporal import _groups

# The MINI geometry of tests/test_torch_pipeline.py at the JAX default
# interpolation (its PIPE pins float32).
DEFAULT = dataclasses.replace(
    PIPE, compute_dtype=PipelineConfig().compute_dtype,
    crop_int8=PipelineConfig().crop_int8)
T_DEFAULT = _port(DEFAULT)
OUT_HWS = ((96, 128), (64, 32), (32, 32), (300, 400))


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """A fresh jit cache (the captures below patch a function that jitted
    steps look up while tracing) and one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    yield
    jax.clear_caches()
    torch.set_num_threads(n)


def _boxes(rng, n, hw):
    """[n >= 11, 4] float32 boxes: full-frame, edge-clamped (right,
    bottom, corner), one pixel wide and high, degenerate (rows 6-9: zero,
    w < 1, h < 1) and random ones with integer corners."""
    h, w = hw
    fixed = [[0, 0, w, h], [w - 37, 5, w, 90], [3, h - 40, 70, h],
             [w - 20, h - 30, w, h], [5, 7, 6, 60], [9, 3, 80, 4],
             [40, 50, 40.5, 90], [0, 0, 0, 0], [10, 10, 10.5, 40],
             [10, 10, 60, 10.25], [w - 1, h - 1, w, h]]
    out = list(fixed)
    while len(out) < n:
        x1, y1 = rng.integers(0, w - 2), rng.integers(0, h - 2)
        out.append([x1, y1, rng.integers(x1 + 1, w + 1),
                    rng.integers(y1 + 1, h + 1)])
    return np.asarray(out[:n], np.float32)


def _jax_crop_fn(mode, hw):
    """The JAX function of a mode, jitted and vmapped over frames, as the
    JAX steps run it."""
    if mode == "int8":
        one = functools.partial(jcrop.crop_and_resize_int8, out_hw=hw)
    else:
        one = functools.partial(jcrop.crop_and_resize, out_hw=hw,
                                compute_dtype=jnp.dtype(mode))
    return jax.jit(jax.vmap(lambda f, b: one(f, b)))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("mode", ["bfloat16", "int8", "float32"])
def test_plain_mode_matches_jax(mode, batch):
    rng = np.random.default_rng(7 + batch)
    frames = rng.integers(0, 256, (batch,) + SRC_HW + (3,), dtype=np.uint8)
    boxes = np.stack([_boxes(rng, 14, SRC_HW) for _ in range(batch)])
    for hw in OUT_HWS:
        want = np.asarray(_jax_crop_fn(mode, hw)(frames, boxes))
        got = tcrop.crop_resize_plain(torch.from_numpy(frames),
                                      torch.from_numpy(boxes), hw, mode)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if mode == "float32":
            _close(got, want, 1e-3, f"{hw}")
        else:
            _eq(got, want, f"{mode} {hw}")
        # Degenerate boxes (the zero box, w < 1, h < 1) give +0.0.
        for k in (6, 7, 8, 9):
            assert not torch.signbit(got[:, k]).any()
            assert not got[:, k].any()


@pytest.mark.parametrize("compute_dtype,crop_int8,frame_dtype,mode", [
    ("bfloat16", True, torch.uint8, "int8"),
    ("bfloat16", True, torch.float32, "bfloat16"),
    ("bfloat16", False, torch.uint8, "bfloat16"),
    ("float32", True, torch.uint8, "float32"),
    ("float32", False, torch.float32, "float32"),
])
def test_crop_mode_follows_the_jax_dispatch(compute_dtype, crop_int8,
                                            frame_dtype, mode):
    """The JAX frame step's ``_crop`` rule: int8 only for a uint8 frame
    at bfloat16 with ``crop_int8``; float frames never take int8. The
    port's ``_crop`` equals JAX's ``_crop`` on the same frame."""
    cfg = dataclasses.replace(PIPE, compute_dtype=compute_dtype,
                              crop_int8=crop_int8)
    assert tcrop.crop_mode(_port(cfg), frame_dtype) == mode
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, SRC_HW + (3,), dtype=np.uint8)
    if frame_dtype == torch.float32:
        frame = (frame + rng.uniform(0, 1, frame.shape)).astype(np.float32)
    boxes = _boxes(rng, 12, SRC_HW)
    hw = cfg.body_reid_input_hw
    want = np.asarray(jax.jit(lambda f, b: jfs._crop(
        f, b, hw, jfs._compute_dtype(cfg), cfg))(frame, boxes))
    got = tcrop._crop(torch.from_numpy(frame)[None],
                      torch.from_numpy(boxes)[None], hw, _port(cfg))[0]
    if mode == "float32":
        _close(got, want, 1e-3, mode)
    else:
        _eq(got, want, mode)


@pytest.mark.parametrize("mode", ["bfloat16", "int8", "float32"])
def test_custom_op_is_the_plain_version_on_the_cpu(mode):
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(
        rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8))
    boxes = torch.from_numpy(np.stack([_boxes(rng, 12, (40, 56))] * 2))
    want = tcrop.crop_resize_plain(frames, boxes, (24, 16), mode)
    got = torch.ops.botsort_tpu_torch.crop_resize(frames, boxes, 24, 16,
                                                  mode)
    assert torch.equal(got, want)
    assert torch.equal(tcrop.crop_resize(frames, boxes, (24, 16), mode),
                       want)
    torch.library.opcheck(tcrop.crop_resize_op,
                          (frames, boxes, 24, 16, mode))


def test_crop_refuses_what_it_cannot_compute():
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    boxes = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="uint8"):
        tcrop.crop_resize_plain(frames.float(), boxes, (4, 4), "int8")
    with pytest.raises(ValueError, match="mode"):
        tcrop.crop_resize_plain(frames, boxes, (4, 4), "float16")
    with pytest.raises(ValueError, match="CUDA"):
        tcrop.crop_resize_cuda(frames, boxes, (4, 4), "int8")
    with pytest.raises(ValueError, match="compute_dtype"):
        tcrop.crop_mode(dataclasses.replace(T_DEFAULT,
                                            compute_dtype="float16"),
                        torch.uint8)


@contextlib.contextmanager
def _captured_crops():
    """Record every crop both steps make, by output size: the JAX ones
    from inside the jitted step (``jax.debug.callback`` on ``_crop``'s
    result; the jit cache is cleared around it), the port's as returned.
    Yields (jax, port) dicts of lists of numpy arrays."""
    seen = {"jax": {}, "port": {}}
    real_j, real_t = jfs._crop, tfs._crop

    def keep(side, hw, x):
        seen[side].setdefault(hw, []).append(np.array(x))

    def j_crop(image, tlbr, out_hw, pdt, pipe_cfg):
        out = real_j(image, tlbr, out_hw, pdt, pipe_cfg)
        jax.debug.callback(functools.partial(keep, "jax", tuple(out_hw)),
                           out)
        return out

    def t_crop(frames, tlbr, out_hw, pipe_cfg):
        out = real_t(frames, tlbr, out_hw, pipe_cfg)
        keep("port", tuple(out_hw), out.numpy())
        return out

    jax.clear_caches()
    jfs._crop, tfs._crop = j_crop, t_crop
    try:
        yield seen["jax"], seen["port"]
    finally:
        jfs._crop, tfs._crop = real_j, real_t
        jax.clear_caches()


def _same_crops(jax_seen, port_seen, what):
    """Every output size's crops equal bit for bit, as multisets: the JAX
    step crops one frame at a time (vmapped, its callbacks in no promised
    order), the port all frames at once."""
    assert set(jax_seen) == set(port_seen) == {
        DEFAULT.detector_input_hw, DEFAULT.body_reid_input_hw,
        DEFAULT.face_reid_input_hw}, what

    def crops(seen, hw):
        flat = np.concatenate([x.reshape((-1,) + hw + (3,))
                               for x in seen[hw]])
        return flat[np.argsort([c.tobytes() for c in flat], kind="stable")]

    assert crops(port_seen, DEFAULT.detector_input_hw).any(), what
    for hw in port_seen:
        want, got = crops(jax_seen, hw), crops(port_seen, hw)
        assert got.shape == want.shape, (what, hw)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {hw}")


def _same_result(t_res, j_res, what):
    for name in ("det_valid", "head_for_body", "face_for_head",
                 "hand1_for_body", "hand2_for_body", "nms_clipped"):
        _eq(getattr(t_res, name), getattr(j_res, name), f"{what} {name}")
    for k in ("valid", "track_id", "det_index"):
        _eq(getattr(t_res.tracks, k), getattr(j_res.tracks, k),
            f"{what} {k}")
    _close(t_res.tracks.tlbr, j_res.tracks.tlbr, 1e-3, f"{what} tlbr")


def test_frame_step_at_the_jax_default_matches_jax(bundles):
    jb, tb = bundles
    d = jfs._det_width(TRK, NMSC)
    jst, tst = jstate.empty_store(TRK), tstate.empty_store(T_TRK)
    with jax_tpu_cascade(), _captured_crops() as (j_seen, t_seen):
        for t, frame in enumerate(_frames(3, seed=5)):
            jst, j_res = jfs.frame_step(jb, jst, jnp.asarray(frame), TRK,
                                        NMSC, DEFAULT, None, d, d)
            jax.effects_barrier()
            tst, t_res = tfs.frame_step(tb, tst, torch.from_numpy(frame),
                                        T_TRK, T_NMSC, T_DEFAULT, None, d, d)
            _same_crops(j_seen, t_seen, f"frame {t}")
            _same_result(t_res, j_res, f"frame {t}")
    assert int(tst.next_id) > 0


def test_frame_step_batched_at_the_jax_default_matches_jax(bundles):
    jb, tb = bundles
    b, d = 2, jfs._det_width(TRK, NMSC)
    jst = jax.tree.map(lambda x: jnp.stack([x] * b), jstate.empty_store(TRK))
    tst = tstate.empty_stores(T_TRK, b)
    with jax_tpu_cascade(), _captured_crops() as (j_seen, t_seen):
        for t, frames in enumerate(_stream_frames(2, b, seed=6)):
            jst, j_res = jfs.frame_step_batched(
                jb, jst, jnp.asarray(frames), TRK, NMSC, DEFAULT, None, d, d)
            jax.effects_barrier()
            tst, t_res = tfs.frame_step_batched(
                tb, tst, torch.from_numpy(frames), T_TRK, T_NMSC, T_DEFAULT,
                None, d, d)
            _same_crops(j_seen, t_seen, f"step {t}")
            _same_result(t_res, j_res, f"step {t}")
    assert int(tst.next_id.min()) > 0


def test_temporal_step_at_the_jax_default_matches_jax(bundles):
    """Stage by stage, as tests/test_torch_temporal.py does at float32:
    the perception of the B*T frames (every crop bit-equal, the rest at
    that test's tolerances), then the port's T chained cascades on JAX's
    perception against JAX's temporal step (a near-tie in a detector score
    cannot cascade into the tracks)."""
    jb, tb = bundles
    b, d = 2, jfs._det_width(TRK, NMSC)
    jst = jax.tree.map(lambda x: jnp.stack([x] * b), jstate.empty_store(TRK))
    tst = tstate.empty_stores(T_TRK, b)
    with _captured_crops() as (j_seen, t_seen):
        perceive = jax.jit(lambda f: jfs._perception_batched(
            jb, f, TRK, NMSC, DEFAULT, d, d))
        groups = _groups(2, seed=20, b=b)
        perceived = []
        for frames in groups:
            flat = frames.reshape((-1,) + frames.shape[2:])
            perceived.append(perceive(jnp.asarray(flat)))
            jax.effects_barrier()
            with torch.no_grad():
                perceived.append(tfs._perception_batched(
                    tb, torch.from_numpy(flat), T_TRK, T_NMSC, T_DEFAULT, d,
                    d))
    _same_crops(j_seen, t_seen, "temporal")
    for g, frames in enumerate(groups):
        t = frames.shape[1]
        (j_boxes, j_scores, j_valid, j_hier, j_clip, j_bt, j_bs, j_bv, j_bf,
         j_ff), p = perceived[2 * g:2 * g + 2]
        _eq(p.det_valid, j_valid, f"group {g} det_valid")
        _eq(p.dets.clipped, j_clip, f"group {g} clipped")
        _close(p.det_boxes, j_boxes, 1e-4, f"group {g} det boxes")
        _close(p.dets.scores, j_scores, 1e-4, f"group {g} scores")
        for name, got, want in zip(
                ("head_for_body", "face_for_head", "hand1", "hand2"),
                (p.head_for_body, p.face_for_head, p.hand1_for_body,
                 p.hand2_for_body), j_hier):
            _eq(got, want, f"group {g} {name}")
        _close(p.body_feats, j_bf, 1e-4, f"group {g} body features", 1e-4)
        _close(p.face_feats, j_ff, 1e-4, f"group {g} face features", 1e-4)
        with jax_tpu_cascade():
            jst, j_res = jfs.frame_step_batched_temporal(
                jb, jst, jnp.asarray(frames), TRK, NMSC, DEFAULT, None, d, d)
        fold = lambda x: torch.from_numpy(np.array(x)).reshape(  # noqa
            (b, t) + tuple(x.shape[1:]))
        for tt in range(t):
            tst, t_tr = tcascade.tracker_update_batched(
                tst, *[fold(x)[:, tt] for x in (j_bt, j_bs, j_bv, j_bf,
                                                j_ff)], T_TRK)
            for k in ("valid", "track_id", "det_index", "dropped_new"):
                _eq(getattr(t_tr, k), np.asarray(getattr(j_res.tracks,
                                                         k))[:, tt],
                    f"group {g} frame {tt} {k}")
            _close(t_tr.tlbr, np.asarray(j_res.tracks.tlbr)[:, tt], 1e-4,
                   f"group {g} frame {tt} track boxes")
    assert int(tst.next_id.min()) > 0
