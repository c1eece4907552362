"""The port's tracker_update against the JAX package's over many frames.

A synthetic scene (objects that move, vanish and return, low-score
detections, spurious new ones) goes frame by frame through both
cascades from the same numpy inputs. Track ids, validity, det indices,
states and the id counter must be exact; boxes, means and covariances
within atol 1e-4 (float32 sums in two libraries' orders).
"""

import contextlib
import copy
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from botsort_tpu.config import TrackerConfig as JTrackerConfig
from botsort_tpu.ops import assignment as jassign
from botsort_tpu.ops.assignment_pallas import cascade_solve_pallas
from botsort_tpu.track import cascade as jcascade
from botsort_tpu.track import state as jstate
from botsort_tpu_torch.config import TrackerConfig as TTrackerConfig
from botsort_tpu_torch.track import cascade as tcascade
from botsort_tpu_torch.track import state as tstate

D = 16


def _cfgs(history):
    """The same tracker configuration for the JAX package and the port."""
    kw = dict(max_tracks=24, max_dets=D, body_feature_dim=32,
              face_feature_dim=16, track_buffer=6, feature_history=history)
    return JTrackerConfig(**kw), TTrackerConfig(**kw)


def _scene(seed, frames=14, n_obj=10):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(50, 500, (n_obj, 2))
    vel = rng.normal(0, 4, (n_obj, 2))
    size = rng.uniform(30, 90, (n_obj, 2))
    body = rng.normal(0, 1, (n_obj, 32))
    face = rng.normal(0, 1, (n_obj, 16))
    out = []
    for t in range(frames):
        pos = pos + vel
        visible = rng.uniform(0, 1, n_obj) < (0.5 if 5 <= t < 8 else 0.9)
        dets = []
        for k in np.flatnonzero(visible):
            tl = pos[k] + rng.normal(0, 1.5, 2)
            score = rng.uniform(0.05, 0.4) if rng.uniform() < 0.2 else \
                rng.uniform(0.5, 1.0)
            b = body[k] + rng.normal(0, 0.3, 32)
            f = face[k] + rng.normal(0, 0.3, 16)
            dets.append((np.r_[tl, tl + size[k]], score, b, f))
        if rng.uniform() < 0.4:  # a spurious detection
            tl = rng.uniform(0, 500, 2)
            dets.append((np.r_[tl, tl + 40], rng.uniform(0.3, 1.0),
                         rng.normal(0, 1, 32), rng.normal(0, 1, 16)))
        out.append(dets[:D])
    return out


def _pack(dets):
    tlbr = np.zeros((D, 4), np.float32)
    score = np.zeros((D,), np.float32)
    valid = np.zeros((D,), bool)
    bf = np.zeros((D, 32), np.float32)
    ff = np.zeros((D, 16), np.float32)
    for i, (box, s, b, f) in enumerate(dets):
        tlbr[i], score[i], valid[i] = box, s, True
        bf[i] = b / np.linalg.norm(b)
        ff[i] = f / np.linalg.norm(f)
    return tlbr, score, valid, bf, ff


INT_FIELDS = ("state", "is_activated", "track_id", "frame_id",
              "start_frame", "tracklet_len", "det_index", "next_id",
              "frame_count")
FLOAT_FIELDS = ("mean", "cov", "score", "body_smooth", "face_smooth")


def _compare_over_scene(scene, history):
    """Both cascades frame by frame over ``scene``; returns the port's
    final store and the JAX package's per-frame det indices."""
    jcfg, tcfg = _cfgs(history)
    jst = jstate.empty_store(jcfg)
    tst = tstate.empty_store(tcfg)
    hist_fields = ("body_hist", "face_hist") if history else ()
    det_index = []
    for t, dets in enumerate(scene):
        args = _pack(dets)
        jst, jout = jcascade.tracker_update(
            jst, *[jnp.asarray(a) for a in args], jcfg)
        tst, tout = tcascade.tracker_update(
            tst, *[torch.from_numpy(a) for a in args], tcfg)
        for k in ("track_id", "valid", "det_index", "dropped_new"):
            np.testing.assert_array_equal(
                getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                err_msg=f"frame {t} {k}")
        np.testing.assert_allclose(tout.tlbr.numpy(), np.asarray(jout.tlbr),
                                   rtol=0, atol=1e-4)
        for k in INT_FIELDS + (("hist_pos",) if history else ()):
            np.testing.assert_array_equal(
                getattr(tst, k).numpy(), np.asarray(getattr(jst, k)),
                err_msg=f"frame {t} store.{k}")
        for k in FLOAT_FIELDS + hist_fields:
            np.testing.assert_allclose(
                getattr(tst, k).numpy(), np.asarray(getattr(jst, k)),
                rtol=0, atol=1e-4, err_msg=f"frame {t} store.{k}")
        det_index.append(np.asarray(jst.det_index))
    return tst, det_index


@pytest.mark.parametrize("seed,history", [(0, 0), (1, 0), (2, 3)])
def test_tracker_update_matches_jax(seed, history):
    tst, _ = _compare_over_scene(_scene(seed), history)
    assert int(tst.next_id) > 5  # the scene created and kept tracks


def _tied_scene():
    """_scene with exact ties everywhere: boxes snapped to an 8-pixel grid,
    two appearance features shared by all the objects (as random-init
    encoders map every crop to nearly one direction), every detection
    twice (identical cost columns)."""
    rng = np.random.default_rng(101)
    feats = [(rng.normal(0, 1, 32), rng.normal(0, 1, 16)) for _ in range(2)]
    out = []
    for dets in _scene(1, frames=8, n_obj=7):
        tied = [(np.round(box / 8) * 8, score, *feats[k % 2])
                for k, (box, score, _, _) in enumerate(dets)]
        out.append([det for det in tied for _ in range(2)][:D])
    return out


def _tpu_kernel_cascade(dists1, iou_d, dists3, pool_m, tracked_m, unconf_m,
                        high_m, low_m, limits, max_iters=20000):
    """JAX ``solve_cascade_masked``'s TPU route, with the kernel in
    interpret mode."""
    f32 = jnp.float32
    out = cascade_solve_pallas(
        dists1.astype(f32), iou_d.astype(f32), dists3.astype(f32), pool_m,
        tracked_m, unconf_m, high_m, low_m,
        tuple(float(x) for x in limits), min(max_iters, 4096),
        interpret=True)
    return tuple(jassign.AssignmentResult(cfr, rfc) for cfr, rfc in out)


def _jax_det_index(scene):
    jcfg, _ = _cfgs(0)
    st = jstate.empty_store(jcfg)
    out = []
    for dets in scene:
        st, _ = jcascade.tracker_update(
            st, *[jnp.asarray(a) for a in _pack(dets)], jcfg)
        out.append(np.asarray(st.det_index))
    return out


@contextlib.contextmanager
def jax_tpu_cascade():
    """The JAX package's ``solve_cascade_masked`` routed to its TPU kernel in
    interpret mode, the reference the port's cascade follows at exact ties
    (its CPU route, three chained solves, may pick another optimum there).
    Every JAX jit cache is cleared on entry and on exit: ``tracker_update``
    and the frame steps are jitted, and a trace made with or without the
    patch would otherwise serve the callers on the other side of it."""
    jax.clear_caches()
    try:
        with mock.patch.object(jassign, "solve_cascade_masked",
                               _tpu_kernel_cascade):
            yield
    finally:
        jax.clear_caches()


def test_tracker_update_matches_tpu_kernel_at_duplicated_detections():
    """Duplicated detections on a box grid with shared features (exact
    ties) through both trackers, the JAX side's solver patched to the TPU
    kernel in interpret mode: the port follows the TPU kernel's
    tie-breaks. The JAX CPU route (three chained solves) picks other
    optima on this scene, so the tracks differ from its."""
    scene = _tied_scene()
    with jax_tpu_cascade():
        tst, kernel_det_index = _compare_over_scene(scene, 0)
    assert int(tst.next_id) > 5
    composition = _jax_det_index(scene)
    assert any(not np.array_equal(a, b)
               for a, b in zip(kernel_det_index, composition))


def test_tracker_update_leaves_its_input_store_untouched():
    _, cfg = _cfgs(2)
    store = tstate.empty_store(cfg)
    for dets in _scene(4, frames=3):
        before = copy.deepcopy(store)
        new, _ = tcascade.tracker_update(
            store, *[torch.from_numpy(a) for a in _pack(dets)], cfg)
        for name in before.__dataclass_fields__:
            a, b = getattr(before, name), getattr(store, name)
            assert torch.equal(a, b), name
        store = new


def test_empty_store_layout_matches_jax():
    jcfg, tcfg = _cfgs(4)
    j = jstate.empty_store(jcfg)
    t = tstate.empty_store(tcfg)
    for name in t.__dataclass_fields__:
        jv, tv = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert jv.shape == tv.shape and jv.dtype == tv.dtype, name
        np.testing.assert_array_equal(tv, jv)
