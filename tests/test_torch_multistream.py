"""The port's multi-stream path against the JAX package's.

B streams through one step: the batched cascade solve (kernel K2's plain
version), ``tracker_update_batched``, batched crops, NMS and hierarchy,
``frame_step_batched`` stage by stage, ``BatchedBoTSORTPipeline`` and the
multitrack CLI, each against its JAX counterpart on the same seeded numpy
inputs and weights (MINI architectures, float32).

Tolerances: assignment matchings, ids, states, det indices, NMS and
hierarchy integers exact; boxes, means and covariances atol 1e-4 and
features rtol/atol 1e-4 (float32 sums in two libraries' orders, as in
tests/test_torch_pipeline.py); batched against per-frame calls of the
port itself bitwise.
"""

import dataclasses
import os
import subprocess
import sys
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.models.fastreid import preprocess as jpreprocess
from botsort_tpu.ops import assignment as jassign
from botsort_tpu.ops import assignment_pallas as jpallas
from botsort_tpu.ops import crop as jcrop
from botsort_tpu.ops import hierarchy as jhier
from botsort_tpu.ops import nms as jnms
from botsort_tpu.pipeline import frame_step as jfs
from botsort_tpu.pipeline.host import BatchedBoTSORTPipeline as JBatched
from botsort_tpu.pipeline.host import BoTSORTPipeline as JPipeline
from botsort_tpu.track import cascade as jcascade
from botsort_tpu.track import state as jstate
from botsort_tpu_torch.ops import assignment as tassign
from botsort_tpu_torch.ops import assignment_cuda
from botsort_tpu_torch.ops import crop as tcrop
from botsort_tpu_torch.ops import nms as tnms
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.track import cascade as tcascade
from botsort_tpu_torch.track import state as tstate
from tests.test_torch_cascade import (FLOAT_FIELDS, INT_FIELDS, _cfgs,
                                      _pack, _scene, jax_tpu_cascade)
from tests.test_torch_jv import _chip_smoke
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    LIVE,
    NMSC,
    PIPE,
    REGIMES,
    REPO,
    SRC_HW,
    SWITCH_PIPE,
    T_NMSC,
    T_PIPE,
    T_TRK,
    TRK,
    WIDTH,
    _close,
    _eq,
    _frames,
    _port,
    _t,
    assert_perception_equals_jax,
    assert_step_equals_jax,
    bundles,
    count_bundles,
    level_frames,
)

LIMITS = (0.8, 0.5, 0.7)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: tier-1 runs several workers on
    a few cores, and a thread pool per worker makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _stream_frames(n, streams, seed=0):
    """[n steps] of [streams, H, W, 3] frames; each stream its own
    seeded scene."""
    per = [_frames(n, seed=seed + 10 * s) for s in range(streams)]
    return [np.stack([per[s][t] for s in range(streams)]) for t in range(n)]


# --- the batched cascade solve (K2's plain version) ---------------------


def _cascade_instance(rng, n, d, empty_cols=False, quantum=None):
    """The generator of tests/test_cascade_solve.py, as numpy arrays."""
    costs = [rng.uniform(0, 1, (n, d)).astype(np.float32) for _ in range(3)]
    if quantum:
        costs = [(np.round(c / quantum) * quantum).astype(np.float32)
                 for c in costs]
    pool = rng.uniform(0, 1, n) < 0.6
    tracked = pool & (rng.uniform(0, 1, n) < 0.7)
    unconf = (~pool) & (rng.uniform(0, 1, n) < 0.4)
    high = rng.uniform(0, 1, d) < 0.6
    low = (~high) & (rng.uniform(0, 1, d) < 0.5)
    if empty_cols:
        high[:] = low[:] = False
    return (*costs, pool, tracked, unconf, high, low)


def _stack(insts):
    return [np.stack(x) for x in zip(*insts)]


def test_prepare_cascade_batched_equals_per_stream():
    rng = np.random.default_rng(1)
    insts = [_cascade_instance(rng, 10, 7) for _ in range(3)]
    insts.append(_cascade_instance(rng, 10, 7, empty_cols=True))
    insts[1][0][2, 3] = np.nan
    got = tassign.prepare_cascade(
        *[torch.from_numpy(a) for a in _stack(insts)], LIMITS)
    for s, inst in enumerate(insts):
        want = tassign.prepare_cascade(
            *[torch.from_numpy(a) for a in inst], LIMITS)
        for g, w in zip(got, want):
            assert torch.equal(g[s], w)


def _lockstep_inputs(insts, n, d, sp=128):
    """tests/test_cascade_solve.py::test_lockstep_matches_grid_kernel's
    prep of the JAX lockstep kernel's inputs."""
    def prep(inst):
        d1, iou, d3, pool, tracked, unconf, high, low = map(jnp.asarray,
                                                            inst)

        def padded(c):
            return jnp.pad(c, ((0, sp - n), (0, sp - d)))

        costs = jnp.stack([padded(d1), padded(iou), padded(d3)])
        f1 = pool[:, None] & high[None, :] & (d1 <= LIMITS[0])
        f2 = tracked[:, None] & low[None, :] & (iou <= LIMITS[1])
        f3 = unconf[:, None] & high[None, :] & (d3 <= LIMITS[2])

        def lane(m, width):
            return jnp.pad(m.astype(jnp.int32), (0, sp - width))[None, :]

        big = (jnp.max(jnp.abs(costs[:, :n, :d])) + 1.8)[None]
        return (costs, lane(pool & f1.any(1), n),
                lane(tracked & f2.any(1), n), lane(unconf & f3.any(1), n),
                lane(high & f1.any(0), d), lane(high & f3.any(0), d),
                lane(low & f2.any(0), d), big)

    return [jnp.stack(x) for x in zip(*[prep(i) for i in insts])]


def _assert_equals_lockstep(got, insts, n, d):
    """The port's B-stream results against the TPU lockstep kernel's in
    interpret mode (one ``big``, the maximum over streams)."""
    p, q, plive = jpallas._cascade_call_lockstep(
        *_lockstep_inputs(insts, n, d), n, d, LIMITS, 4096, True)
    for k in range(3):
        qq = np.asarray(q[:, k, 0, :n])
        cfr = np.where((qq >= 0) & (qq < d), qq, -1)
        rfc = np.where(np.asarray(plive[:, k, 0, :d]) > 0,
                       np.asarray(p[:, k, 0, :d]), -1)
        np.testing.assert_array_equal(got[k].col_for_row.numpy(), cfr,
                                      err_msg=f"pass {k + 1} cfr")
        np.testing.assert_array_equal(got[k].row_for_col.numpy(), rfc,
                                      err_msg=f"pass {k + 1} rfc")


def test_batched_cascade_equals_jax_lockstep_kernel():
    """The port's B-stream cascade (plain, per-stream ``big``) against the
    TPU lockstep kernel K2 in interpret mode (one ``big``, the maximum
    over streams), at N=10, D=7, B=4 with one stream without columns,
    continuous costs (ties: the test below)."""
    n, d = 10, 7
    rng = np.random.default_rng(21)
    insts = [_cascade_instance(rng, n, d) for _ in range(3)]
    insts.append(_cascade_instance(rng, n, d, empty_cols=True))
    # The dispatcher reaches the kernel's wrapper only for CUDA tensors.
    with mock.patch.object(assignment_cuda, "cascade_solve_cuda",
                           side_effect=AssertionError("K2 reached")):
        got = tassign.solve_cascade_masked(
            *[torch.from_numpy(a) for a in _stack(insts)], LIMITS)
    _assert_equals_lockstep(got, insts, n, d)
    assert (got[0].row_for_col[3] == -1).all()


def _tie_batches():
    """B = 4 tie-heavy batches at 12 x 9: chip_smoke.py's half-exact
    instances (entries exactly at L/2) and 0.1-grid ones."""
    cs = _chip_smoke()
    half = [inst for label, inst in cs.tie_instances()
            if label.startswith("half") and inst[0].shape == (12, 9)]
    rng = np.random.default_rng(31)
    return [half[:4], half[4:8],
            [cs.grid_instance(rng, 12, 9) for _ in range(4)]]


def test_batched_cascade_equals_jax_lockstep_kernel_at_ties():
    """At exact ties the port's B-stream cascade still equals the TPU
    lockstep kernel bit for bit: its per-stream steps and tie-breaks are
    the grid kernel's, and the lockstep kernel's shared ``big`` changes
    nothing."""
    for insts in _tie_batches():
        got = tassign.solve_cascade_masked(
            *[torch.from_numpy(a) for a in _stack(insts)], LIMITS)
        _assert_equals_lockstep(got, insts, 12, 9)


def test_per_stream_big_equals_shared_big_at_ties():
    """``big`` only fills the parked entries of the Dijkstra rows: the
    plain cascade with each stream's own ``big`` (K2's semantics) equals it
    with the lockstep kernel's maximum over streams and with four times
    that, on tie-heavy batches at 12 x 9 and at the main path's 64 x 50.
    Half of each batch's streams have their costs halved (still on a
    grid), so the streams' own ``big`` differ."""
    cs = _chip_smoke()
    half = [inst for label, inst in cs.tie_instances()
            if label.startswith("half") and inst[0].shape == (64, 50)]
    for insts in _tie_batches() + [half]:
        insts = [tuple(a * np.float32(0.5) if k < 3 and s % 2 else a
                       for k, a in enumerate(inst))
                 for s, inst in enumerate(insts)]
        costs, masks, big = tassign.prepare_cascade(
            *[torch.from_numpy(a) for a in _stack(insts)], LIMITS)
        assert big.unique().numel() == 2
        own = tassign.cascade_solve_plain(costs, masks, big, LIMITS)
        for shared in (big.max(), 4 * big.max()):
            other = tassign.cascade_solve_plain(
                costs, masks, shared.expand(big.shape), LIMITS)
            for a, b in zip(own, other):
                assert torch.equal(a, b)


def _three_solves(d1, iou, d3, pool, tracked, unconf, high, low):
    res1 = jassign.solve_masked(d1, pool, high, LIMITS[0])
    res2 = jassign.solve_masked(iou, tracked & (res1.col_for_row < 0), low,
                                LIMITS[1])
    res3 = jassign.solve_masked(d3, unconf, high & (res1.row_for_col < 0),
                                LIMITS[2])
    return res1, res2, res3


def test_batched_cascade_ties_equal_jax_composition():
    """Tie-heavy costs (a 0.05 grid) against the JAX package's vmapped
    three-``solve_masked`` composition, stream by stream."""
    rng = np.random.default_rng(13)
    insts = [_cascade_instance(rng, 12, 9, quantum=0.05) for _ in range(3)]
    batched = _stack(insts)
    got = tassign.solve_cascade_masked(
        *[torch.from_numpy(a) for a in batched], LIMITS)
    want = jax.vmap(_three_solves)(*[jnp.asarray(a) for a in batched])
    for k in range(3):
        np.testing.assert_array_equal(got[k].col_for_row.numpy(),
                                      np.asarray(want[k].col_for_row))
        np.testing.assert_array_equal(got[k].row_for_col.numpy(),
                                      np.asarray(want[k].row_for_col))


# --- tracker_update over streams ----------------------------------------


def _affine(rng):
    th, sc = rng.normal(0, 0.01), 1 + rng.normal(0, 0.01)
    return np.array([[sc * np.cos(th), -sc * np.sin(th), rng.normal(0, 3)],
                     [sc * np.sin(th), sc * np.cos(th), rng.normal(0, 3)]],
                    np.float32)


@pytest.mark.parametrize("gmc", [False, True], ids=["plain", "gmc"])
def test_tracker_update_batched_matches_jax_vmap(gmc):
    """Three streams of the scenario family of tests/test_torch_cascade.py
    through ``tracker_update_batched`` and ``jax.vmap(tracker_update)``;
    and each stream through the port's one-stream ``tracker_update``."""
    jcfg, tcfg = _cfgs(2)
    b = 3
    scenes = [_scene(seed, frames=8) for seed in (5, 6, 7)]
    jst = jax.tree.map(lambda x: jnp.stack([x] * b),
                       jstate.empty_store(jcfg))
    tst = tstate.empty_stores(tcfg, b)
    singles = [tstate.empty_store(tcfg) for _ in range(b)]
    rng = np.random.default_rng(8)
    if gmc:
        jstep = jax.jit(jax.vmap(lambda s, *a: jcascade.tracker_update(
            s, *a[:5], jcfg, a[5])))
    else:
        jstep = jax.jit(jax.vmap(lambda s, *a: jcascade.tracker_update(
            s, *a, jcfg)))
    for t in range(8):
        args = _stack([_pack(scenes[s][t]) for s in range(b)])
        aff = np.stack([_affine(rng) for _ in range(b)]) if gmc else None
        jst, jout = jstep(jst, *[jnp.asarray(a) for a in args],
                          *([] if aff is None else [jnp.asarray(aff)]))
        tst, tout = tcascade.tracker_update_batched(
            tst, *[torch.from_numpy(a) for a in args], tcfg,
            None if aff is None else torch.from_numpy(aff))
        for k in ("track_id", "valid", "det_index", "dropped_new"):
            _eq(getattr(tout, k), getattr(jout, k), f"frame {t} {k}")
        _close(tout.tlbr, jout.tlbr, 1e-4, f"frame {t} tlbr")
        for k in INT_FIELDS + ("hist_pos",):
            _eq(getattr(tst, k), getattr(jst, k), f"frame {t} store.{k}")
        for k in FLOAT_FIELDS + ("body_hist", "face_hist"):
            _close(getattr(tst, k), getattr(jst, k), 1e-4,
                   f"frame {t} store.{k}")
        for s in range(b):
            singles[s], sout = tcascade.tracker_update(
                singles[s], *[torch.from_numpy(a[s]) for a in args], tcfg,
                None if aff is None else torch.from_numpy(aff[s]))
            for k, g in zip(sout._fields, sout):
                assert torch.equal(g, getattr(tout, k)[s]), (t, s, k)
    for s in range(b):
        view = tst.map(lambda x: x[s])
        for name in tstate.TrackStore.__dataclass_fields__:
            assert torch.equal(getattr(view, name),
                               getattr(singles[s], name)), name
    assert (tst.next_id > 3).all()


# --- batched perception ops against per-frame calls ---------------------


def test_crop_batched_equals_per_frame():
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.integers(0, 255, (3, 60, 80, 3),
                                           dtype=np.uint8))
    tl = rng.uniform(-10, 70, (3, 5, 2))
    boxes = np.concatenate([tl, tl + rng.uniform(0, 30, (3, 5, 2))], -1)
    boxes[1, 2] = [5, 5, 5.5, 30]  # degenerate: zeros
    boxes = torch.from_numpy(boxes.astype(np.float32))
    got = tcrop.crop_and_resize_batched(images, boxes, (16, 8))
    assert got.shape == (3, 5, 16, 8, 3)
    for s in range(3):
        assert torch.equal(got[s], tcrop.crop_and_resize(images[s], boxes[s],
                                                         (16, 8)))
    assert (got[1, 2] == 0).all()


def test_nms_batched_equals_per_frame():
    rng = np.random.default_rng(3)
    tl = rng.uniform(0, 100, (3, 40, 2))
    boxes = np.concatenate([tl, tl + rng.uniform(5, 40, (3, 40, 2))], -1)
    scores = rng.uniform(0, 1, (3, 40, 4))
    scores[2] = 0.0  # a frame with no candidates
    boxes, scores = (torch.from_numpy(a.astype(np.float32))
                     for a in (boxes, scores))
    got = tnms.multiclass_nms_dense_batched(boxes, scores, 0.5, 0.2, 6, 16)
    for s in range(3):
        want = tnms.multiclass_nms_dense(boxes[s], scores[s], 0.5, 0.2, 6,
                                         16)
        for name, g, w in zip(want._fields, got, want):
            assert torch.equal(g[s], w), (s, name)
    assert not got.valid[2].any() and got.clipped[0].any()


# --- frame_step_batched, stage by stage ---------------------------------


def _jax_batched_stages(jb, b):
    """The JAX package's frame_step_batched stages as jitted functions
    (the pieces of pipeline/frame_step.py::_perception_batched)."""
    d = jfs._det_width(TRK, NMSC)
    r = PIPE.max_reid_batch
    dp = -(-d // r) * r
    full = jnp.asarray([[0.0, 0.0, SRC_HW[1], SRC_HW[0]]], jnp.float32)

    @jax.jit
    def resize(frames):
        return jax.vmap(lambda f: jcrop.crop_and_resize(
            f, full, PIPE.detector_input_hw)[0])(frames)

    @jax.jit
    def detect(det_in):
        return jb.detector.apply(jb.detector_params, det_in)

    @jax.jit
    def postprocess(cb, cs):
        def one(cb, cs):
            dets = jnms.multiclass_nms_dense(
                cb, cs, NMSC.iou_threshold, NMSC.score_threshold,
                NMSC.max_boxes_per_class, NMSC.pre_nms_top_k)
            boxes = jfs._rescale_to_source(
                dets.boxes, PIPE.detector_input_hw, SRC_HW)
            return (boxes, dets.scores,
                    dets.valid & (dets.scores > TRK.det_score_threshold),
                    dets.clipped)
        return jax.vmap(one)(cb, cs)

    @jax.jit
    def hier(boxes, valid):
        problems = []
        for s in range(b):
            problems += [
                (boxes[s, 1], valid[s, 1], boxes[s, 3], valid[s, 3], 1),
                (boxes[s, 0], valid[s, 0], boxes[s, 1], valid[s, 1], 1),
                (boxes[s, 0], valid[s, 0], boxes[s, 2], valid[s, 2], 2)]
        res = jhier.greedy_assign_batch(problems)
        return tuple(jnp.stack(x) for x in (
            [res[3 * s][0] for s in range(b)],
            [res[3 * s + 1][0] for s in range(b)],
            [res[3 * s + 2][0] for s in range(b)],
            [res[3 * s + 2][1] for s in range(b)]))

    @jax.jit
    def embed(frames, boxes, face_for_head, head_for_body, bucket_arr):
        bucket = bucket_arr.shape[0]

        def crops_of(tlbr, hw):
            return jax.vmap(lambda f, t: jcrop.crop_and_resize(f, t, hw))(
                frames, tlbr)

        def body(tlbr):
            rc = tlbr.shape[1]
            c = crops_of(tlbr, PIPE.body_reid_input_hw)
            return jb.body_encoder.apply(
                jb.body_params, jpreprocess(c.reshape((b * rc,)
                                                      + c.shape[2:]))
            ).reshape(b, rc, -1)

        def face(tlbr):
            rc = tlbr.shape[1]
            c = crops_of(tlbr, PIPE.face_reid_input_hw)
            return jb.face_encoder.apply(
                jb.face_params, c.reshape((b * rc,) + c.shape[2:])
            ).reshape(b, rc, -1)

        body_tlbr = jfs._pad_slots(boxes[:, 0], dp, axis=1)
        n_live = jnp.int32(d)
        bf = jfs._encode_chunked_axis1(body, body_tlbr, n_live, r,
                                       TRK.body_feature_dim, bucket)[:, :d]
        hb = jfs._pad_slots(head_for_body, dp, axis=1, fill=-1)
        fb = jnp.where(hb >= 0, jnp.take_along_axis(
            face_for_head, jnp.clip(hb, 0, None), axis=1), -1)
        face_tlbr = jnp.where(
            (fb >= 0)[..., None],
            jnp.take_along_axis(boxes[:, 3], jnp.clip(fb, 0, None)[..., None],
                                axis=1), 0.0)
        ff = jfs._encode_faces_axis1(face, face_tlbr, fb >= 0, n_live, r,
                                     TRK.face_feature_dim, bucket)[:, :d]
        return bf, ff

    track = jax.jit(jax.vmap(lambda s, *a: jcascade.tracker_update(
        s, *a, TRK)))
    return resize, detect, postprocess, hier, embed, track


def test_frame_step_batched_stage_by_stage(bundles):
    """Each stage of the port's frame_step_batched fed the JAX stage's
    inputs, two streams over three steps; the JAX stages chained are
    JAX's frame_step_batched itself."""
    jb, tb = bundles
    b = 2
    resize, detect, postprocess, hier, embed, track = \
        _jax_batched_stages(jb, b)
    d = jfs._det_width(TRK, NMSC)
    buckets = jfs.reid_bucket_set(TRK, NMSC, PIPE)
    jst = jax.tree.map(lambda x: jnp.stack([x] * b),
                       jstate.empty_store(TRK))
    jst_full = jst
    tst = tstate.empty_stores(T_TRK, b)
    for t, frames in enumerate(_stream_frames(3, b)):
        jframes, tframes = jnp.asarray(frames), torch.from_numpy(frames)
        full = torch.tensor([0.0, 0.0, SRC_HW[1], SRC_HW[0]]).expand(b, 1, 4)
        j_in = resize(jframes)
        t_in = tcrop.crop_and_resize_batched(tframes, full,
                                             PIPE.detector_input_hw)[:, 0]
        _close(t_in, j_in, 1e-3, f"step {t} resize")
        j_cb, j_cs = detect(j_in)
        with torch.no_grad():
            t_cb, t_cs = tb.detector(_t(j_in))
        _close(t_cb, j_cb, 2e-3, f"step {t} candidate boxes", 1e-4)
        _close(t_cs, j_cs, 1e-4, f"step {t} candidate scores", 1e-4)
        j_boxes, j_scores, j_valid, j_clip = postprocess(j_cb, j_cs)
        t_dets, t_boxes, t_valid = tfs.postprocess_detections_batched(
            _t(j_cb), _t(j_cs), SRC_HW, T_TRK, T_NMSC, T_PIPE)
        _eq(t_valid, j_valid, f"step {t} det_valid")
        _eq(t_dets.clipped, j_clip, f"step {t} clipped")
        _close(t_boxes, j_boxes, 1e-4, f"step {t} det boxes")
        _close(t_dets.scores, j_scores, 1e-4, f"step {t} scores")
        assert int(j_valid[:, 0].sum(1).min()) > 0
        j_hier = hier(j_boxes, j_valid)
        t_hier = tfs.attach_hierarchy_batched(_t(j_boxes), _t(j_valid))
        for name, g, w in zip(("face_for_head", "head_for_body", "hand1",
                               "hand2"), t_hier, j_hier):
            _eq(g, w, f"step {t} {name}")
        # Step 1 embeds at the smallest bucket that covers every stream.
        n_live = int(j_valid[:, 0, :d].sum(1).max())
        bucket = d if t != 1 else next(x for x in buckets if x >= n_live)
        j_bf, j_ff = embed(jframes, j_boxes, j_hier[0], j_hier[1],
                           jnp.zeros(bucket))
        with torch.no_grad():
            t_bf, t_ff = tfs.embed_batched(
                tb, tframes, _t(j_boxes), _t(j_hier[0]), _t(j_hier[1]),
                T_TRK, T_NMSC, T_PIPE, bucket, bucket)
        _close(t_bf, j_bf, 1e-4, f"step {t} body features", 1e-4)
        _close(t_ff, j_ff, 1e-4, f"step {t} face features", 1e-4)
        args = (j_boxes[:, 0, :d], j_scores[:, 0, :d], j_valid[:, 0, :d],
                j_bf, j_ff)
        jst, j_tr = track(jst, *args)
        tst, t_tr = tcascade.tracker_update_batched(
            tst, *[_t(a) for a in args], T_TRK)
        for k in ("valid", "track_id", "det_index", "dropped_new"):
            _eq(getattr(t_tr, k), getattr(j_tr, k), f"step {t} {k}")
        _close(t_tr.tlbr, j_tr.tlbr, 1e-4, f"step {t} track boxes")
        # The staging above is JAX's frame_step_batched.
        jst_full, j_res = jfs.frame_step_batched(
            jb, jst_full, jframes, TRK, NMSC, PIPE, None, bucket, bucket)
        for k in ("valid", "track_id", "det_index"):
            np.testing.assert_array_equal(np.asarray(getattr(j_res.tracks,
                                                             k)),
                                          np.asarray(getattr(j_tr, k)))
    assert int(tst.next_id.min()) > 0


def test_frame_step_batched_equals_its_one_stream_case(bundles):
    """frame_step is frame_step_batched at B = 1: a two-stream step gives
    each stream what one-stream steps give (float32 on the CPU)."""
    _, tb = bundles
    frames = _stream_frames(1, 2, seed=4)[0]
    stores, res = tfs.frame_step_batched(
        tb, tstate.empty_stores(T_TRK, 2), torch.from_numpy(frames),
        T_TRK, T_NMSC, T_PIPE)
    for s in range(2):
        _, one = tfs.frame_step(tb, tstate.empty_store(T_TRK),
                                torch.from_numpy(frames[s]), T_TRK, T_NMSC,
                                T_PIPE)
        got = thost.stream_result(res, s)
        for name in ("det_valid", "head_for_body", "face_for_head"):
            assert torch.equal(getattr(got, name), getattr(one, name))
        for k in ("valid", "track_id", "det_index"):
            assert torch.equal(getattr(got.tracks, k),
                               getattr(one.tracks, k))
        _close(got.tracks.tlbr, one.tracks.tlbr.numpy(), 1e-4,
               f"stream {s} tlbr")


# --- BatchedBoTSORTPipeline ---------------------------------------------


def _ids(tracks):
    return [[x.track_id for x in stream] for stream in tracks]


def test_batched_pipeline_matches_jax(bundles):
    """Against the JAX batched pipeline with its cascade on the TPU
    lockstep kernel (interpret mode), whose tie-breaks the port follows."""
    jb, tb = bundles
    jp = JBatched(jb, 2, TRK, NMSC, PIPE)
    tp = thost.BatchedBoTSORTPipeline(tb, 2, T_TRK, T_NMSC, T_PIPE)
    live = 0
    with jax_tpu_cascade():
        for t, frames in enumerate(_stream_frames(4, 2, seed=1)):
            j_tracks, t_tracks = jp.update(frames), tp.update(frames)
            assert _ids(t_tracks) == _ids(j_tracks), f"step {t}"
            for ts, js in zip(t_tracks, j_tracks):
                for a, b in zip(ts, js):
                    np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0,
                                               atol=1e-3)
                    assert (a.body is None) == (b.body is None)
                    if a.body is not None:
                        assert (a.body.x1, a.body.y2) == (b.body.x1,
                                                          b.body.y2)
                        assert (a.body.head is None) == \
                            (b.body.head is None)
                live += len(ts)
    assert live > 0
    assert set(tp.timers.report()) == {"upload", "device_step", "readback",
                                       "assemble"}


def test_batched_pipeline_overflow_rerun_and_async(bundles):
    """A bucket picked too small re-runs the step from the pre-step
    stores and equals a run at the full bucket; update_async(...).result()
    equals update()."""
    _, tb = bundles
    frames = _stream_frames(3, 2, seed=2)
    full = thost.BatchedBoTSORTPipeline(tb, 2, T_TRK, T_NMSC, T_PIPE)
    small = thost.BatchedBoTSORTPipeline(tb, 2, T_TRK, T_NMSC, T_PIPE)
    steps = []
    real_step = small._step
    small._step = lambda *a: steps.append(a[2:]) or real_step(*a)
    for t, f in enumerate(frames):
        want = full.update(f)
        if t:
            small._last_max_live, small._last_max_face = 0, 0  # bucket 0
        handle = small.update_async(f)
        got = handle.result()
        assert handle.result() is got
        assert _ids(got) == _ids(want)
        for gs, ws in zip(got, want):
            for a, b in zip(gs, ws):
                np.testing.assert_array_equal(a.tlbr, b.tlbr)
    assert steps[1][0] == 0 and steps[2][0] > 0  # step t=1 re-ran
    assert len(steps) == 5
    small.reset()
    assert small.frame_id == 0 and int(small.stores.next_id.sum()) == 0
    with pytest.raises(ValueError, match="expected 2 frames"):
        small.update(frames[0][:1])


@pytest.mark.parametrize("which", ["jax-single", "jax-batched",
                                   "port-single", "port-batched"])
def test_disable_reid_needs_bucket_dispatch(bundles, which):
    """IoU-only mode with every slot embedded would still run the
    encoders: the JAX facades refuse it, and so do the port's (the port's
    BoTSORTPipeline accepted it before and tracked with appearance)."""
    jb, tb = bundles
    bad = dataclasses.replace(PIPE, disable_reid=True,
                              host_bucket_dispatch=False)
    ok = dataclasses.replace(PIPE, disable_reid=True)
    make = {
        "jax-single": lambda p: JPipeline(jb, TRK, NMSC, p),
        "jax-batched": lambda p: JBatched(jb, 2, TRK, NMSC, p),
        "port-single": lambda p: thost.BoTSORTPipeline(tb, T_TRK, T_NMSC,
                                                       _port(p)),
        "port-batched": lambda p: thost.BatchedBoTSORTPipeline(
            tb, 2, T_TRK, T_NMSC, _port(p)),
    }[which]
    with pytest.raises(ValueError, match="disable_reid"):
        make(bad)
    make(ok)


def test_batched_pipeline_iou_only_matches_jax(bundles):
    jb, tb = bundles
    pipe = dataclasses.replace(PIPE, disable_reid=True)
    jp = JBatched(jb, 2, TRK, NMSC, pipe)
    tp = thost.BatchedBoTSORTPipeline(tb, 2, T_TRK, T_NMSC, _port(pipe))
    for frames in _stream_frames(2, 2, seed=3):
        assert _ids(tp.update(frames)) == _ids(jp.update(frames))


# --- the multitrack CLI -------------------------------------------------


def _write_video(path, frames):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             15, (160, 120))
    for img in frames:
        writer.write(np.ascontiguousarray(img[:120, :160]))
    writer.release()


def test_multitrack_cli_cpu_mini(tmp_path):
    vids = [tmp_path / "a.mp4", tmp_path / "b.mp4"]
    _write_video(vids[0], _frames(3, seed=5))
    _write_video(vids[1], _frames(2, seed=6))  # ends first, then coasts
    proc = subprocess.run(
        [sys.executable, "-m", "botsort_tpu_torch.cli.multitrack", "-v",
         *map(str, vids), "-ep", "cpu", "--mini", "--output_dir",
         str(tmp_path), "--profile"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "processed 3 steps x 2 streams" in proc.stdout
    for stem, n in (("a", 3), ("b", 2)):
        cap = cv2.VideoCapture(str(tmp_path / f"{stem}_tracked.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
        cap.release()


@pytest.mark.parametrize("flag", [["--chips", "two"], ["--artifact_dir", "x"]])
def test_multitrack_refuses_unported_modes(tmp_path, flag):
    """--chips (ported: tests/test_torch_parallel.py runs it) refuses what
    is neither a count nor auto before any model is built; --artifact_dir
    refuses a directory that holds no exported programs."""
    from botsort_tpu_torch.cli import multitrack

    vid = tmp_path / "a.mp4"
    vid.write_bytes(b"")
    if flag[0] == "--chips":
        err, match = SystemExit, "2"
    else:
        err, match = FileNotFoundError, "manifest.json"
    with pytest.raises(err, match=match):
        multitrack.main(["-v", str(vid), "-ep", "cpu", *flag])
    assert os.path.isfile(vid)


# The regime of a step is that of its busiest stream (the JAX package's
# n_live is the largest live count over the streams).
STREAM_LEVELS = {"none": ("none", "none"), "chunk": ("none", "chunk"),
                 "full": ("chunk", "full")}


@pytest.mark.parametrize("regime", list(STREAM_LEVELS))
def test_switch_batched_step_matches_jax(bundles, regime):
    """Two streams with no bucket: the switch follows the larger live count
    (0, 3, 7); perception and frame_step_batched against the JAX package's
    over two steps."""
    jcb, tcb = count_bundles(*bundles)
    frames = np.stack(level_frames(
        [REGIMES[r] for r in STREAM_LEVELS[regime]], seed=6))
    assert_perception_equals_jax(jcb, tcb, frames, regime, LIVE[regime],
                                 WIDTH[regime])
    jst = jax.tree.map(lambda x: jnp.stack([x] * 2),
                       jstate.empty_store(TRK))
    tst = tstate.empty_stores(T_TRK, 2)
    for t in range(2):
        jst, j_res = jfs.frame_step_batched(jcb, jst, jnp.asarray(frames),
                                            TRK, NMSC, SWITCH_PIPE)
        tst, t_res = tfs.frame_step_batched(
            tcb, tst, torch.from_numpy(frames), T_TRK, T_NMSC,
            _port(SWITCH_PIPE))
        assert_step_equals_jax(tst, t_res, jst, j_res, f"{regime} {t}")
    assert tfs.switch_values(thost.to_host(t_res), T_TRK, T_NMSC,
                             _port(SWITCH_PIPE))[0] == LIVE[regime]

