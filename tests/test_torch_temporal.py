"""The port's temporal path (T consecutive frames per stream per step)
against the JAX package's and against the port's own frame-at-a-time path.

MINI architectures in float32 with the JAX package's weights carried over
(runtime/from_flax.py), the same seeded frames through both. Tolerances
are those of tests/test_torch_multistream.py: NMS, hierarchy and tracker
integers exact; boxes atol 1e-4, features rtol/atol 1e-4 (float32 sums in
two libraries' orders). The port against itself is bitwise, with the
perception batch held equal on both sides: a convolution at batch B*T is
not promised to round like one at batch B, so the sequential reference
takes its per-frame perception from the same B*T batch.
"""

import dataclasses
import subprocess
import sys
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.pipeline import frame_step as jfs
from botsort_tpu.pipeline.host import (
    TemporalBatchedBoTSORTPipeline as JTemporal,
)
from botsort_tpu.track import state as jstate
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.track import cascade as tcascade
from botsort_tpu_torch.track import state as tstate
from tests.test_torch_cascade import jax_tpu_cascade
from tests.test_torch_multistream import _stream_frames, _write_video
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    LIVE,
    NMSC,
    PIPE,
    REGIMES,
    REPO,
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

B, T = 2, 2


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


def _groups(n, seed=0, b=B, t=T):
    """[n groups] of [b, t, H, W, 3] frames: each stream its own scene,
    consecutive frames of it in a group."""
    steps = _stream_frames(n * t, b, seed=seed)      # [n*t] of [b, ...]
    return [np.stack([np.stack([steps[g * t + tt][s] for tt in range(t)])
                      for s in range(b)]) for g in range(n)]


def _affines(rng, shape):
    """Small seeded camera motions [..., 2, 3]."""
    a = np.tile(np.eye(2, 3, dtype=np.float32), shape + (1, 1))
    a[..., :, 2] += rng.uniform(-6, 6, shape + (2,)).astype(np.float32)
    a[..., 0, 0] = a[..., 1, 1] = 1.0 + rng.uniform(
        -0.02, 0.02, shape).astype(np.float32)
    return a


def test_temporal_step_matches_jax_stage_by_stage(bundles):
    """Perception over the B*T frames, then the T chained cascades, each
    port stage against the JAX stage (the cascades fed JAX's perception, so
    that a near-tie cannot cascade); JAX's stages chained are its
    frame_step_batched_temporal."""
    jb, tb = bundles
    d = jfs._det_width(TRK, NMSC)
    perceive = jax.jit(lambda frames: jfs._perception_batched(
        jb, frames, TRK, NMSC, PIPE, d, d))
    jst = jax.tree.map(lambda x: jnp.stack([x] * B), jstate.empty_store(TRK))
    tst = tstate.empty_stores(T_TRK, B)
    rng = np.random.default_rng(21)
    for g, frames in enumerate(_groups(2, seed=20)):
        gmc = _affines(rng, (B, T))
        flat = frames.reshape((B * T,) + frames.shape[2:])
        (j_boxes, j_scores, j_valid, j_hier, j_clip, j_bt, j_bs, j_bv, j_bf,
         j_ff) = perceive(jnp.asarray(flat))
        with torch.no_grad():
            p = tfs._perception_batched(tb, torch.from_numpy(flat), T_TRK,
                                        T_NMSC, T_PIPE, d, d)
        _eq(p.det_valid, j_valid, f"group {g} det_valid")
        _eq(p.dets.clipped, j_clip, f"group {g} clipped")
        assert bool(p.dets.converged.all())
        _close(p.det_boxes, j_boxes, 1e-4, f"group {g} det boxes")
        _close(p.dets.scores, j_scores, 1e-4, f"group {g} scores")
        for name, got, want in zip(
                ("head_for_body", "face_for_head", "hand1", "hand2"),
                (p.head_for_body, p.face_for_head, p.hand1_for_body,
                 p.hand2_for_body), j_hier):
            _eq(got, want, f"group {g} {name}")
        _close(p.body_feats, j_bf, 1e-4, f"group {g} body features", 1e-4)
        _close(p.face_feats, j_ff, 1e-4, f"group {g} face features", 1e-4)
        assert int(j_bv.sum()) > 0

        jst, j_res = jfs.frame_step_batched_temporal(
            jb, jst, jnp.asarray(frames), TRK, NMSC, PIPE, jnp.asarray(gmc),
            d, d)
        # The port's cascades on JAX's perception, chained through T.
        fold = lambda x: _t(x).reshape((B, T) + tuple(x.shape[1:]))  # noqa
        for tt in range(T):
            tst, t_tr = tcascade.tracker_update_batched(
                tst, *[fold(x)[:, tt] for x in (j_bt, j_bs, j_bv, j_bf,
                                                j_ff)], T_TRK,
                torch.from_numpy(gmc[:, tt]))
            for k in ("valid", "track_id", "det_index", "dropped_new"):
                _eq(getattr(t_tr, k), np.asarray(getattr(j_res.tracks,
                                                         k))[:, tt],
                    f"group {g} frame {tt} {k}")
            _close(t_tr.tlbr, np.asarray(j_res.tracks.tlbr)[:, tt], 1e-4,
                   f"group {g} frame {tt} track boxes")
        _eq(tst.next_id, jst.next_id, f"group {g} next_id")
        _eq(tst.state, jst.state, f"group {g} state")
    assert int(tst.next_id.min()) > 0


def test_temporal_step_end_to_end_matches_jax(bundles):
    """The whole port step against the whole JAX step, its cascade on the
    TPU lockstep kernel (interpret mode), whose tie-breaks the port
    follows: ids and validity exact, boxes atol 1e-3 as in the pipeline
    tests."""
    jb, tb = bundles
    jst = jax.tree.map(lambda x: jnp.stack([x] * B), jstate.empty_store(TRK))
    tst = tstate.empty_stores(T_TRK, B)
    with jax_tpu_cascade():
        for g, frames in enumerate(_groups(2, seed=22)):
            jst, j_res = jfs.frame_step_batched_temporal(
                jb, jst, jnp.asarray(frames), TRK, NMSC, PIPE)
            tst, t_res = tfs.frame_step_batched_temporal(
                tb, tst, torch.from_numpy(frames), T_TRK, T_NMSC, T_PIPE)
            assert tuple(t_res.det_boxes.shape[:2]) == (B, T)
            assert tuple(t_res.nms_converged.shape) == (B, T)
            for name in ("det_valid", "head_for_body", "face_for_head",
                         "hand1_for_body", "hand2_for_body", "nms_clipped"):
                _eq(getattr(t_res, name), getattr(j_res, name),
                    f"{g} {name}")
            for k in ("valid", "track_id", "det_index"):
                _eq(getattr(t_res.tracks, k), getattr(j_res.tracks, k),
                    f"group {g} {k}")
            _close(t_res.tracks.tlbr, j_res.tracks.tlbr, 1e-3,
                   f"group {g} tlbr")
    assert int(tst.next_id.min()) > 0


def _sequential(tb, stores, frames, gmc, buckets):
    """T frame_step_batched calls, each frame's perception taken from the
    perception of all B*T frames (the temporal step's batch)."""
    b, t = frames.shape[:2]
    with torch.no_grad():
        whole = tfs._perception_batched(
            tb, frames.flatten(0, 1), T_TRK, T_NMSC, T_PIPE, *buckets)
    real = tfs._perception_batched
    outs = []
    for tt in range(t):
        def sliced(bundle, fr, *rest, tt=tt):
            assert torch.equal(fr, frames[:, tt])
            pick = lambda x: x.reshape((b, t) + tuple(x.shape[1:]))[:, tt]  # noqa
            return tfs.Perception(
                type(whole.dets)(*(pick(x) for x in whole.dets)),
                *(pick(x) for x in whole[1:]))
        with mock.patch.object(tfs, "_perception_batched", sliced):
            stores, res = tfs.frame_step_batched(
                tb, stores, frames[:, tt], T_TRK, T_NMSC, T_PIPE,
                None if gmc is None else gmc[:, tt], *buckets)
        outs.append(res)
    assert tfs._perception_batched is real
    return stores, outs


@pytest.mark.parametrize("with_gmc", [False, True], ids=["plain", "gmc"])
def test_temporal_step_equals_sequential_steps(bundles, with_gmc):
    """frame_step_batched_temporal against T chained frame_step_batched
    calls at equal buckets: every field and the final stores bit-equal."""
    _, tb = bundles
    rng = np.random.default_rng(23)
    st_t = st_s = tstate.empty_stores(T_TRK, B)
    for g, frames in enumerate(_groups(2, seed=24)):
        frames = torch.from_numpy(frames)
        gmc = torch.from_numpy(_affines(rng, (B, T))) if with_gmc else None
        buckets = (8, 8) if g == 0 else (4, 8)
        st_t, res = tfs.frame_step_batched_temporal(
            tb, st_t, frames, T_TRK, T_NMSC, T_PIPE, gmc, *buckets)
        st_s, outs = _sequential(tb, st_s, frames, gmc, buckets)
        for tt, want in enumerate(outs):
            for name, x, y in zip(res._fields[:-1], res[:-1], want[:-1]):
                assert torch.equal(x[:, tt], y), (g, tt, name)
            for name, x, y in zip(res.tracks._fields, res.tracks,
                                  want.tracks):
                assert torch.equal(x[:, tt], y), (g, tt, name)
        for x, y in zip(thost._store_tensors(st_t),
                        thost._store_tensors(st_s)):
            assert (x is None and y is None) or torch.equal(x, y)
    assert int(st_t.next_id.min()) > 0 and int(st_t.frame_count[0]) == 4


def test_frame_step_temporal_is_the_one_stream_case(bundles):
    _, tb = bundles
    frames = torch.from_numpy(np.stack(_frames(3, seed=25)))
    store, res = tfs.frame_step_temporal(tb, tstate.empty_store(T_TRK),
                                         frames, T_TRK, T_NMSC, T_PIPE)
    stores, want = tfs.frame_step_batched_temporal(
        tb, tstate.empty_stores(T_TRK, 1), frames[None], T_TRK, T_NMSC,
        T_PIPE)
    assert tuple(res.det_boxes.shape[:1]) == (3,)
    for x, y in zip(thost._result_tensors(res),
                    thost._result_tensors(want)):
        assert torch.equal(x, y[0])
    assert torch.equal(store.track_id, stores.track_id[0])
    assert int(store.frame_count) == 3


def _track_key(tracks):
    return [[(x.track_id, tuple(x.tlbr.tolist()),
              None if x.body is None else (x.body.x1, x.body.y2))
             for x in stream] for stream in tracks]


def test_temporal_facade_matches_manual_step(bundles):
    """TemporalBatchedBoTSORTPipeline assembles exactly what the manually
    driven step computes: the [B, T] fold, the time-major out[t][s], the
    stores chained from group to group; with the bucket dispatch on it
    tracks the same, through a forced overflow re-run."""
    _, tb = bundles
    pipe = dataclasses.replace(T_PIPE, host_bucket_dispatch=False)
    facade = thost.TemporalBatchedBoTSORTPipeline(tb, B, T, T_TRK, T_NMSC,
                                                  pipe)
    bucketed = thost.TemporalBatchedBoTSORTPipeline(tb, B, T, T_TRK, T_NMSC,
                                                    T_PIPE)
    runs = []
    real = bucketed._step
    bucketed._step = lambda *a: runs.append(a[2:4]) or real(*a)
    stores = tstate.empty_stores(T_TRK, B)
    live = 0
    for g, frames in enumerate(_groups(3, seed=26)):
        got = facade.update(frames)
        assert len(got) == T and len(got[0]) == B       # time-major
        stores, res = tfs.frame_step_batched_temporal(
            tb, stores, torch.from_numpy(frames), T_TRK, T_NMSC, pipe)
        host = thost.to_host(res)
        for tt in range(T):
            want = [thost.assemble_tracks(
                thost.stream_result(thost.stream_result(host, s), tt),
                T_TRK, T_NMSC, pipe) for s in range(B)]
            assert _track_key(got[tt]) == _track_key(want), (g, tt)
            live += sum(len(x) for x in want)
        if g == 1:
            bucketed._last_max_live, bucketed._last_max_face = 0, 0
        with_buckets = bucketed.update_async(frames).result()
        assert [_track_key(x) for x in with_buckets] == \
            [_track_key(x) for x in got], g
    assert live > 0
    assert (0, 0) in runs and len(runs) == 4            # group 1 re-ran
    for x, y in zip(thost._store_tensors(facade.stores),
                    thost._store_tensors(stores)):
        assert (x is None and y is None) or torch.equal(x, y)
    with pytest.raises(ValueError, match=r"expected \[B=2, T=2"):
        facade.update(_groups(1)[0][:, :1])
    with pytest.raises(ValueError, match="t_batch"):
        thost.TemporalBatchedBoTSORTPipeline(tb, B, 0, T_TRK, T_NMSC, pipe)
    facade.reset()
    assert facade.frame_id == 0 and int(facade.stores.next_id.sum()) == 0


def test_temporal_facade_matches_jax(bundles):
    jb, tb = bundles
    jp = JTemporal(jb, B, t_batch=T, tracker_cfg=TRK, nms_cfg=NMSC,
                   pipe_cfg=PIPE)
    tp = thost.TemporalBatchedBoTSORTPipeline(tb, B, T, T_TRK, T_NMSC,
                                              T_PIPE)
    live = 0
    for g, frames in enumerate(_groups(2, seed=27)):
        j_out, t_out = jp.update(frames), tp.update(frames)
        for tt in range(T):
            assert [[x.track_id for x in s] for s in t_out[tt]] == \
                [[x.track_id for x in s] for s in j_out[tt]], (g, tt)
            for ts, js in zip(t_out[tt], j_out[tt]):
                for a, b in zip(ts, js):
                    np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0,
                                               atol=1e-3)
                live += len(ts)
    assert live > 0


def test_temporal_facade_takes_affines_and_estimates_them(bundles):
    """Affines given to update() reach the step; the per-frame estimator
    (enable_gmc) is the single-stream facade's, and the batched facades
    refuse the option instead of dropping it."""
    _, tb = bundles
    frames = _groups(2, seed=28)
    gmc = _affines(np.random.default_rng(29), (B, T))
    facade = thost.TemporalBatchedBoTSORTPipeline(
        tb, B, T, T_TRK, T_NMSC,
        dataclasses.replace(T_PIPE, host_bucket_dispatch=False))
    stores = tstate.empty_stores(T_TRK, B)
    for f in frames:
        got = facade.update(f, gmc)
        stores, _ = tfs.frame_step_batched_temporal(
            tb, stores, torch.from_numpy(f), T_TRK, T_NMSC, facade.pipe_cfg,
            torch.from_numpy(gmc))
    assert len(got) == T
    for x, y in zip(thost._store_tensors(facade.stores),
                    thost._store_tensors(stores)):
        assert (x is None and y is None) or torch.equal(x, y)
    for make in (
            lambda cfg: thost.TemporalBatchedBoTSORTPipeline(
                tb, B, T, T_TRK, T_NMSC, cfg),
            lambda cfg: thost.BatchedBoTSORTPipeline(tb, B, T_TRK, T_NMSC,
                                                     cfg)):
        with pytest.raises(ValueError, match="gmc_affines"):
            make(dataclasses.replace(T_PIPE, enable_gmc=True))


def test_multitrack_cli_temporal_cpu_mini(tmp_path):
    """--temporal 2 over two clips, one ending inside a group: it coasts to
    the group's end and only its real frames are written."""
    vids = [tmp_path / "a.mp4", tmp_path / "b.mp4"]
    _write_video(vids[0], _frames(4, seed=5))
    _write_video(vids[1], _frames(3, seed=6))  # ends inside group 2
    proc = subprocess.run(
        [sys.executable, "-m", "botsort_tpu_torch.cli.multitrack", "-v",
         *map(str, vids), "-ep", "cpu", "--mini", "--temporal", "2",
         "--output_dir", str(tmp_path), "--weights_dir",
         str(tmp_path / "none")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "temporal batching: 2 frames per stream" in proc.stdout
    assert "processed 2 steps x 2 streams" in proc.stdout
    assert "WARNING: no checkpoint at " + str(tmp_path / "none") \
        in proc.stderr
    for stem, n in (("a", 4), ("b", 3)):
        cap = cv2.VideoCapture(str(tmp_path / f"{stem}_tracked.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
        cap.release()


# [stream][frame] regimes of one group; the step's regime is the busiest
# of its B x T frames.
GROUP_LEVELS = {"none": (("none", "none"), ("none", "none")),
                "chunk": (("none", "chunk"), ("none", "none")),
                "full": (("chunk", "none"), ("full", "chunk"))}


@pytest.mark.parametrize("regime", list(GROUP_LEVELS))
def test_switch_temporal_step_matches_jax(bundles, regime):
    """B = 2 streams x T = 2 frames with no bucket: perception over the
    four frames switches on their largest live count (0, 3, 7), and the
    temporal step equals the JAX package's."""
    jcb, tcb = count_bundles(*bundles)
    levels = [REGIMES[r] for row in GROUP_LEVELS[regime] for r in row]
    frames = np.stack(level_frames(levels, seed=7)).reshape(
        (B, T) + level_frames([10])[0].shape)
    assert_perception_equals_jax(jcb, tcb, frames.reshape(
        (B * T,) + frames.shape[2:]), regime, LIVE[regime], WIDTH[regime])
    jst = jax.tree.map(lambda x: jnp.stack([x] * B),
                       jstate.empty_store(TRK))
    jst, j_res = jfs.frame_step_batched_temporal(
        jcb, jst, jnp.asarray(frames), TRK, NMSC, SWITCH_PIPE)
    tst, t_res = tfs.frame_step_batched_temporal(
        tcb, tstate.empty_stores(T_TRK, B), torch.from_numpy(frames), T_TRK,
        T_NMSC, _port(SWITCH_PIPE))
    assert_step_equals_jax(tst, t_res, jst, j_res, regime)
    assert tuple(t_res.nms_converged.shape) == (B, T)

