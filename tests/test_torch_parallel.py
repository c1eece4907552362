"""Streams over several devices (parallel/streams.py,
``MeshBatchedBoTSORTPipeline``), the serving envelope (runtime/envelope.py)
and ``multitrack --chips``.

The card machine has one card, so the slices run on ``(cpu, cpu)``: two
slices of one device, each its own batched step. MINI float32 bundles.
Slice 0 of the mesh step equals ``frame_step_batched`` on its streams bit
for bit, as ``__graft_entry__.py`` holds the JAX mesh to the single-device
batched step; the mesh facade equals ``BatchedBoTSORTPipeline`` bit for
bit in every FrameResult field and track list, the padded stream count
included (JAX ``tests/test_multistream.py`` compares ids exactly and boxes
to 1e-3). The envelope cases are JAX ``tests/test_envelope.py``'s, except
the one that reads the TPU's ``BENCH_r*.json``.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from botsort_tpu_torch.parallel import streams
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.runtime import envelope
from botsort_tpu_torch.track import state as tstate
from tests.test_torch_multistream import _stream_frames
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    REPO,
    T_NMSC,
    T_PIPE,
    T_TRK,
    bundles,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(res):
    """A FrameResult's fields, tracks flattened (a list passes through)."""
    if isinstance(res, list):
        return res
    return [*res[:-1], *res.tracks]


def _assert_results_equal(got, want, what):
    for g, w, name in zip(_fields(got), _fields(want),
                          [*tfs.FrameResult._fields[:-1],
                           *tfs.TrackOutputs._fields]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: {name}")


def test_make_mesh():
    assert streams.make_mesh(3, "cpu") == (CPU,) * 3
    with pytest.raises(ValueError):
        streams.make_mesh(2, "tpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            streams.make_mesh(1, "cuda")


def test_mesh_step_slice0_equals_batched_step(bundles):
    _, tb = bundles
    mesh = streams.make_mesh(2, "cpu")
    step = streams.make_multi_stream_step(mesh, T_TRK, T_NMSC, T_PIPE)
    replicas = streams.replicate_bundle(tb, mesh)
    assert replicas[0] is replicas[1] is tb
    stores = streams.init_stream_stores(mesh, 4, T_TRK)
    ref_stores = tstate.empty_stores(T_TRK, 2, CPU)
    bucket = T_NMSC.max_boxes_per_class
    with torch.no_grad():
        for frames in _stream_frames(3, 4, seed=11):
            frames = torch.from_numpy(frames)
            stores, res = step(replicas, stores, frames, bucket, bucket)
            ref_stores, ref = tfs.frame_step_batched(
                tb, ref_stores, frames[:2], T_TRK, T_NMSC, T_PIPE, None,
                reid_bucket=bucket, face_bucket=bucket)
            assert res.tracks.valid.shape[0] == 4
            _assert_results_equal(
                tfs.FrameResult(*[f[:2] for f in res[:-1]],
                                tfs.TrackOutputs(*[f[:2] for f in
                                                   res.tracks])),
                ref, "slice 0")
    for got, want in zip(thost._store_tensors(stores[0]),
                         thost._store_tensors(ref_stores)):
        if want is not None:
            assert torch.equal(got, want)
    assert int(res.tracks.valid[:2].sum()) > 0


@pytest.mark.parametrize("n_streams,devices", [(3, 2), (4, 2), (3, 1)])
def test_mesh_pipeline_equals_batched_pipeline(bundles, n_streams, devices):
    """Three streams over two devices pad to four (stream 0 copied, its
    outputs dropped); over one device the mesh facade is the batched one."""
    _, tb = bundles
    single = thost.BatchedBoTSORTPipeline(tb, n_streams, T_TRK, T_NMSC,
                                          T_PIPE)
    mesh = thost.MeshBatchedBoTSORTPipeline(
        tb, n_streams, mesh=(CPU,) * devices, tracker_cfg=T_TRK,
        nms_cfg=T_NMSC, pipe_cfg=T_PIPE)
    assert mesh.n_chips == devices
    assert mesh.n_streams == -(-n_streams // devices) * devices
    for frames in _stream_frames(3, n_streams, seed=1):
        want = single.update(frames)
        got = mesh.update(list(frames))
        assert len(got) == n_streams
        for tg, tw in zip(got, want):
            assert [t.track_id for t in tg] == [t.track_id for t in tw]
            for a, b in zip(tg, tw):
                np.testing.assert_array_equal(a.tlbr, b.tlbr)
                assert a.score == b.score
        _assert_results_equal(
            [f[:n_streams] for f in _fields(mesh.last_result)],
            _fields(single.last_result), "mesh facade")
        assert (mesh._last_max_live, mesh._last_max_face) == \
            (single._last_max_live, single._last_max_face)
    assert sum(len(t) for t in got) > 0


def test_mesh_pipeline_session_resumes(bundles, tmp_path):
    _, tb = bundles
    steps = _stream_frames(4, 2, seed=21)
    make = lambda: thost.MeshBatchedBoTSORTPipeline(  # noqa: E731
        tb, 2, mesh=(CPU, CPU), tracker_cfg=T_TRK, nms_cfg=T_NMSC,
        pipe_cfg=T_PIPE)
    whole, first = make(), make()
    for frames in steps[:2]:
        whole.update(frames)
        first.update(frames)
    path = str(tmp_path / "session.pt")
    first.save_session(path)
    resumed = make()
    assert resumed.load_session(path)
    for frames in steps[2:]:
        want = whole.update(frames)
        got = resumed.update(frames)
        assert [[t.track_id for t in s] for s in got] == \
            [[t.track_id for t in s] for s in want]


# --- the envelope ---------------------------------------------------------


def test_max_realtime_streams_from_measured():
    cap = envelope.max_realtime_streams(30.0)
    assert cap == int(
        envelope.MEASURED_AGGREGATE_FPS[envelope.DEFAULT_POINT] // 30.0)
    assert cap >= 1


def test_envelope_keyed_by_operating_point(monkeypatch):
    monkeypatch.delenv(envelope._ENV_OVERRIDE, raising=False)
    base = envelope.aggregate_fps((256, 128))
    mot20 = envelope.aggregate_fps((384, 128))
    assert mot20 < base
    assert envelope.max_realtime_streams(
        30.0, (384, 128)) <= envelope.max_realtime_streams(30.0)
    mid = envelope.aggregate_fps((320, 128))
    assert mot20 < mid < base
    assert envelope.aggregate_fps((512, 128)) == mot20
    assert envelope.aggregate_fps((64, 64)) == base
    cap384 = envelope.max_realtime_streams(30.0, (384, 128))
    msg = envelope.stream_envelope_warning(
        cap384 + 1, "cuda", body_reid_input_hw=(384, 128))
    assert msg is not None and "384x128" in msg


def test_within_envelope_no_warning(monkeypatch):
    monkeypatch.delenv(envelope._ENV_OVERRIDE, raising=False)
    assert envelope.stream_envelope_warning(1, "cuda") is None
    cap = envelope.max_realtime_streams()
    assert envelope.stream_envelope_warning(cap, "cuda") is None


def test_over_envelope_warns_with_card_count(monkeypatch):
    monkeypatch.delenv(envelope._ENV_OVERRIDE, raising=False)
    cap = envelope.max_realtime_streams()
    msg = envelope.stream_envelope_warning(3 * cap + 1, "cuda")
    assert msg is not None and "WARNING" in msg
    assert f"Shard across {math.ceil((3 * cap + 1) / cap)} cards" in msg


def test_cpu_backend_silent_without_override(monkeypatch):
    monkeypatch.delenv(envelope._ENV_OVERRIDE, raising=False)
    assert envelope.stream_envelope_warning(1000, "cpu") is None


def test_env_override_applies_on_any_backend(monkeypatch):
    monkeypatch.setenv(envelope._ENV_OVERRIDE, "60")
    assert envelope.max_realtime_streams() == 2
    msg = envelope.stream_envelope_warning(3, "cpu")
    assert msg is not None and "2 streams" in msg


def test_env_override_garbage_falls_back(monkeypatch):
    monkeypatch.setenv(envelope._ENV_OVERRIDE, "not-a-number")
    assert envelope.aggregate_fps() == \
        envelope.MEASURED_AGGREGATE_FPS[envelope.DEFAULT_POINT]


# --- multitrack --chips -----------------------------------------------------


def _videos(tmp_path, n=2):
    import cv2

    paths = []
    for i in range(n):
        path = tmp_path / f"v{i}.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                                 15, (160, 120))
        rng = np.random.default_rng(i)
        for _ in range(3):
            writer.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
        writer.release()
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("chips,env", [("2", None), ("auto", "30")])
def test_multitrack_chips_mini_cpu(tmp_path, chips, env):
    """--chips 2 spreads two streams over two CPU slices; --chips auto does
    too when the envelope (overridden to one stream a device) says so."""
    run_env = dict(os.environ)
    run_env.pop(envelope._ENV_OVERRIDE, None)
    if env:
        run_env[envelope._ENV_OVERRIDE] = env
    proc = subprocess.run(
        [sys.executable, "-m", "botsort_tpu_torch.cli.multitrack", "-v",
         *_videos(tmp_path), "-ep", "cpu", "--mini", "-dvw", "--chips",
         chips, "--max_frames", "2", "--output_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=run_env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "sharding 2 streams over 2 devices" in proc.stdout
    assert "processed 2 steps x 2 streams" in proc.stdout
