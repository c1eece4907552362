"""The port's serving and persistence surfaces on the CPU, at MINI: the
export CLI (one bucket, so that it writes one program), the server over
the live models and over the exported programs, the warm-up CLI, the
track-store checkpoint and the facades' session resume, and
``platform_summary``.

The server's answers are compared with a pipeline driven directly on the
same frames (the JSON is equal); a resumed session with an uninterrupted
one, bitwise.
"""

import argparse
import io
import json
import socket
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from botsort_tpu_torch.cli import export as export_cli
from botsort_tpu_torch.cli import serve, warmup
from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.runtime import assets as tassets
from botsort_tpu_torch.runtime import checkpoint, device, exported
from botsort_tpu_torch.track import state as tstate

HW = (120, 160)
# The CLIs' MINI configuration.
MINI_TRK = TrackerConfig(body_feature_dim=256, face_feature_dim=256,
                         max_dets=8)
MINI_PIPE = PipelineConfig(detector_input_hw=(96, 128),
                           body_reid_input_hw=(64, 32),
                           face_reid_input_hw=(32, 32), max_reid_batch=4)
# Low thresholds, so that random MINI weights make tracks.
TRK = TrackerConfig(
    max_tracks=16, body_feature_dim=256, face_feature_dim=256, max_dets=8,
    det_score_threshold=0.05, track_high_thresh=0.22,
    track_low_thresh=0.05, new_track_thresh=0.24)
NMSC = NMSConfig(max_boxes_per_class=8, score_threshold=0.01)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: tier-1 runs several workers on
    a few cores, and a thread pool per worker makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        img = rng.integers(0, 255, HW + (3,), dtype=np.uint8)
        for k in range(2):
            x = 20 + 60 * k + 3 * t
            img[30:100, x:x + 30] = (40 + 90 * k, 200, 120)
        out.append(img)
    return out


def _bundle(weights_dir="/nonexistent"):
    return tassets.build_bundle(weights_dir=weights_dir, mini=True,
                                device="cpu", dtype=torch.float32)


def _npy(img) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _npy_decoder(data: bytes):
    try:
        return np.load(io.BytesIO(data))
    except ValueError:
        return None


def _serve(factory, frames_per_connection):
    """Run a server thread over ``factory`` with the numpy decoder; send
    each connection's frames; return the JSON answers per connection."""
    server = serve.Server(("127.0.0.1", 0),
                          serve.make_handler(factory, _npy_decoder))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = []
    try:
        for frames in frames_per_connection:
            got = []
            with socket.create_connection(server.server_address) as sock:
                for img in frames:
                    serve.send_message(sock, _npy(img))
                    got.append(json.loads(serve.recv_message(sock)))
                serve.send_message(sock, b"garbage")
                got.append(json.loads(serve.recv_message(sock)))
                sock.sendall(b"\0\0\0\0")
            answers.append(got)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return answers


def _direct(pipeline, frames):
    return [json.loads(serve.tracks_to_json(n + 1, pipeline.update(f)))
            for n, f in enumerate(frames)]


def _args(**kw):
    base = dict(int8=False, execution_provider="cpu", artifact_dir="",
                weights_dir="/nonexistent", mini=True)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def cli_export(tmp_path_factory):
    """cli/export.py --mini -ep cpu at 120x160 with the bucket set patched
    to the det width alone: the program of one pair."""
    out = str(tmp_path_factory.mktemp("cli_export"))
    with mock.patch.object(exported, "reid_bucket_set", lambda *a: [8]):
        rc = export_cli.main(["--out", out, "--resolutions", "120x160",
                              "--mini", "-ep", "cpu", "--weights_dir",
                              "/nonexistent"])
    assert rc == 0
    return out


def test_export_cli_writes_both_programs_of_each_pair(cli_export):
    """One program a pair now: the NMS fixpoint runs to its end inside it,
    so the fixed-count program and its full-count re-run became one."""
    manifest = exported.read_manifest(cli_export)
    assert manifest["mini"] and manifest["buckets"] == [8]
    assert [(e["frame_hw"], e["reid_bucket"], e["face_bucket"])
            for e in manifest["artifacts"]] == [([120, 160], 8, 8)]
    assert not any("nms_iters" in e for e in manifest["artifacts"])
    assert manifest["batched_artifacts"] == []
    assert exported.manifest_configs(manifest) == (
        TrackerConfig(max_tracks=16, max_dets=8, body_feature_dim=256,
                      face_feature_dim=256), NMSConfig(), MINI_PIPE)


@pytest.mark.parametrize("artifacts", [False, True],
                         ids=["live", "exported"])
def test_serve_round_trip(cli_export, artifacts):
    """Two connections, one after another: each tracks its own stream from
    frame 1 (fresh state, shared programs), answers a bad payload with an
    error and goes on; the JSON equals a pipeline driven directly."""
    args = _args(artifact_dir=cli_export if artifacts else "")
    factory, cache = serve.build_pipeline_factory(args)
    assert cache is None  # graphs only on a card
    made = []
    answers = _serve(lambda: made.append(factory()) or made[-1],
                     [_frames(3, seed=1), _frames(2, seed=2)])
    assert len(made) == 2 and made[0] is not made[1]
    if artifacts:
        assert made[0].programs is made[1].programs
        direct = exported.load_pipeline(cli_export, made[0].bundle,
                                        programs=made[0].programs)
    else:
        direct = thost.BoTSORTPipeline(_bundle(), MINI_TRK, NMSConfig(),
                                       MINI_PIPE)
    want = _direct(direct, _frames(3, seed=1))
    assert answers[0][:3] == want
    assert answers[0][3] == {"error": "decode failed"}
    direct.reset()
    assert answers[1][:2] == _direct(direct, _frames(2, seed=2))
    assert [a["frame"] for a in answers[1][:2]] == [1, 2]


def test_serve_round_trip_tracks_something(tmp_path):
    """With low thresholds the random MINI weights make tracks, and the
    server's JSON still equals the direct pipeline's, ids and boxes."""
    bundle = _bundle()
    answers = _serve(lambda: thost.BoTSORTPipeline(bundle, TRK, NMSC,
                                                   MINI_PIPE),
                     [_frames(4, seed=3)])
    want = _direct(thost.BoTSORTPipeline(bundle, TRK, NMSC, MINI_PIPE),
                   _frames(4, seed=3))
    assert answers[0][:4] == want
    assert any(a["tracks"] for a in want)


def test_serve_main_warms_and_serves(capsys):
    """The CLI: --warmup_hw runs the program of every bucket pair before
    it serves."""
    ready = threading.Event()
    real = serve.Server

    class Probe(real):
        def __init__(self, address, handler):
            super().__init__(("127.0.0.1", 0), handler)
            Probe.address = self.server_address
            ready.set()

    with mock.patch.object(serve, "Server", Probe), \
            mock.patch.object(serve, "cv2_decoder",
                              lambda: _npy_decoder):
        thread = threading.Thread(target=serve.main, args=([
            "-ep", "cpu", "--mini", "--weights_dir", "/nonexistent",
            "--warmup_hw", "120x160", "--max_connections", "1"],))
        thread.start()
        assert ready.wait(300)
        with socket.create_connection(Probe.address) as sock:
            serve.send_message(sock, _npy(_frames(1)[0]))
            assert json.loads(serve.recv_message(sock))["frame"] == 1
            sock.sendall(b"\0\0\0\0")
        thread.join(60)
    assert not thread.is_alive()
    out = capsys.readouterr().out
    # {0, 4, 8}: 6 pairs, one program each
    assert out.count("warmed 120x160 buckets") == 6
    assert "serving on 127.0.0.1" in out


@pytest.mark.parametrize("flag", ["--int8", "cuda"])
def test_serve_refuses_int8_and_a_missing_card(flag, monkeypatch):
    """--int8 with exported programs (already traced) and -ep cuda without a
    card are refused, as the JAX server refuses the first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if flag == "--int8":
        with pytest.raises(SystemExit, match="--int8 cannot apply"):
            serve.main(["-ep", "cpu", "--mini", "--int8", "--artifact_dir",
                        "exported"])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["-ep", "cuda", "--mini"])


@pytest.mark.parametrize("cli", ["demo", "eval_trace"])
def test_video_clis_refuse_int8_naming_its_item(cli, tmp_path, capsys):
    """--int8 is ported (ROADMAP Queue 1 item 13): the video CLIs no longer
    refuse it but calibrate on the video's first frames and track with the
    quantized body encoder."""
    import importlib

    import cv2

    vid = str(tmp_path / "a.mp4")
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                             (160, 120))
    rng = np.random.default_rng(3)
    for _ in range(3):
        writer.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    writer.release()
    mod = importlib.import_module(f"botsort_tpu_torch.cli.{cli}")
    out = ["--output", str(tmp_path / "o.mp4"), "--headless"] \
        if cli == "demo" else ["-o", str(tmp_path / "t.csv")]
    assert mod.main(["-v", vid, "-ep", "cpu", "--mini", "--int8",
                     "--int8_calib_frames", "2", "--max_frames", "2",
                     "--weights_dir", str(tmp_path), *out]) == 0
    assert "int8: calibrating on 2 frames" in capsys.readouterr().out


def test_warmup_cli_cpu_runs_every_pair(capsys):
    assert warmup.main(["--resolutions", "120x160", "-ep", "cpu", "--mini",
                        "--weights_dir", "/nonexistent"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("ran 120x160 buckets")]
    assert [ln.split(" in ")[0] for ln in lines] == [
        f"ran 120x160 buckets ({b},{fb})"
        for b, fb in thost.bucket_pairs([0, 4, 8])]


@pytest.mark.parametrize("card", [True, False], ids=["card", "no_card"])
def test_load_store_defaults_to_the_card(tmp_path, card):
    """load_store / load_checkpoint without a device put the store on the
    card, as the JAX package's load_store returns arrays on the default
    device and build_bundle defaults to the card (here the CUDA check is
    mocked and the copy to the card recorded), and raise where there is no
    card; the CPU is asked for by name."""
    path = str(tmp_path / "store.pt")
    checkpoint.save_store(path, tstate.empty_store(TrackerConfig(
        max_tracks=4)), frame_id=3)
    moved = []

    def to(t, *a, **k):
        moved.append(torch.device(a[0] if a else k["device"]))
        return t

    with mock.patch.object(torch.cuda, "is_available", lambda: card), \
            mock.patch.object(torch.Tensor, "to", to):
        if card:
            assert checkpoint.load_store(path) is not None
            assert checkpoint.load_checkpoint(path)[1] == {"frame_id": 3}
            assert moved and {d.type for d in moved} == {"cuda"}
        else:
            for fn in (checkpoint.load_store, checkpoint.load_checkpoint):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    fn(path)
            assert not moved
    assert checkpoint.load_store(path, "cpu").frame_count.device.type == \
        "cpu"


def _stores_equal(a, b):
    for x, y in zip(thost._store_tensors(a), thost._store_tensors(b)):
        assert (x is None and y is None) or torch.equal(x, y)


def test_save_store_round_trips_every_field(tmp_path):
    cfg = TrackerConfig(max_tracks=8, body_feature_dim=16,
                        face_feature_dim=8, feature_history=3)
    rng = np.random.default_rng(0)
    store = tstate.empty_stores(cfg, 2).map(
        lambda x: torch.from_numpy(rng.integers(0, 9, tuple(x.shape))
                                   .astype(x.numpy().dtype)))
    path = str(tmp_path / "s" / "store.pt")
    checkpoint.save_store(path, store, frame_id=7, last_live=None)
    back = checkpoint.load_store(path, "cpu")
    _stores_equal(back, store)
    assert checkpoint.load_checkpoint(path, "cpu")[1] == {"frame_id": 7}
    assert checkpoint.load_store(str(tmp_path / "missing.pt"), "cpu") is None
    plain = tstate.empty_store(TrackerConfig(max_tracks=4))
    checkpoint.save_store(path, plain)
    back = checkpoint.load_store(path, "cpu")
    assert back.body_hist is None and back.hist_pos is None
    _stores_equal(back, plain)


@pytest.mark.parametrize("streams", [0, 2])
def test_resumed_session_equals_an_uninterrupted_run(tmp_path, streams):
    """save_session after 3 of 6 steps, load_session into a new facade,
    the last 3 steps: every FrameResult and the final stores equal the
    uninterrupted run's, bitwise (the bucket hint travels with the
    store)."""
    bundle = _bundle()

    def make():
        if streams:
            return thost.BatchedBoTSORTPipeline(bundle, streams, TRK, NMSC,
                                                MINI_PIPE)
        return thost.BoTSORTPipeline(bundle, TRK, NMSC, MINI_PIPE)

    per = [_frames(6, seed=5 + s) for s in range(max(streams, 1))]
    steps = [np.stack([p[t] for p in per]) if streams else per[0][t]
             for t in range(6)]
    whole, first = make(), make()
    want = []
    for f in steps:
        whole.update(f)
        want.append(whole.last_result)
    for f in steps[:3]:
        first.update(f)
    path = str(tmp_path / "session.pt")
    first.save_session(path)
    resumed = make()
    assert resumed.load_session(path)
    assert resumed.frame_id == 3
    assert not make().load_session(str(tmp_path / "none.pt"))
    for t, f in enumerate(steps[3:], start=3):
        resumed.update(f)
        for a, b in zip(resumed.last_result[:-1], want[t][:-1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(resumed.last_result.tracks, want[t].tracks):
            np.testing.assert_array_equal(a, b)
    store = (lambda p: p.stores) if streams else (lambda p: p.store)
    _stores_equal(store(resumed), store(whole))
    assert int(store(whole).next_id.max()) > 0  # tracks were made


def test_platform_summary_reports_torch():
    out = device.platform_summary()
    assert out["torch"] == torch.__version__
    if torch.cuda.is_available():
        assert out["backend"] == "cuda" and len(out["devices"]) == \
            out["device_count"]
    else:
        assert out == {"backend": "cpu", "device_count": 1,
                       "devices": ["cpu"], "torch": torch.__version__,
                       "cuda": torch.version.cuda}
