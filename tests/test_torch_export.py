"""The port's exported frame-step programs (runtime/exported.py) on the CPU.

One module fixture exports, at one bucket pair of a MINI float32 bundle,
the one-stream and the 2-stream programs, saves them and loads them back.
The NMS IoU threshold is lowered, so that boxes suppress each other: the
programs run the suppression fixpoint to its end (kernel K8's op), one
program a pair.

Everything here is the port against itself, so every comparison is
bitwise: the loaded programs against the live ``frame_step`` /
``frame_step_batched`` on every store and FrameResult field,
``load_pipeline`` / ``load_batched_pipeline`` against the live facades
(also through a graph cache), a live step after the export against the
same step before it and in a fresh process.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import numpy as np
import pytest
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.models.common import BatchNorm
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.runtime import assets as tassets
from botsort_tpu_torch.runtime import exported
from botsort_tpu_torch.track import state as tstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The MINI configuration of tests/test_torch_pipeline.py, with a low NMS
# IoU threshold so that boxes suppress each other.
TRK = TrackerConfig(
    max_tracks=16, body_feature_dim=256, face_feature_dim=256,
    det_score_threshold=0.05, track_high_thresh=0.22,
    track_low_thresh=0.05, new_track_thresh=0.24)
NMSC = NMSConfig(max_boxes_per_class=8, score_threshold=0.01,
                 iou_threshold=0.2)
PIPE = PipelineConfig(detector_input_hw=(96, 128),
                      body_reid_input_hw=(64, 32),
                      face_reid_input_hw=(32, 32), max_reid_batch=4)
SRC_HW = (240, 320)
BUCKET = 8        # the det width: one pair, (8, 8), is always exact


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: tier-1 runs several workers on
    a few cores, and a thread pool per worker makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, streams=0, seed=0):
    """n steps of noise with bright moving blocks ([H, W, 3] each, or
    [streams, H, W, 3] with a scene per stream)."""
    def scene(s):
        rng = np.random.default_rng(seed + 10 * s)
        out = []
        for t in range(n):
            img = rng.integers(0, 255, SRC_HW + (3,), dtype=np.uint8)
            for k in range(3):
                x = 30 + 90 * k + 4 * t
                img[60:200, x:x + 50] = (40 + 70 * k, 200, 120)
            out.append(img)
        return out

    if not streams:
        return scene(0)
    per = [scene(s) for s in range(streams)]
    return [np.stack([p[t] for p in per]) for t in range(n)]


def _bundle():
    return tassets.build_bundle(weights_dir="/nonexistent", mini=True,
                                device="cpu", dtype=torch.float32, seed=3)


def _live(bundle, streams, frames):
    """The live step's flat outputs (store fields, then the FrameResult's)
    over consecutive frames, each from the previous step's store."""
    store = (tstate.empty_stores(TRK, streams) if streams
             else tstate.empty_store(TRK))
    fn = tfs.frame_step_batched if streams else tfs.frame_step
    outs = []
    for f in frames:
        store, res = fn(bundle, store, torch.from_numpy(f), TRK, NMSC, PIPE,
                        None, BUCKET, BUCKET)
        outs.append((*exported._present(store), *thost._result_tensors(res)))
    return outs


def _equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        assert torch.equal(a, b), (what, i)


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """(artifact directory, bundle, manifest, live outputs before the
    export)."""
    out = str(tmp_path_factory.mktemp("exported"))
    bundle = _bundle()
    before = _live(bundle, 0, _frames(2))
    manifest = exported.export_all(
        bundle, TRK, NMSC, PIPE, out, [SRC_HW], streams=2,
        buckets=[BUCKET], mini=True, log=lambda *_: None)
    return out, bundle, manifest, before


@pytest.fixture(scope="module")
def programs(export_dir):
    out, bundle, _, _ = export_dir
    return exported.Programs(out, bundle)


def test_manifest_lists_both_nms_programs_and_the_field_layout(export_dir):
    """One program a (resolution, bucket pair) at each stream count: the
    NMS fixpoint runs to its end inside it, so the fixed-count program and
    its full-count re-run became one."""
    out, bundle, manifest, _ = export_dir
    assert manifest["platform"] == {"type": "cpu"}
    assert manifest["torch_version"] == torch.__version__
    assert manifest["buckets"] == [BUCKET]
    for key, streams in (("artifacts", None), ("batched_artifacts", 2)):
        entries = manifest[key]
        assert [(e["reid_bucket"], e["face_bucket"]) for e in entries] == [
            (BUCKET, BUCKET)]
        for e in entries:
            assert "nms_iters" not in e
            assert e.get("streams") == streams
            assert os.path.getsize(os.path.join(out, e["file"])) == \
                e["bytes"]
    io = manifest["inputs"]
    assert [w[0] for w in io["weights"]] == exported.weight_names(bundle)
    n_norms = sum(isinstance(m, BatchNorm) for net in exported.NETS
                  for m in getattr(bundle, net).modules())
    assert len(io["constants"]) == n_norms
    assert manifest["outputs"]["result"] == list(
        tfs.FrameResult._fields[:-1])
    # The crops' numerics (PipelineConfig's JAX defaults).
    assert (manifest["pipe_cfg"]["compute_dtype"],
            manifest["pipe_cfg"]["crop_int8"]) == ("bfloat16", True)
    assert exported.manifest_configs(manifest)[2] == PIPE
    with open(os.path.join(out, exported.MANIFEST)) as f:
        assert json.load(f) == manifest


def test_a_manifest_without_the_crop_fields_reads_as_float32(export_dir,
                                                             tmp_path):
    """Programs exported before the port read compute_dtype and crop_int8
    interpolated in float32: such a manifest gives that configuration, and
    the loaded facade carries it."""
    out, bundle, manifest, _ = export_dir
    old = json.loads(json.dumps(manifest))
    for key in ("compute_dtype", "crop_int8"):
        del old["pipe_cfg"][key]
    pipe_cfg = exported.manifest_configs(old)[2]
    assert (pipe_cfg.compute_dtype, pipe_cfg.crop_int8) == ("float32", False)
    assert pipe_cfg == dataclasses.replace(PIPE, compute_dtype="float32",
                                           crop_int8=False)
    d = _edited_copy(out, str(tmp_path / "old"), lambda m: [
        m["pipe_cfg"].pop(k) for k in ("compute_dtype", "crop_int8")])
    assert exported.load_pipeline(d, bundle).pipe_cfg == pipe_cfg


@pytest.mark.parametrize("streams", [0, 2])
def test_programs_call_the_kernels_as_custom_ops(export_dir, programs,
                                                 streams):
    """The loaded graph calls K1/K2, K6, K7, K8 and K10 as
    torch.ops.botsort_tpu_torch ops (one cascade solve, one norm per
    BatchNorm module, three crops: the detector input, body and face, in
    int8 mode, one NMS fixpoint, one hierarchy scan), derives no
    batch-norm constant and holds no weight."""
    _, bundle, _, _ = export_dir
    ep = programs.exported_program(streams, SRC_HW, BUCKET, BUCKET)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("botsort_tpu_torch.cascade_solve.default") == 1
    assert targets.count("botsort_tpu_torch.nms_fixpoint.default") == 1
    assert targets.count("botsort_tpu_torch.hierarchy_scan.default") == 1
    n_norms = sum(isinstance(m, BatchNorm) for net in exported.NETS
                  for m in getattr(bundle, net).modules())
    assert targets.count("botsort_tpu_torch.bn_act.default") == n_norms
    assert not any("rsqrt" in t for t in targets)
    crops = [n for n in ep.graph.nodes if str(n.target) ==
             "botsort_tpu_torch.crop_resize.default"]
    assert [n.args[-1] for n in crops] == ["int8"] * 3
    assert not ep.state_dict and ep.example_inputs is None
    # The constants are the step's few literals (means, limits, boxes).
    assert sum(v.numel() * v.element_size()
               for v in ep.constants.values()) < 1024


@pytest.mark.parametrize("streams", [0, 2])
def test_loaded_program_equals_the_live_step(export_dir, programs, streams):
    _, bundle, _, _ = export_dir
    frames = _frames(3, streams, seed=1)
    want = _live(bundle, streams, frames)
    store = (tstate.empty_stores(TRK, streams) if streams
             else tstate.empty_store(TRK))
    for t, f in enumerate(frames):
        store, res = programs.run(streams, store, torch.from_numpy(f),
                                  BUCKET, BUCKET)
        _equal((*exported._present(store), *thost._result_tensors(res)),
               want[t], f"step {t}")


_FRESH = """
import sys, torch
sys.path.insert(0, {repo!r})
from tests.test_torch_export import _bundle, _frames, _live
torch.set_num_threads(1)  # as in the test module
torch.save(_live(_bundle(), 0, _frames(2)), {path!r})
"""


def test_live_step_after_an_export_equals_before_and_a_fresh_process(
        export_dir, tmp_path):
    _, bundle, _, before = export_dir
    after = _live(bundle, 0, _frames(2))
    path = str(tmp_path / "fresh.pt")
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH.format(repo=REPO, path=path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    fresh = torch.load(path, weights_only=True)
    for t in range(2):
        _equal(after[t], before[t], f"after vs before, step {t}")
        _equal(after[t], [torch.as_tensor(x) for x in fresh[t]],
               f"after vs fresh process, step {t}")


def _run_facades(live, loaded, streams, n=5):
    """Both facades over the same frames, compared bitwise at every step;
    returns the buckets of every step the loaded one ran."""
    calls = []
    real = loaded._step
    loaded._step = lambda *a: calls.append((a[2], a[3])) or real(*a)
    for frames in _frames(n, streams, seed=2):
        want, got = live.update(frames), loaded.update(frames)
        assert _ids(got) == _ids(want)
        for a, b in zip(live.last_result[:-1], loaded.last_result[:-1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(live.last_result.tracks, loaded.last_result.tracks):
            np.testing.assert_array_equal(a, b)
    store = (lambda p: p.stores) if streams else (lambda p: p.store)
    for x, y in zip(thost._store_tensors(store(live)),
                    thost._store_tensors(store(loaded))):
        assert (x is None and y is None) or torch.equal(x, y)
    return calls


def _ids(tracks):
    if tracks and isinstance(tracks[0], list):
        return [[t.track_id for t in s] for s in tracks]
    return [t.track_id for t in tracks]


@pytest.mark.parametrize("cached", [False, True], ids=["eager", "cache"])
@pytest.mark.parametrize("streams", [0, 2])
def test_loaded_facade_equals_the_live_facade(export_dir, programs, streams,
                                              cached):
    """load_pipeline / load_batched_pipeline against the live facades:
    equal tracks, FrameResults and stores, one program call a frame (the
    det-width pair never overflows, and the NMS fixpoint needs no re-run);
    with ``cached``, through a graph cache (the CPU stand-in for CUDA
    graphs)."""
    from tests.test_torch_graphed import EagerReplayCache

    out, bundle, _, _ = export_dir
    cache = EagerReplayCache(torch.device("cpu")) if cached else None
    if streams:
        live = thost.BatchedBoTSORTPipeline(bundle, streams, TRK, NMSC, PIPE)
        loaded = exported.load_batched_pipeline(out, bundle, streams,
                                                programs=programs)
        loaded._graphs = cache
    else:
        live = thost.BoTSORTPipeline(bundle, TRK, NMSC, PIPE)
        loaded = exported.load_pipeline(out, bundle, programs=programs,
                                        graph_cache=cache)
    assert loaded._buckets == [BUCKET]
    calls = _run_facades(live, loaded, streams)
    assert calls == [(BUCKET, BUCKET)] * 5
    if cached:
        kind = "exported_batched" if streams else "exported_frame"
        assert cache.keys() == [
            (kind, streams or 1, 1) + SRC_HW + (BUCKET, BUCKET, False)]
        assert cache.replays == len(calls)


def test_warm_up_runs_every_program_of_a_resolution(export_dir, programs):
    out, bundle, _, _ = export_dir
    pipe = exported.load_pipeline(out, bundle, programs=programs)
    ran = thost.warm_up(pipe, SRC_HW)
    assert [k for k, _ in ran] == [(BUCKET, BUCKET)]
    assert pipe.frame_id == 0 and int(pipe.store.frame_count) == 0


@pytest.mark.slow
def test_export_cli_writes_every_pair_and_the_loaded_facade_runs_them(
        tmp_path, monkeypatch):
    """cli/export.py at its MINI defaults, with the bucket set unpatched:
    the program of every pair of ``reid_bucket_set``;
    ``load_pipeline`` accepts the whole manifest, ``warm_up`` loads and
    runs every program, and the loaded facade equals the live one."""
    from botsort_tpu_torch.cli import export as export_cli

    out = str(tmp_path / "all")
    bundle = _bundle()
    monkeypatch.setattr(tassets, "build_bundle", lambda *a, **k: bundle)
    assert export_cli.main(["--out", out, "--resolutions", "240x320",
                            "-ep", "cpu", "--mini"]) == 0
    manifest = exported.read_manifest(out)
    cfgs = exported.manifest_configs(manifest)
    buckets = tfs.reid_bucket_set(*cfgs)
    assert manifest["buckets"] == buckets and len(buckets) > 2
    every = thost.bucket_pairs(buckets)
    assert sorted((e["reid_bucket"], e["face_bucket"])
                  for e in manifest["artifacts"]) == sorted(every)
    loaded = exported.load_pipeline(out, bundle)
    assert [k for k, _ in thost.warm_up(loaded, SRC_HW)] == every
    live = thost.BoTSORTPipeline(bundle, *cfgs)
    _run_facades(live, loaded, 0)


def _edited_copy(src, dst, edit):
    shutil.copytree(src, dst)
    path = os.path.join(dst, exported.MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    edit(manifest)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return dst


@pytest.mark.parametrize("case", ["gmc", "no_host_dispatch", "platform",
                                  "incomplete", "weights", "streams",
                                  "resolution", "fixed_nms_count"])
def test_loaders_refuse(export_dir, tmp_path, case):
    """GMC, host_bucket_dispatch=False, a platform mismatch, an export
    without a bucket pair's program, another architecture's weights, a
    stream count that was not exported, a frame of a resolution that was
    not (the error lists those that were), and a directory exported while
    the NMS fixpoint ran a fixed count (its fixed and full programs:
    export again with cli/export.py)."""
    out, bundle, _, _ = export_dir
    edits = {
        "gmc": lambda m: m["pipe_cfg"].update(enable_gmc=True),
        "no_host_dispatch": lambda m: m["pipe_cfg"].update(
            host_bucket_dispatch=False),
        "platform": lambda m: m.update(platform={"type": "cuda",
                                                 "name": "a card"}),
        "incomplete": lambda m: m.update(buckets=[4, BUCKET]),
        "fixed_nms_count": lambda m: m.update(artifacts=[
            dict(e, file=e["file"].replace(".pt2", f"_nms{k}.pt2"),
                 nms_iters=it) for e in m["artifacts"]
            for k, it in (("fixed", None), ("full", 512))]),
    }
    if case in edits:
        d = _edited_copy(out, str(tmp_path / "edited"), edits[case])
        match = {"gmc": "camera motion", "no_host_dispatch":
                 "host_bucket_dispatch", "platform": "exported for",
                 "incomplete": "lacks the program",
                 "fixed_nms_count": "cli/export.py"}[case]
        with pytest.raises(ValueError, match=match):
            exported.load_pipeline(d, bundle)
    elif case == "weights":
        bf16 = _bundle()
        tassets.cast_compute(bf16.detector, torch.bfloat16)
        with pytest.raises(ValueError, match="weights"):
            exported.load_pipeline(out, bf16)
    elif case == "streams":
        with pytest.raises(ValueError, match="3 stream"):
            exported.load_batched_pipeline(out, bundle, 3)
    else:
        pipe = exported.load_pipeline(out, bundle)
        with pytest.raises(KeyError, match=r"\(240, 320\)"):
            pipe.update(np.zeros((120, 160, 3), np.uint8))


def test_exporting_refuses_gmc_and_in_program_dispatch():
    bundle = _bundle()
    for cfg in (dataclasses.replace(PIPE, enable_gmc=True),
                dataclasses.replace(PIPE, host_bucket_dispatch=False)):
        with pytest.raises(ValueError):
            exported.export_frame_step(bundle, TRK, NMSC, cfg, SRC_HW,
                                       BUCKET, BUCKET)


def test_multitrack_artifact_dir_equals_the_live_multitrack(export_dir,
                                                            programs,
                                                            tmp_path,
                                                            monkeypatch):
    """cli/multitrack.py --artifact_dir over the fixture's 2-stream
    programs (the fixture's bundle and loaded programs stand in for the
    CLI's build_bundle and Programs) draws the tracks the live batched
    facade tracks on the same video frames."""
    import cv2

    from botsort_tpu_torch.cli import multitrack
    from botsort_tpu_torch.io import draw

    out, _, _, _ = export_dir
    vids = []
    for s in range(2):
        path = str(tmp_path / f"v{s}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                            SRC_HW[::-1])
        for img in _frames(3, 0, seed=20 + s):
            w.write(img)
        w.release()
        vids.append(path)
    drawn = []
    monkeypatch.setattr(draw, "draw_tracks",
                        lambda frame, tracks, **kw: drawn.append(
                            [t.track_id for t in tracks]))
    bundle = export_dir[1]
    monkeypatch.setattr(tassets, "build_bundle", lambda *a, **k: bundle)
    monkeypatch.setattr(exported, "Programs", lambda *a, **k: programs)
    assert multitrack.main(["-v", *vids, "-ep", "cpu", "-dvw",
                            "--artifact_dir", out]) == 0
    got = list(drawn)
    # The live facade on the frames the CLI decoded.
    caps = [cv2.VideoCapture(v) for v in vids]
    live = thost.BatchedBoTSORTPipeline(bundle, 2, TRK, NMSC, PIPE)
    want = []
    for _ in range(3):
        frames = np.stack([c.read()[1] for c in caps])
        want += [[t.track_id for t in s] for s in live.update(frames)]
    assert got == want and len(got) == 6
