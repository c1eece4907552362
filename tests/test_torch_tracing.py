"""The facades' tracer (botsort_tpu_torch/utils/profiling.py): host spans
at every layer boundary of an update, and the step's stage marks, on the
CPU with the graph cache's CPU stand-in (``EagerReplayCache`` of
test_torch_graphed.py, whose capture records marks as the card's does).
On the CPU a mark has no event, so a step run's stage times are names
with no device time; tests/test_torch_cuda.py reads them on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.pipeline import switch
from botsort_tpu_torch.runtime import assets
from botsort_tpu_torch.utils import profiling
from botsort_tpu_torch.utils.profiling import MARKS, ROOT, StageTimers
from tests.test_torch_graphed import EagerReplayCache
from tests.torch_scenes import REGIMES, TorchCountDetector, level_frames

CPU = torch.device("cpu")
TRK = TrackerConfig(
    max_tracks=16, body_feature_dim=256, face_feature_dim=256,
    det_score_threshold=0.05, track_high_thresh=0.22, track_low_thresh=0.05,
    new_track_thresh=0.24, max_dets=8)
NMSC = NMSConfig(max_boxes_per_class=8, score_threshold=0.01)
PIPE = PipelineConfig(detector_input_hw=(96, 128),
                      body_reid_input_hw=(64, 32),
                      face_reid_input_hw=(32, 32), max_reid_batch=4,
                      compute_dtype="float32", crop_int8=False)
SWITCH_PIPE = dataclasses.replace(PIPE, host_bucket_dispatch=False)
# The children of an update's root, in order.
CHILDREN = ["upload", "device_step", "readback", "assemble"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    """The detector stand-in (its live count follows the frame's
    brightness) with the MINI float32 encoders."""
    tb = assets.build_bundle(mini=True, seed=2, device=CPU,
                             dtype=torch.float32)
    return tfs.ModelBundle(TorchCountDetector(), tb.body_encoder,
                           tb.face_encoder)


def _frames(n, streams, seed=0, regime="chunk"):
    return [np.stack(level_frames([REGIMES[regime]] * streams,
                                  seed=seed + t)) for t in range(n)]


def _facade(kind, bundle, trace, pipe_cfg=PIPE):
    """(facade, its updates' argument of a [streams, H, W, 3] frame
    stack) with the CPU stand-in as its graph cache."""
    if kind == "single":
        pipe = thost.BoTSORTPipeline(bundle, TRK, NMSC, pipe_cfg,
                                     trace=trace)
        arg = lambda f: f[0]  # noqa: E731
    elif kind == "batched":
        pipe = thost.BatchedBoTSORTPipeline(bundle, 2, TRK, NMSC, pipe_cfg,
                                            trace=trace)
        arg = lambda f: f  # noqa: E731
    elif kind == "temporal":
        pipe = thost.TemporalBatchedBoTSORTPipeline(
            bundle, 1, 2, TRK, NMSC, pipe_cfg, trace=trace)
        arg = lambda f: f[None]  # noqa: E731
    else:
        pipe = thost.MeshBatchedBoTSORTPipeline(
            bundle, 2, mesh=(CPU, CPU), tracker_cfg=TRK, nms_cfg=NMSC,
            pipe_cfg=pipe_cfg, trace=trace)
        arg = lambda f: list(f)  # noqa: E731
    cache = EagerReplayCache(CPU)
    for p in getattr(pipe, "_slices", [pipe]):
        p._graphs = cache
    return pipe, arg, cache


def _by_update(spans):
    out = {}
    for s in spans:
        out.setdefault(s[4], []).append(s)
    return out


def _check_tree(spans):
    """Every update: one root, its children in order, each child inside
    its parent's interval; returns the (name, parent) pairs of each."""
    shapes = []
    for u, group in sorted(_by_update(spans).items()):
        roots = [s for s in group if s[3] is None]
        assert [s[0] for s in roots] == [ROOT], (u, group)
        root = roots[0]
        kids = sorted((s for s in group if s[3] == ROOT), key=lambda s: s[1])
        assert [s[0] for s in kids] == CHILDREN, (u, kids)
        for s in group:
            assert root[1] <= s[1] <= s[2] <= root[2], s
        for name, parent in (("upload.copy", "upload"),
                             ("graph.launch", "device_step"),
                             ("readback.wait", "readback")):
            for child in (s for s in group if s[0] == name):
                assert child[3] == parent
                assert any(p[0] == parent and p[1] <= child[1] <= child[2]
                           <= p[2] for p in group), child
        shapes.append(sorted({(s[0], s[3]) for s in group},
                             key=lambda x: (x[0], str(x[1]))))
    return shapes


def test_tracing_off_keeps_totals_and_records_nothing(bundle):
    pipe, arg, cache = _facade("batched", bundle, trace=False)
    assert not pipe.timers.tracing
    for f in _frames(2, 2):
        pipe.update(arg(f))
    assert pipe.timers.export() == {"spans": [], "stages": [],
                                    "body_encoder": []}
    assert pipe.timers._spans is None and pipe.timers._steps is None
    assert set(pipe.timers.report()) == set(CHILDREN)
    assert all(e.marks is None for e in cache._entries.values())
    assert profiling.current_marks() is None
    profiling.stage_mark("detect")  # outside a traced step: a no-op
    # A span is the one shared no-op context.
    assert pipe.timers.span("a") is pipe.timers.span("b")


@pytest.mark.parametrize("kind", ["single", "batched", "temporal", "mesh"])
def test_every_update_has_one_root_and_the_same_children(bundle, kind):
    pipe, arg, _ = _facade(kind, bundle, trace=True)
    single, sarg, _ = _facade("single", bundle, trace=True)
    for f in _frames(3, 2, seed=4):
        pipe.update(arg(f))
        single.update(sarg(f))
    spans = pipe.timers.export()["spans"]
    assert sorted(_by_update(spans)) == [0, 1, 2]
    assert _check_tree(spans) == _check_tree(
        single.timers.export()["spans"])
    # The stage totals are what they are untraced.
    assert set(pipe.timers.report()) == set(CHILDREN)
    summary = pipe.timers.summary()
    assert set(summary["self_ms"]) == set(CHILDREN) | {
        ROOT, "upload.copy", "graph.launch", "readback.wait"}
    assert summary["device_ms"] == {}  # no device time off CUDA
    pipe.reset()
    assert pipe.timers.export() == {"spans": [], "stages": [],
                                    "body_encoder": []}
    pipe.update(arg(_frames(1, 2, seed=9)[0]))
    assert {s[4] for s in pipe.timers.export()["spans"]} == {0}


def test_update_async_root_spans_to_the_result(bundle):
    pipe, arg, _ = _facade("batched", bundle, trace=True)
    handle = pipe.update_async(arg(_frames(1, 2)[0]))
    open_spans = pipe.timers.export()["spans"]
    assert [s[0] for s in open_spans] == ["upload.copy", "upload",
                                          "graph.launch", "device_step"]
    handle.result()
    spans = pipe.timers.export()["spans"]
    assert spans[-1][0] == ROOT and spans[-1][1] < open_spans[0][1]
    _check_tree(spans)


def test_overflow_rerun_nests_under_readback(bundle):
    pipe, arg, cache = _facade("batched", bundle, trace=True)
    frames = _frames(3, 2, seed=6, regime="full")
    pipe.update(arg(frames[0]))
    pipe._last_max_live, pipe._last_max_face = 0, 0  # bucket 0: overflows
    runs = cache.replays
    pipe.update(arg(frames[1]))
    assert cache.replays - runs == 2
    group = _by_update(pipe.timers.export()["spans"])[1]
    steps = [s for s in group if s[0] == "device_step"]
    assert [s[3] for s in steps] == [ROOT, "readback"]
    rerun = steps[1]
    assert [s[0] for s in group if s[0] != ROOT and s[3] == "readback"] == [
        "readback.wait", "device_step", "readback.wait"]
    assert [s for s in group if s[0] == "graph.launch"
            and rerun[1] <= s[1] <= s[2] <= rerun[2]]
    assert [u for u, _ in pipe.timers.export()["stages"]].count(1) == 2
    _check_tree(pipe.timers.export()["spans"])


def test_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(StageTimers, "CAPACITY", 5)
    t = StageTimers(trace=True)
    for _ in range(3):
        t.begin_update()
        with t.stage("upload"):
            pass
        with t.span("readback.wait"):
            pass
        t.end_update()
    spans = t.export()["spans"]
    assert [(s[0], s[4]) for s in spans] == [
        ("readback.wait", 1), (ROOT, 1), ("upload", 2), ("readback.wait", 2),
        (ROOT, 2)]
    assert t.counts["upload"] == 3  # the totals keep every update


@pytest.mark.parametrize("kind,pipe_cfg", [
    ("single", PIPE), ("batched", SWITCH_PIPE), ("temporal", PIPE)],
    ids=["static", "switch", "temporal"])
def test_stage_marks_in_run_order_once_a_step_run(bundle, kind, pipe_cfg):
    """Each step run's marks are MARKS in order, once: one stage row a
    replay (captures included, warm-ups not), from the captured marks."""
    pipe, arg, cache = _facade(kind, bundle, trace=True, pipe_cfg=pipe_cfg)
    for t, regime in enumerate(("none", "chunk", "full", "chunk")):
        pipe.update(arg(_frames(1, 2, seed=20 + t, regime=regime)[0]))
    rows = pipe.timers.export()["stages"]
    assert len(rows) == cache.replays
    for _, stages in rows:
        assert [name for name, _ in stages] == list(MARKS[1:])
        assert all(ms is None for _, ms in stages)
    for entry in cache._entries.values():
        assert entry.marks.names == list(MARKS)
    if pipe_cfg is SWITCH_PIPE:
        assert len(cache._entries) == 1
        assert any(item[0] == "switch" for item in cache.programs[0])


def test_a_mark_inside_a_switch_branch_is_refused(bundle, monkeypatch):
    """A branch is a conditional node's body, which takes no event-record
    node: its capture refuses a mark, traced or not."""
    real = switch.bucket_branches

    def marking(encode, dp, chunk):
        def marked(tlbr):
            profiling.stage_mark("inside")
            return encode(tlbr)
        return real(marked, dp, chunk)

    monkeypatch.setattr(switch, "bucket_branches", marking)
    for trace in (True, False):
        pipe, arg, _ = _facade("single", bundle, trace=trace,
                               pipe_cfg=SWITCH_PIPE)
        with pytest.raises(RuntimeError, match="inside a switch branch"):
            pipe.update(arg(_frames(1, 1, regime="full")[0]))
