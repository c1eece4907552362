"""The port's trace and evaluation path against the JAX package's.

``eval/mot_metrics.py`` and ``cli/eval_mot.py`` against the JAX modules on
the checked-in fixture traces and on seeded random traces: equal metrics,
exactly (the same numpy/scipy arithmetic). ``cli/eval_trace.py -ep cpu
--mini`` against the JAX ``eval_trace`` on one synthetic video with the
same weights (the JAX package's orbax checkpoints, converted by
tools/convert_orbax_to_torch.py), both in float32 and with the low
thresholds of tests/test_torch_pipeline.py so that the random weights make
tracks: the same rows (frame, id, class, visibility) and boxes within
0.05 px, scores within 1e-3 (two libraries' float32 sums, printed to two
and four decimals). ``-tb 2`` writes the same file as per-frame steps.
"""

import functools
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu import config as jconfig
from botsort_tpu.cli import eval_mot as j_eval_mot
from botsort_tpu.cli import eval_trace as j_eval_trace
from botsort_tpu.eval import mot_metrics as jmm
from botsort_tpu.runtime import assets as jassets
from botsort_tpu_torch import config as tconfig
from botsort_tpu_torch.cli import eval_mot as t_eval_mot
from botsort_tpu_torch.cli import eval_trace as t_eval_trace
from botsort_tpu_torch.eval import mot_metrics as tmm
from tests.test_torch_assets import converted  # noqa: F401 (a fixture)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
PAIR = (os.path.join(FIX, "ref_trace_synthetic.csv"),
        os.path.join(FIX, "tpu_trace_synthetic.csv"))
LOW = dict(max_tracks=16, det_score_threshold=0.05, track_high_thresh=0.22,
           track_low_thresh=0.05, new_track_thresh=0.24)
NMS_LOW = dict(max_boxes_per_class=8, score_threshold=0.01)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: tier-1 runs several workers on
    a few cores, and a thread pool per worker makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("order", ["ref_vs_tpu", "tpu_vs_ref", "self"])
def test_metrics_equal_the_jax_module_on_the_fixtures(order):
    gt, hyp = {"ref_vs_tpu": PAIR, "tpu_vs_ref": PAIR[::-1],
               "self": (PAIR[0], PAIR[0])}[order]
    assert tmm.evaluate(gt, hyp) == jmm.evaluate(gt, hyp)
    assert tmm.load_trace(gt).keys() == jmm.load_trace(gt).keys()


def _random_trace(path, rng, ids, frames=12):
    with open(path, "w") as f:
        for t in range(1, frames + 1):
            for i in ids:
                if rng.uniform() < 0.2:
                    continue
                x, y = 20 * i + 3 * t + rng.normal(0, 4), 40 + rng.normal(0, 4)
                f.write(f"{t},{i},{x:.2f},{y:.2f},30,60,1,1,1\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_jax_module_on_random_traces(tmp_path, seed):
    rng = np.random.default_rng(seed)
    gt, hyp = str(tmp_path / "gt.csv"), str(tmp_path / "hyp.csv")
    _random_trace(gt, rng, range(1, 6))
    _random_trace(hyp, rng, range(2, 8))
    for iou in (0.3, 0.5):
        assert tmm.evaluate(gt, hyp, iou) == jmm.evaluate(gt, hyp, iou)


def test_eval_mot_cli_prints_the_jax_line(capsys):
    args = ["--gt", PAIR[0], "--hyp", PAIR[1], "--iou", "0.5"]
    assert j_eval_mot.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip())
    assert t_eval_mot.main(args) == 0
    assert json.loads(capsys.readouterr().out.strip()) == want
    assert want["IDSW"] == 1 and want["FN"] == 1


def _video(path, n=5, hw=(240, 320)):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                             hw[::-1])
    rng = np.random.default_rng(0)
    for t in range(n):
        img = rng.integers(0, 255, hw + (3,), dtype=np.uint8)
        for k in range(3):
            x = 30 + 90 * k + 4 * t
            img[60:200, x:x + 50] = (40 + 70 * k, 200, 120)
        writer.write(img)
    writer.release()
    return path


def _rows(path):
    with open(path) as f:
        return [line.strip().split(",") for line in f if line.strip()]


@pytest.fixture(scope="module")
def traces(converted, tmp_path_factory):  # noqa: F811 (the fixture)
    """(JAX trace, port trace, port trace with -tb 2) of one video."""
    _, weights = converted
    orbax = os.path.join(os.path.dirname(weights), "orbax")
    root = tmp_path_factory.mktemp("traces")
    video = _video(str(root / "in.mp4"))
    out = {k: str(root / f"{k}.csv") for k in ("jax", "port", "port_tb2")}
    patches = pytest.MonkeyPatch()
    try:
        # Both sides in float32 with low thresholds.
        patches.setattr(jconfig, "TrackerConfig",
                        functools.partial(jconfig.TrackerConfig, **LOW))
        patches.setattr(jconfig, "NMSConfig",
                        functools.partial(jconfig.NMSConfig, **NMS_LOW))
        patches.setattr(jconfig, "PipelineConfig", functools.partial(
            jconfig.PipelineConfig, compute_dtype="float32",
            crop_int8=False))
        patches.setattr(jassets, "build_bundle", functools.partial(
            jassets.build_bundle, dtype=jnp.float32))
        patches.setattr(tconfig, "TrackerConfig",
                        functools.partial(tconfig.TrackerConfig, **LOW))
        patches.setattr(tconfig, "NMSConfig",
                        functools.partial(tconfig.NMSConfig, **NMS_LOW))
        common = ["-v", video, "--mini", "-dvw"]
        assert j_eval_trace.main(common + ["--weights_dir", orbax, "-o",
                                           out["jax"]]) == 0
        assert t_eval_trace.main(common + ["--weights_dir", weights, "-ep",
                                           "cpu", "-o", out["port"]]) == 0
        assert t_eval_trace.main(common + ["--weights_dir", weights, "-ep",
                                           "cpu", "-o", out["port_tb2"],
                                           "-tb", "2"]) == 0
    finally:
        patches.undo()
    return out


def test_eval_trace_matches_the_jax_trace(traces):
    want, got = _rows(traces["jax"]), _rows(traces["port"])
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[7:] == w[7:], (g, w)
        np.testing.assert_allclose(np.float64(g[2:6]), np.float64(w[2:6]),
                                   atol=0.05)
        assert abs(float(g[6]) - float(w[6])) <= 1e-3
    frames = {int(r[0]) for r in want}
    assert max(frames) == 5


def test_eval_trace_temporal_batch_writes_the_same_trace(traces):
    with open(traces["port"]) as a, open(traces["port_tb2"]) as b:
        assert a.read() == b.read()


def test_eval_trace_scores_itself_perfectly(traces, capsys):
    assert t_eval_mot.main(["--gt", traces["jax"], "--hyp",
                            traces["port"]]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["MOTA"] == 1.0 and out["IDF1"] == 1.0
