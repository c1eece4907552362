"""The port's frame step and pipeline against the JAX package's.

MINI architectures in float32 with the JAX package's weights carried
over (runtime/from_flax.py). ``frame_step`` is checked stage by stage,
each port stage fed the JAX stage's inputs so that a near-tie in one
stage (an NMS score or IoU within rounding of a threshold) cannot
cascade into the next: resize atol 1e-3, detector outputs and features
rtol 1e-4 / atol 1e-4 (conv summation order), NMS/rescale/hierarchy/
tracker integers exact. Then a 4-frame end-to-end run of both
``BoTSORTPipeline``s compares track ids, the demo CLI runs on a tiny
video, and a subprocess shows the package never loads JAX.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu import config as jconfig
from botsort_tpu.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu.models.fastreid import preprocess as jpreprocess
from botsort_tpu.ops import crop as jcrop
from botsort_tpu.ops import hierarchy as jhier
from botsort_tpu.ops import nms as jnms
from botsort_tpu.pipeline import frame_step as jfs
from botsort_tpu.pipeline.host import BoTSORTPipeline as JPipeline
from botsort_tpu.runtime.assets import build_bundle as jbuild
from botsort_tpu.track import cascade as jcascade
from botsort_tpu.track import state as jstate
from botsort_tpu_torch import config as tconfig
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline.host import BoTSORTPipeline as TPipeline
from botsort_tpu_torch.runtime import assets as tassets
from botsort_tpu_torch.runtime.from_flax import load_flax_variables
from botsort_tpu_torch.track import cascade as tcascade
from botsort_tpu_torch.track import state as tstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The MINI configuration of tests/test_e2e_oracle.py.
TRK = TrackerConfig(
    max_tracks=16, body_feature_dim=256, face_feature_dim=256,
    det_score_threshold=0.05, track_high_thresh=0.22,
    track_low_thresh=0.05, new_track_thresh=0.24)
NMSC = NMSConfig(max_boxes_per_class=8, score_threshold=0.01)
PIPE = PipelineConfig(detector_input_hw=(96, 128),
                      body_reid_input_hw=(64, 32),
                      face_reid_input_hw=(32, 32),
                      max_reid_batch=4, compute_dtype="float32",
                      crop_int8=False)
SRC_HW = (240, 320)


def _port(cfg):
    """The port's configuration object with the JAX one's values."""
    cls = getattr(tconfig, type(cfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items()
                  if k in names})


T_TRK, T_NMSC, T_PIPE = _port(TRK), _port(NMSC), _port(PIPE)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def bundles():
    jb = jbuild(mini=True, dtype=jnp.float32)
    flax_vars = [jax.device_get(v) for v in (
        jb.detector_params, jb.body_params, jb.face_params)]
    tb = tassets.build_bundle(mini=True, device="cpu", dtype=torch.float32)
    for model, variables in zip((tb.detector, tb.body_encoder,
                                 tb.face_encoder), flax_vars):
        load_flax_variables(model, variables)
    return jb, tb


def _frames(n, seed=0):
    """Noise with a few bright moving blocks, as the JAX e2e test uses."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        img = rng.integers(0, 255, SRC_HW + (3,), dtype=np.uint8)
        for k in range(3):
            x = 30 + 90 * k + 4 * t
            img[60:200, x:x + 50] = (40 + 70 * k, 200, 120)
        out.append(img)
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def _close(got, want, atol, what, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _jax_stages(jb):
    """The JAX package's frame_step stages as jitted functions."""
    d = jfs._det_width(TRK, NMSC)
    r = PIPE.max_reid_batch
    dp = -(-d // r) * r

    @jax.jit
    def resize(frame):
        full = jnp.asarray([[0.0, 0.0, SRC_HW[1], SRC_HW[0]]], jnp.float32)
        return jcrop.crop_and_resize(frame, full, PIPE.detector_input_hw)

    @jax.jit
    def detect(det_in):
        return jb.detector.apply(jb.detector_params, det_in)

    @jax.jit
    def postprocess(cb, cs):
        dets = jnms.multiclass_nms_dense(
            cb, cs, NMSC.iou_threshold, NMSC.score_threshold,
            NMSC.max_boxes_per_class, NMSC.pre_nms_top_k)
        boxes = jfs._rescale_to_source(dets.boxes, PIPE.detector_input_hw,
                                       SRC_HW)
        return dets, boxes, dets.valid & (
            dets.scores > TRK.det_score_threshold)

    @jax.jit
    def hier(boxes, valid):
        res = jhier.greedy_assign_batch([
            (boxes[1], valid[1], boxes[3], valid[3], 1),
            (boxes[0], valid[0], boxes[1], valid[1], 1),
            (boxes[0], valid[0], boxes[2], valid[2], 2)])
        return res[0][0], res[1][0], res[2][0], res[2][1]

    @functools.partial(jax.jit, static_argnames=("bucket",))
    def embed(frame, boxes, face_for_head, head_for_body, n_live, bucket):
        def body(tlbr):
            crops = jcrop.crop_and_resize(frame, tlbr,
                                          PIPE.body_reid_input_hw)
            return jb.body_encoder.apply(jb.body_params, jpreprocess(crops))

        def face(tlbr):
            crops = jcrop.crop_and_resize(frame, tlbr,
                                          PIPE.face_reid_input_hw)
            return jb.face_encoder.apply(jb.face_params, crops)

        bf = jfs._encode_chunked(body, jfs._pad_slots(boxes[0], dp),
                                 n_live, r, TRK.body_feature_dim,
                                 bucket)[:d]
        hb = jfs._pad_slots(head_for_body, dp, fill=-1)
        fb = jnp.where(hb >= 0, face_for_head[jnp.clip(hb, 0, None)], -1)
        face_tlbr = jnp.where((fb >= 0)[:, None],
                              boxes[3][jnp.clip(fb, 0, None)], 0.0)
        ff = jfs._encode_faces(face, face_tlbr, fb >= 0, n_live, r,
                               TRK.face_feature_dim, d)[:d]
        return bf, ff

    return resize, detect, postprocess, hier, embed


def test_frame_step_stage_by_stage(bundles):
    jb, tb = bundles
    resize, detect, postprocess, hier, embed = _jax_stages(jb)
    d = jfs._det_width(TRK, NMSC)
    jst, tst = jstate.empty_store(TRK), tstate.empty_store(T_TRK)
    for t, frame in enumerate(_frames(3)):
        jframe, tframe = jnp.asarray(frame), torch.from_numpy(frame)
        # 1. cv2-exact resize to the detector input.
        full = torch.tensor([[0.0, 0.0, SRC_HW[1], SRC_HW[0]]])
        j_in = resize(jframe)
        t_in = tfs.crop_and_resize(tframe, full, PIPE.detector_input_hw)
        _close(t_in, j_in, 1e-3, f"frame {t} resize")
        # 2. Detector + decode, on JAX's input. Corners are cx -/+ w/2,
        # so their error scales with the centre and size, not with the
        # corner's own value: atol 2e-3 px.
        j_cb, j_cs = detect(j_in)
        t_cb, t_cs = tb.detector(_t(j_in))
        _close(t_cb, j_cb, 2e-3, f"frame {t} candidate boxes", 1e-4)
        _close(t_cs, j_cs, 1e-4, f"frame {t} candidate scores", 1e-4)
        # 3. NMS, rescale and score filter, on JAX's candidates.
        j_dets, j_boxes, j_valid = postprocess(j_cb[0], j_cs[0])
        t_dets, t_boxes, t_valid = tfs.postprocess_detections(
            _t(j_cb[0]), _t(j_cs[0]), SRC_HW, T_TRK, T_NMSC, T_PIPE)
        _eq(t_valid, j_valid, f"frame {t} det_valid")
        _eq(t_dets.clipped, j_dets.clipped, f"frame {t} clipped")
        _close(t_boxes, j_boxes, 1e-4, f"frame {t} det boxes")
        _close(t_dets.scores, j_dets.scores, 1e-4, f"frame {t} scores")
        assert int(j_valid[0].sum()) > 0
        # 4. Box hierarchy, on JAX's boxes.
        j_hier = hier(j_boxes, j_valid)
        t_hier = tfs.attach_hierarchy(_t(j_boxes), _t(j_valid))
        for name, g, w in zip(("face_for_head", "head_for_body", "hand1",
                               "hand2"), t_hier, j_hier):
            _eq(g, w, f"frame {t} {name}")
        # 5. Body and face embeddings of JAX's boxes and hierarchy; on
        # frame 1 at the smallest bucket that covers the live bodies.
        n_live = int(j_valid[0][:d].sum())
        bucket = d if t != 1 else next(
            b for b in jfs.reid_bucket_set(TRK, NMSC, PIPE) if b >= n_live)
        j_bf, j_ff = embed(jframe, j_boxes, j_hier[0], j_hier[1], n_live,
                           bucket)
        t_bf, t_ff = tfs.embed(tb, tframe, _t(j_boxes), _t(j_hier[0]),
                               _t(j_hier[1]), T_TRK, T_NMSC, T_PIPE, bucket,
                               d)
        _close(t_bf, j_bf, 1e-4, f"frame {t} body features", 1e-4)
        _close(t_ff, j_ff, 1e-4, f"frame {t} face features", 1e-4)
        # 6. The cascade, on JAX's detections and features.
        args = (j_boxes[0][:d], j_dets.scores[0][:d], j_valid[0][:d],
                j_bf, j_ff)
        jst, j_tr = jcascade.tracker_update(jst, *args, TRK)
        tst, t_tr = tcascade.tracker_update(
            tst, *[_t(a) for a in args], T_TRK)
        for k in ("valid", "track_id", "det_index", "dropped_new"):
            _eq(getattr(t_tr, k), getattr(j_tr, k), f"frame {t} {k}")
        _close(t_tr.tlbr, j_tr.tlbr, 1e-4, f"frame {t} track boxes")
        _eq(tst.next_id, jst.next_id, f"frame {t} next_id")


def test_pipeline_four_frames_matches_jax(bundles):
    jb, tb = bundles
    jp = JPipeline(jb, TRK, NMSC, PIPE)
    tp = TPipeline(tb, T_TRK, T_NMSC, T_PIPE)
    live = 0
    for t, frame in enumerate(_frames(4, seed=1)):
        j_tracks = jp.update(frame)
        t_tracks = tp.update(frame)
        assert [x.track_id for x in t_tracks] == \
            [x.track_id for x in j_tracks], f"frame {t}"
        for a, b in zip(t_tracks, j_tracks):
            np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0, atol=1e-3)
            assert (a.body is None) == (b.body is None)
            if a.body is not None:
                assert (a.body.x1, a.body.y2) == (b.body.x1, b.body.y2)
                assert (a.body.head is None) == (b.body.head is None)
        live += len(t_tracks)
    assert live > 0


def test_pipeline_overflow_rerun_and_reset(bundles):
    """A bucket picked too small re-runs the frame from the pre-step
    store, and the result equals a run at the full bucket."""
    _, tb = bundles
    frames = _frames(3, seed=2)
    full = TPipeline(tb, T_TRK, T_NMSC, T_PIPE)
    small = TPipeline(tb, T_TRK, T_NMSC, T_PIPE)
    steps = []
    real_step = small._step
    small._step = lambda *a: steps.append(a[2:]) or real_step(*a)
    for t, frame in enumerate(frames):
        want = full.update(frame)
        if t:
            small._last_n_live, small._last_n_face = 0, 0  # bucket 0
        got = small.update(frame)
        assert [x.track_id for x in got] == [x.track_id for x in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.tlbr, b.tlbr)
    assert steps[1][0] == 0 and steps[2][0] > 0  # frame t=1 re-ran
    assert len(steps) == 5
    small.reset()
    assert small.frame_id == 0 and int(small.store.next_id) == 0


@pytest.mark.parametrize("pipe_cfg", [
    dataclasses.replace(PIPE, host_bucket_dispatch=False),
    dataclasses.replace(PIPE, disable_reid=True)], ids=["all-slots",
                                                         "iou-only"])
def test_pipeline_dispatch_modes_match_jax(bundles, pipe_cfg):
    """Every det slot embedded (no bucket dispatch), and IoU-only
    association (bucket 0: zero features), against the JAX pipeline in
    the same mode."""
    jb, tb = bundles
    jp = JPipeline(jb, TRK, NMSC, pipe_cfg)
    tp = TPipeline(tb, T_TRK, T_NMSC, _port(pipe_cfg))
    for t, frame in enumerate(_frames(3, seed=3)):
        j_ids = [x.track_id for x in jp.update(frame)]
        assert [x.track_id for x in tp.update(frame)] == j_ids, t


def test_gmc_is_not_ported_yet(bundles):
    """The name is from before camera-motion compensation was ported:
    ``enable_gmc`` now builds the estimator (it raised
    NotImplementedError), times it as stage ``gmc`` and resets it. The
    comparison with the JAX pipeline is in tests/test_torch_gmc.py."""
    _, tb = bundles
    pipe = TPipeline(tb, T_TRK, T_NMSC,
                     dataclasses.replace(T_PIPE, enable_gmc=True))
    assert pipe.gmc is not None
    for frame in _frames(2, seed=4):
        pipe.update(frame)
    assert "gmc" in pipe.timers.report()
    assert pipe.gmc._prev_gray is not None
    pipe.reset()
    assert pipe.gmc._prev_gray is None and pipe.frame_id == 0


def test_demo_cli_cpu_mini(tmp_path):
    vid = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                             (160, 120))
    for img in _frames(4):
        writer.write(np.ascontiguousarray(img[:120, :160]))
    writer.release()
    out = str(tmp_path / "out.mp4")
    proc = subprocess.run(
        [sys.executable, "-m", "botsort_tpu_torch.cli.demo", "-v", vid,
         "-ep", "cpu", "--mini", "--headless", "--max_frames", "3",
         "--output", out, "--profile"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "processed 3 frames" in proc.stdout
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()


def test_package_never_imports_jax_and_main_path_not_cv2():
    """Neither JAX nor the JAX package, on the single- and multi-stream
    paths and in the CLIs, and no OpenCV where a CLI is imported: the port
    runs where only PyTorch is installed."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "orbax", "botsort_tpu"):
            sys.modules[name] = None  # any import of them raises
        import botsort_tpu_torch
        main_path = [m.name for m in pkgutil.walk_packages(
            botsort_tpu_torch.__path__, "botsort_tpu_torch.")
            if not m.name.startswith(("botsort_tpu_torch.cli",
                                      "botsort_tpu_torch.io"))]
        for name in main_path:
            importlib.import_module(name)
        assert "cv2" not in sys.modules, "cv2 on the main path"
        from botsort_tpu_torch.pipeline import frame_step, host
        assert frame_step.frame_step_batched and host.BatchedBoTSORTPipeline
        importlib.import_module("botsort_tpu_torch.io.gmc")
        assert "cv2" not in sys.modules, "cv2 at io.gmc's import"
        importlib.import_module("botsort_tpu_torch.cli.demo")
        importlib.import_module("botsort_tpu_torch.cli.multitrack")
        for cli in ("serve", "warmup", "export", "eval_trace", "eval_mot"):
            importlib.import_module("botsort_tpu_torch.cli." + cli)
        assert "cv2" not in sys.modules, "cv2 at a CLI's import"
        importlib.import_module("botsort_tpu_torch.io.draw")
        loaded = [m for m in ("jax", "jaxlib", "flax", "botsort_tpu")
                  if sys.modules.get(m) is not None]
        assert not loaded, loaded
        print("ok", len(main_path))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")
    assert int(proc.stdout.split()[1]) >= 15


@pytest.mark.parametrize("name", ["NMSConfig", "TrackerConfig",
                                  "PipelineConfig"])
def test_port_config_matches_jax(name):
    """The port's configuration carries the JAX package's fields and
    defaults, less the TPU lowerings it does not read."""
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    want = dataclasses.asdict(jcls())
    got = dataclasses.asdict(tcls())
    tpu_only = {"compute_dtype", "crop_int8"} if name == "PipelineConfig" \
        else set()
    assert set(want) - set(got) == tpu_only
    assert got == {k: v for k, v in want.items() if k not in tpu_only}
    if name == "TrackerConfig":
        assert tcls().max_time_lost == jcls().max_time_lost
