"""Camera-motion compensation in the port: the estimator against the JAX
package's (the same OpenCV calls, so the matrices are equal to the bit),
on the cases of tests/test_gmc.py, and ``BoTSORTPipeline(enable_gmc=True)``
against the JAX pipeline on a panning synthetic clip (track ids exact,
boxes atol 1e-3 as in tests/test_torch_pipeline.py).
"""

import dataclasses

import cv2
import numpy as np
import pytest

from botsort_tpu.io.gmc import GMCEstimator as JEstimator
from botsort_tpu.pipeline.host import BoTSORTPipeline as JPipeline
from botsort_tpu_torch.io.gmc import IDENTITY, GMCEstimator
from botsort_tpu_torch.pipeline.host import BoTSORTPipeline as TPipeline
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    NMSC,
    PIPE,
    SRC_HW,
    T_NMSC,
    T_PIPE,
    T_TRK,
    TRK,
    bundles,
)


def _scene(seed, hw, blur):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, hw + (3,), dtype=np.uint8)
    return cv2.GaussianBlur(base, (blur, blur), 0)


def _both(frames, **kw):
    """Every frame through both estimators; returns the port's matrices
    after checking each against the JAX package's."""
    port, ref = GMCEstimator(**kw), JEstimator(**kw)
    out = []
    for f in frames:
        got, want = port.estimate(f), ref.estimate(f)
        assert got.dtype == np.float32 and got.shape == (2, 3)
        np.testing.assert_array_equal(got, want)
        out.append(got)
    return port, out


def test_estimator_recovers_translation_like_jax():
    base = _scene(1, (240, 320), 5)
    shifted = np.roll(base, shift=(0, 8), axis=(0, 1))
    port, (h0, h1) = _both([base, shifted], downscale=1)
    np.testing.assert_allclose(h0, np.eye(2, 3), atol=1e-6)
    assert abs(h1[0, 2] - 8.0) < 1.5 and abs(h1[1, 2]) < 1.5, h1
    port.reset()
    np.testing.assert_array_equal(port.estimate(shifted), IDENTITY)


def test_estimator_recovers_rotation_zoom_like_jax():
    base = _scene(3, (360, 480), 7)
    h_true = cv2.getRotationMatrix2D((240.0, 180.0), 2.0, 1.03)
    warped = cv2.warpAffine(base, h_true, (480, 360), flags=cv2.INTER_LINEAR,
                            borderMode=cv2.BORDER_REFLECT)
    _, (_, h) = _both([base, warped], downscale=1)
    assert abs(np.sqrt(abs(np.linalg.det(h[:, :2]))) - 1.03) < 0.01, h
    c = np.array([240.0, 180.0, 1.0])
    assert np.linalg.norm(h @ c - h_true @ c) < 2.0


@pytest.mark.parametrize("downscale", [2, 8])
def test_estimator_default_path_equals_jax(downscale):
    """The strided grayscale path at the defaults, over a pan of several
    frames, and a frame too flat to track (identity)."""
    base = _scene(4, (480, 800), 9)
    frames = [np.ascontiguousarray(base[:, 16 * t:16 * t + 640])
              for t in range(4)]
    frames.append(np.full((480, 640, 3), 90, np.uint8))
    frames.append(frames[0])
    _, hs = _both(frames, downscale=downscale)
    assert abs(hs[1][0, 2] + 16.0) < 4.0, hs[1]
    np.testing.assert_array_equal(hs[-1], IDENTITY)  # no corners before it


def _panning_clip(n):
    """A textured world seen through a window that pans 6 px a frame, with
    three bright blocks fixed in the world."""
    world = _scene(6, (SRC_HW[0], SRC_HW[1] + 6 * n), 5)
    for k in range(3):
        x = 40 + 95 * k
        world[60:200, x:x + 50] = (40 + 70 * k, 200, 120)
    return [np.ascontiguousarray(world[:, 6 * t:6 * t + SRC_HW[1]])
            for t in range(n)]


def test_pipeline_with_gmc_matches_jax(bundles):
    jb, tb = bundles
    jp = JPipeline(jb, TRK, NMSC, dataclasses.replace(PIPE, enable_gmc=True))
    tp = TPipeline(tb, T_TRK, T_NMSC,
                   dataclasses.replace(T_PIPE, enable_gmc=True))
    plain = TPipeline(tb, T_TRK, T_NMSC, T_PIPE)
    live, moved = 0, False
    for t, frame in enumerate(_panning_clip(5)):
        j_tracks, t_tracks = jp.update(frame), tp.update(frame)
        assert [x.track_id for x in t_tracks] == \
            [x.track_id for x in j_tracks], f"frame {t}"
        for a, b in zip(t_tracks, j_tracks):
            np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0, atol=1e-3)
        live += len(t_tracks)
        # The affine reaches the Kalman states: coasting tracks differ
        # from a run without compensation.
        plain.update(frame)
        moved = moved or not np.array_equal(tp.store.mean.numpy(),
                                            plain.store.mean.numpy())
    assert live > 0 and moved
    assert set(tp.timers.report()) >= {"gmc", "upload", "device_step",
                                       "assemble"}
