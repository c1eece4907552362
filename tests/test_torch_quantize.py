"""int8 post-training quantization (models/quantize.py) against the JAX
package's (botsort_tpu/models/quantize.py).

MINI bundles in float32 with the JAX weights carried over
(runtime/from_flax.py). Exact: the set of quantized convolution paths
(``a/b/Conv_0`` is ``a.b.Conv_0``), the int8 weights (HWIO -> OIHW) and
their scales from one ``amax`` dict, and one convolution's int32 output
against ``lax.conv_general_dilated(preferred_element_type=int32)`` on the
same int8 operands. ``calibrate`` on identical batches: relative 1e-5
(float32 activations summed in two libraries' orders). The quantized body
encoder on JAX's scales: embeddings within 1e-6 absolute of JAX's. Both
round ``x / s_x`` to int8, so where the float32 input to a quantized conv
differs in its last bits (the convolutions before it sum in other orders)
a value on a rounding boundary moves one quantum, 1/127 of the layer's
largest input; through the following convolutions, the norm and the L2
normalisation that moves a unit embedding by at most about 1e-6 (it
measured 3e-8 on these inputs). Then JAX's own bars against the float
path: cosine > 0.97 (body) and |score change| < 0.15 (detector).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import subprocess
import sys
import torch

from botsort_tpu.models import fastreid as jfastreid
from botsort_tpu.models import quantize as jq
from botsort_tpu_torch.models import fastreid as tfastreid
from botsort_tpu_torch.models import quantize as tq
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.track import state as tstate
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    REPO,
    T_NMSC,
    T_PIPE,
    T_TRK,
    bundles,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _dotted(amax):
    return {k.replace("/", "."): v for k, v in amax.items()}


def _crops(seed, n=4):
    return np.random.default_rng(seed).integers(
        0, 255, (n, 64, 32, 3)).astype(np.float32)


def _calib(bundles, which):
    """(JAX amax, port amax) of one network on the same input."""
    jb, tb = bundles
    if which == "body":
        x = _crops(1)
        return (jq.calibrate(jb.body_encoder, jb.body_params,
                             [jfastreid.preprocess(jnp.asarray(x))]),
                tq.calibrate(tb.body_encoder,
                             [tfastreid.preprocess(torch.from_numpy(x))]))
    x = np.random.default_rng(2).integers(0, 255, (1, 96, 128, 3)).astype(
        np.float32)
    return (jq.calibrate(jb.detector, jb.detector_params, [jnp.asarray(x)]),
            tq.calibrate(tb.detector, [torch.from_numpy(x)]))


@pytest.mark.parametrize("which,scope", [
    ("body", "mid"), ("detector", "mid"), ("body", "full"),
    ("detector", "full")])
def test_quantized_paths_equal_jax(bundles, which, scope):
    jamax, tamax = _calib(bundles, which)
    jfilter = {"body": jq._mid_scope_body,
               "detector": jq._mid_scope_detector}[which]
    tfilter = {"body": tq._mid_scope_body,
               "detector": tq._mid_scope_detector}[which]
    want = {k for k in _dotted(jamax)
            if scope == "full" or jfilter(k.replace(".", "/"))}
    got = {k for k in tamax if scope == "full" or tfilter(k)}
    assert got == want and len(got) > 0


@pytest.mark.parametrize("which", ["body", "detector"])
def test_calibrate_matches_jax(bundles, which):
    jamax, tamax = _calib(bundles, which)
    for k, v in _dotted(jamax).items():
        assert tamax[k] == pytest.approx(v, rel=1e-5), k


def test_quantize_params_bit_equal_jax(bundles):
    jb, tb = bundles
    jamax, _ = _calib(bundles, "body")
    jparams, jscales = jq.quantize_params(jb.body_encoder, jb.body_params,
                                          jamax)
    qweights, scales = tq.quantize_params(tb.body_encoder, _dotted(jamax))
    assert set(qweights) == set(scales) == set(_dotted(jscales))
    tree = jparams["params"]
    for path, s in jscales.items():
        kernel = tree
        for part in path.split("/"):
            kernel = kernel[part]
        kernel = np.asarray(kernel["kernel"])
        key = path.replace("/", ".")
        assert kernel.dtype == np.int8
        np.testing.assert_array_equal(qweights[key].numpy(),
                                      kernel.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(scales[key], s)


@pytest.mark.parametrize("shape,kernel,stride,pad,groups", [
    ((2, 16, 9, 7), 3, 1, 1, 2), ((3, 8, 8, 8), 3, 2, 1, 1),
    ((2, 12, 5, 6), 1, 1, 0, 1), ((1, 3, 14, 14), 6, 2, 2, 1),
    ((2, 8, 6, 6), 1, 2, 0, 1)])
def test_int8_conv_equals_lax_int32(shape, kernel, stride, pad, groups):
    rng = np.random.default_rng(sum(shape))
    n, c, h, w = shape
    o = 2 * c
    x8 = rng.integers(-127, 128, shape).astype(np.int8)
    w8 = rng.integers(-127, 128, (o, c // groups, kernel, kernel)).astype(
        np.int8)
    got = tq.int8_conv2d(torch.from_numpy(x8), torch.from_numpy(w8),
                         (stride, stride), (pad, pad), (1, 1), groups)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x8.transpose(0, 2, 3, 1)),
        jnp.asarray(w8.transpose(2, 3, 1, 0)), (stride, stride),
        ((pad, pad), (pad, pad)), feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(0, 3, 1, 2))


def test_quantized_body_matches_jax_and_its_bar(bundles):
    jb, tb = bundles
    calib = [jfastreid.preprocess(jnp.asarray(_crops(1)))]
    jmod, jparams = jq.quantize_module(jb.body_encoder, jb.body_params,
                                       calib)
    amax = {k.replace("/", "."): float(v) * 127.0
            for k, v in jmod.act_scale.items()}
    qmod = tq.QuantizedModule(tb.body_encoder, amax,
                              _dotted(jmod.w_scales))
    x = _crops(5)
    want = np.asarray(jax.jit(jmod.apply)(jparams, jfastreid.preprocess(
        jnp.asarray(x))))
    with torch.no_grad():
        got = qmod(tfastreid.preprocess(torch.from_numpy(x))).numpy()
        plain = tb.body_encoder(tfastreid.preprocess(
            torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cos = np.sum(got * plain, axis=-1)  # both L2-normalised
    assert (cos > 0.97).all(), cos
    # The original module is left float; the copy's convs are int8.
    assert not any(isinstance(m, tq.Int8Conv2d)
                   for m in tb.body_encoder.modules())
    assert sum(isinstance(m, tq.Int8Conv2d) for m in qmod.modules()) == \
        len(jmod.w_scales)


@pytest.fixture(scope="module")
def qbundle(bundles):
    _, tb = bundles
    frames = np.random.default_rng(0).integers(0, 255, (2, 240, 320, 3),
                                               dtype=np.uint8)
    return tq.quantize_bundle(tb, frames, which=("detector", "body"),
                              pipe_cfg=T_PIPE)


def test_default_scope_is_body_only(bundles):
    _, tb = bundles
    frames = np.random.default_rng(4).integers(0, 255, (2, 240, 320, 3),
                                               dtype=np.uint8)
    qb = tq.quantize_bundle(tb, frames, pipe_cfg=T_PIPE)
    assert not isinstance(qb.detector, tq.QuantizedModule)
    assert isinstance(qb.body_encoder, tq.QuantizedModule)
    assert qb.face_encoder is tb.face_encoder


def test_quantized_detector_scores_close(bundles, qbundle):
    """JAX's bar (tests/test_quantize.py): random-init MINI nets amplify
    quantization error, so the detector's scores may move up to 0.15."""
    _, tb = bundles
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 255, (1, 96, 128, 3)).astype(np.float32))
    with torch.no_grad():
        _, s0 = tb.detector(x)
        _, s1 = qbundle.detector(x)
    assert float((s0 - s1).abs().max()) < 0.15


def test_frame_step_runs_quantized_bundle(qbundle):
    frame = torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, (240, 320, 3), dtype=np.uint8))
    store = tstate.empty_store(T_TRK, torch.device("cpu"))
    for _ in range(2):
        with torch.no_grad():
            store, res = tfs.frame_step(qbundle, store, frame, T_TRK, T_NMSC,
                                        T_PIPE)
        assert torch.isfinite(res.det_scores).all()
    assert tuple(res.tracks.valid.shape) == (T_TRK.max_tracks,)


def test_demo_cli_int8_mini(tmp_path):
    vid = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                             (160, 120))
    rng = np.random.default_rng(6)
    for _ in range(4):
        writer.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    writer.release()
    proc = subprocess.run(
        [sys.executable, "-m", "botsort_tpu_torch.cli.demo", "-v", vid,
         "-ep", "cpu", "--mini", "--headless", "--max_frames", "3",
         "--int8", "--int8_calib_frames", "3",
         "--output", str(tmp_path / "out.mp4")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "int8: calibrating on 3 frames" in proc.stdout
    assert "processed 3 frames" in proc.stdout
