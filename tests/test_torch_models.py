"""The port's networks against the JAX package's, on carried-over weights.

MINI architectures in float32: the JAX bundle's Flax variables go
through runtime/from_flax.py into the port's modules, and the same
numpy-seeded inputs go through both. Tolerance: rtol 1e-4 / atol 1e-4 —
both sides compute in float32, but XLA:CPU and PyTorch's CPU convolutions
sum in different orders, which moves the last bits at every layer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from botsort_tpu.models import yolox as jyolox
from botsort_tpu.models.fastreid import preprocess as jpreprocess
from botsort_tpu.runtime.assets import build_bundle as jbuild
from botsort_tpu_torch.models import yolox as tyolox
from botsort_tpu_torch.models.fastreid import preprocess as tpreprocess
from botsort_tpu_torch.runtime import assets as tassets
from botsort_tpu_torch.runtime.from_flax import load_flax_variables

TOL = dict(rtol=1e-4, atol=1e-4)


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
    return jb, tb, flax_vars


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_yolox_mini_matches_jax(bundles):
    jb, tb, _ = bundles
    img = np.random.default_rng(0).uniform(
        0, 255, (2, 96, 128, 3)).astype(np.float32)
    want_b, want_s = jb.detector.apply(jb.detector_params, jnp.asarray(img))
    got_b, got_s = tb.detector(torch.from_numpy(img))
    assert got_b.shape == (2, 252, 4) and got_s.shape == (2, 252, 4)
    _close(got_b, want_b)
    _close(got_s, want_s)


def test_fastreid_mini_matches_jax(bundles):
    jb, tb, _ = bundles
    img = np.random.default_rng(1).integers(
        0, 255, (3, 64, 32, 3)).astype(np.uint8)
    want = jb.body_encoder.apply(jb.body_params, jpreprocess(
        jnp.asarray(img)))
    got = tb.body_encoder(tpreprocess(torch.from_numpy(img)))
    assert got.shape == (3, 256) and got.dtype == torch.float32
    _close(got, want)


def test_facereid_mini_matches_jax(bundles):
    jb, tb, _ = bundles
    img = np.random.default_rng(2).uniform(
        0, 255, (3, 32, 32, 3)).astype(np.float32)
    want = jb.face_encoder.apply(jb.face_params, jnp.asarray(img))
    got = tb.face_encoder(torch.from_numpy(img))
    assert got.shape == (3, 256)
    _close(got, want)


def test_decode_outputs_matches_jax():
    rng = np.random.default_rng(3)
    levels = [rng.normal(0, 3, (2, h, w, 9)).astype(np.float32)
              for h, w in ((12, 16), (6, 8), (3, 4))]
    levels[0][0, 0, 0, 2] = 80.0  # exercises the exp clamp
    want = jyolox.decode_outputs([jnp.asarray(x) for x in levels], 4)
    got = tyolox.decode_outputs([torch.from_numpy(x) for x in levels], 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_from_flax_rejects_mismatched_trees(bundles, fault):
    _, _, flax_vars = bundles
    face_vars = jax.tree.map(np.array, flax_vars[2])
    if fault == "extra":
        face_vars["params"]["Dense_1"] = {"kernel": np.zeros((2, 2))}
    elif fault == "missing":
        del face_vars["batch_stats"]["_ConvBNRelu6_0"]
    else:
        face_vars["params"]["Dense_0"]["bias"] = np.zeros((3,))
    face = tassets.FaceReID(**tassets.MINI["face"])
    with pytest.raises((KeyError, ValueError)):
        load_flax_variables(face, face_vars)


def test_seeded_init_is_deterministic_and_follows_the_recipe():
    a, b, c = (tassets.build_bundle(mini=True, device="cpu", seed=seed,
                                    dtype=torch.float32)
               for seed in (5, 5, 6))
    wa = a.detector.CSPDarknet_0.Focus_0.Conv_0.weight
    assert torch.equal(wa, b.detector.CSPDarknet_0.Focus_0.Conv_0.weight)
    assert not torch.equal(wa, c.detector.CSPDarknet_0.Focus_0.Conv_0.weight)
    # normal x fan_in^-1/2: a 6x6x3 stem kernel has fan_in 108.
    assert abs(float(wa.std()) * 108 ** 0.5 - 1.0) < 0.15
    bn = a.body_encoder.BatchNorm_0
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert float(a.body_encoder.GeMPool_0.p) == 3.0


def test_bf16_bundle_keeps_norms_in_float32():
    tb = tassets.build_bundle(mini=True, device="cpu",
                              dtype=torch.bfloat16)
    assert tb.detector.CSPDarknet_0.Focus_0.Conv_0.weight.dtype == \
        torch.bfloat16
    assert tb.detector.CSPDarknet_0.Focus_0.BatchNorm_0.weight.dtype == \
        torch.float32
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 255, (1, 32, 32, 3)).astype(np.float32))
    out = tb.face_encoder(img)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_build_bundle_defaults_to_the_card():
    """The entry point runs on the card unless the caller asks for the
    CPU: without a device and without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tassets.build_bundle(mini=True)
