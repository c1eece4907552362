"""Checkpoints for the port's bundles.

The JAX package's orbax checkpoint of a seeded MINI bundle goes through
tools/convert_orbax_to_torch.py into the port's ``.pt`` files, and
``build_bundle(weights_dir=...)`` loads them: the three networks then equal
the Flax apply at the model tests' tolerance (rtol/atol 1e-4: float32 on
both sides, convolutions summed in two libraries' orders). A missing file
gives the seeded init and the JAX package's warning; ``save_bundle`` /
``build_bundle`` round-trip bit for bit; the CLIs hand their model names
and ``--weights_dir`` to ``build_bundle``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.models.fastreid import preprocess as jpreprocess
from botsort_tpu.runtime import assets as jassets
from botsort_tpu_torch.cli import demo, multitrack
from botsort_tpu_torch.models.fastreid import preprocess as tpreprocess
from botsort_tpu_torch.runtime import assets as tassets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = (tassets.DEFAULT_DETECTOR, tassets.DEFAULT_BODY_REID,
         tassets.DEFAULT_FACE_REID)


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_to_torch",
        os.path.join(REPO, "tools", "convert_orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(JAX MINI bundle, directory of the converted .pt files)."""
    root = tmp_path_factory.mktemp("weights")
    orbax_dir, out_dir = str(root / "orbax"), str(root / "torch")
    jb = jassets.build_bundle(weights_dir=orbax_dir, mini=True, seed=5,
                              dtype=jnp.float32)
    for name, params in zip(NAMES, (jb.detector_params, jb.body_params,
                                    jb.face_params)):
        stem = os.path.splitext(name)[0]
        jassets.save_checkpoint(os.path.join(orbax_dir, stem), params)
    conv = _converter()
    assert conv.main(["--weights_dir", orbax_dir, "--out_dir", out_dir,
                      "--mini"]) == 0
    return jb, out_dir


def test_converted_checkpoints_load_and_match_flax(converted, capsys):
    jb, out_dir = converted
    for name in NAMES:
        assert os.path.isfile(tassets.checkpoint_path(out_dir, name))
    capsys.readouterr()
    tb = tassets.build_bundle(weights_dir=out_dir, mini=True, seed=99,
                              device="cpu", dtype=torch.float32)
    assert "WARNING" not in capsys.readouterr().err  # every file was found
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    crops = rng.integers(0, 255, (3, 64, 32, 3)).astype(np.uint8)
    faces = rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    want_b, want_s = jb.detector.apply(jb.detector_params, jnp.asarray(img))
    with torch.no_grad():
        got_b, got_s = tb.detector(torch.from_numpy(img))
        got_body = tb.body_encoder(tpreprocess(torch.from_numpy(crops)))
        got_face = tb.face_encoder(torch.from_numpy(faces))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(
        got_body.numpy(), np.asarray(jb.body_encoder.apply(
            jb.body_params, jpreprocess(jnp.asarray(crops)))), **TOL)
    np.testing.assert_allclose(
        got_face.numpy(), np.asarray(jb.face_encoder.apply(
            jb.face_params, jnp.asarray(faces))), **TOL)


def test_checkpoint_files_are_plain_float32_state_dicts(converted):
    _, out_dir = converted
    state = torch.load(tassets.checkpoint_path(out_dir, NAMES[2]),
                       weights_only=True)
    model = tassets.FaceReID(**tassets.MINI["face"])
    assert set(state) == set(model.state_dict())
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in state.values())


def test_converter_skips_a_missing_checkpoint(converted, tmp_path, capsys):
    conv = _converter()
    assert conv.main(["--weights_dir", str(tmp_path), "--mini"]) == 1
    assert "skipped" in capsys.readouterr().out


def test_missing_checkpoint_warns_and_keeps_the_seeded_init(converted,
                                                            tmp_path,
                                                            capsys):
    """Only the detector's file present: the encoders keep the seeded init
    and each says so on stderr, in the JAX package's words."""
    _, out_dir = converted
    det = tassets.checkpoint_path(out_dir, NAMES[0])
    os.symlink(det, tassets.checkpoint_path(str(tmp_path), NAMES[0]))
    capsys.readouterr()
    tb = tassets.build_bundle(weights_dir=str(tmp_path), mini=True, seed=4,
                              device="cpu", dtype=torch.float32)
    err = capsys.readouterr().err
    assert err.count("WARNING: no checkpoint at ") == 2
    assert err.count("; using random init") == 2
    for name in NAMES[1:]:
        assert tassets.checkpoint_path(str(tmp_path), name) in err
    seeded = tassets.build_bundle(weights_dir=str(tmp_path / "none"),
                                  mini=True, seed=4, device="cpu",
                                  dtype=torch.float32)
    assert capsys.readouterr().err.count("WARNING: no checkpoint at ") == 3
    loaded = torch.load(det, weights_only=True)
    for k, v in tb.detector.state_dict().items():
        assert torch.equal(v, loaded[k]), k
    for a, b in ((tb.body_encoder, seeded.body_encoder),
                 (tb.face_encoder, seeded.face_encoder)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    assert not torch.equal(tb.detector.state_dict()[next(iter(loaded))],
                           seeded.detector.state_dict()[next(iter(loaded))])


def test_save_bundle_round_trips_bit_for_bit(tmp_path, capsys):
    names = ("det_1x3x96x128_.onnx", "mot17_sbs_S50_NMx3x64x32_x.onnx",
             "face.onnx")
    src = tassets.build_bundle(weights_dir=str(tmp_path / "none"), mini=True,
                               seed=7, device="cpu", dtype=torch.bfloat16)
    tassets.perturb_norms_(src.body_encoder, np.random.default_rng(1))
    paths = tassets.save_bundle(src, str(tmp_path), *names)
    assert [os.path.basename(p) for p in paths] == [
        "det_1x3x96x128_.pt", "mot17_sbs_S50_NMx3x64x32_x.pt", "face.pt"]
    capsys.readouterr()
    back = tassets.build_bundle(*names, weights_dir=str(tmp_path), mini=True,
                                seed=8, device="cpu", dtype=torch.bfloat16)
    assert "WARNING" not in capsys.readouterr().err
    for a, b in zip((src.detector, src.body_encoder, src.face_encoder),
                    (back.detector, back.body_encoder, back.face_encoder)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert v.dtype == w.dtype and torch.equal(v, w), k
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(src.face_encoder(x), back.face_encoder(x))
    assert tassets.parse_detector_input_hw(names[0]) == (96, 128)
    assert tassets.parse_body_reid_input_hw(names[1]) == (64, 32)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli", ["demo", "multitrack"])
def test_cli_passes_its_model_options_through(tmp_path, monkeypatch, cli):
    """-odm / -bfem / -ffem / --weights_dir reach build_bundle (they were
    parsed and dropped)."""
    seen = {}

    def recorder(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        raise _Stop

    monkeypatch.setattr(tassets, "build_bundle", recorder)
    vid = tmp_path / "a.mp4"
    vid.write_bytes(b"")
    wdir = str(tmp_path / "w")
    with pytest.raises(_Stop):
        if cli == "demo":
            demo.main(["-v", str(vid), "-ep", "cpu", "--mini", "--headless",
                       "-odm", "det_1x3x96x128_.onnx", "-bfem",
                       "mot20_sbs_S50_NMx3x64x32_x.onnx", "-ffem", "f.onnx",
                       "--weights_dir", wdir])
        else:
            multitrack.main(["-v", str(vid), "-ep", "cpu", "--mini",
                             "--weights_dir", wdir])
    assert seen["kwargs"]["weights_dir"] == wdir
    assert seen["kwargs"]["mini"] is True
    if cli == "demo":
        assert seen["args"] == ("det_1x3x96x128_.onnx",
                                "mot20_sbs_S50_NMx3x64x32_x.onnx", "f.onnx")
