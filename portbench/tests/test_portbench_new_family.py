"""A body encoder of a family the benchmark has never seen, added as new
files only: a class on each side (toy_reference.py, toy_program.py),
found by name as ``portbench.reference.toy_body`` and
``botsort_tpu_torch.models.toy_body`` from a folder outside the
repository, and a configuration naming them. The miniature cell built,
seeded, counted, controlled, sized and judged with it; every file of the
benchmark's folder unchanged."""

import copy
import hashlib
import importlib
import json
import os
import shutil
import sys

import pytest
import torch

from portbench import counts, faults, gen, networks, registry, run
from portbench.reference import nets
from portbench.tests import minicell

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = registry.HERE
LIMITS = registry.limits("mot17_256.loaded.1stream")["limits"]
MODULES = ("portbench.reference.toy_body",
           "botsort_tpu_torch.models.toy_body")
TOY = {"program": "botsort_tpu_torch.models.toy_body:ToyBody",
       "reference": "portbench.reference.toy_body:ToyBody",
       "args": {"width": 96, "patch": 8, "feature_dim": 96}}


def snapshot():
    out = {}
    for root, dirs, files in os.walk(PORTBENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy family's two files copied outside the repository, each
    package's search path extended to find them by name; returns the
    miniature configuration with the toy body."""
    import botsort_tpu_torch.models
    import portbench.reference

    for pkg, src in ((portbench.reference, "toy_reference.py"),
                     (botsort_tpu_torch.models, "toy_program.py")):
        ext = tmp_path / "ext" / pkg.__name__
        ext.mkdir(parents=True)
        shutil.copy(os.path.join(HERE, src), ext / "toy_body.py")
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(ext)])
    cfg = copy.deepcopy(minicell.MINI_CONFIG)
    cfg["models"]["body"] = TOY
    yield cfg
    for name in MODULES:
        sys.modules.pop(name, None)
        parent, _, leaf = name.rpartition(".")
        if hasattr(sys.modules[parent], leaf):
            delattr(sys.modules[parent], leaf)


def test_the_cell_runs_and_is_correct_with_new_files_only(
        toy, tmp_path, monkeypatch, capsys):
    before = snapshot()
    assert any(p.endswith("run.py") for p in before)
    args = minicell.make(tmp_path, monkeypatch, limits=LIMITS, config=toy)
    code = run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", "1", "--trace", "0"], device_kind="cpu")
    printed = capsys.readouterr()
    assert code == 0, printed.err[-2000:]
    out = json.loads(printed.out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 2
    assert out["checks"]["body_cos_gap"]["value"] < 1e-4
    assert snapshot() == before


@pytest.mark.parametrize("fault", ["state_unchanged", "toy_half_batch"])
def test_a_planted_fault_is_not_correct(toy, tmp_path, monkeypatch, fault):
    """A fault of faults.py, and faults.py's half batch planted in the
    toy encoder (its own is the published encoder's)."""
    args = minicell.make(tmp_path, monkeypatch, limits=LIMITS, config=toy)
    if fault == "toy_half_batch":
        cls = getattr(importlib.import_module(MODULES[1]), "ToyBody")

        def make(original):
            def broken(self, images):
                out = original(self, images)
                half = max(out.shape[0] // 2, 1)
                return torch.cat([out[:half], out[:half].mean(
                    dim=0, keepdim=True).expand(out.shape[0] - half, -1)])
            return broken
        planted = faults.patched(cls, "forward", make)
    else:
        planted = faults.FAULTS[fault]()
    with planted:
        out = run.run(args, device_kind="cpu")
    assert not out["correct"], out["checks"]
    if fault == "toy_half_batch":
        check = out["checks"]["body_cos_gap"]
        assert check["value"] > check["limit"]


def test_the_body_counts_include_the_products_of_activations(toy):
    """A 64x32 crop: 8x4 patches and the token, 33 tokens of 96."""
    t, c, p = 33, 96, 8
    patch = 2 * c * 8 * 4 * (3 * p * p)
    dense = 2 * t * 3 * c * c + 2 * c * c
    attention = 2 * t * t * c * 2
    got = counts.network_counts(TOY, (64, 32))
    assert got["flops"] == patch + dense + attention
    assert got["norm_bytes"] == 0
    body = counts.cell_counts(toy)["body"]
    assert body == got


def test_the_control_rounds_the_products_of_activations(toy):
    model = networks.reference_network(TOY)
    gen.init_weights([model], 7, "cpu")
    x = torch.randn(3, 64, 32, 3,
                    generator=torch.Generator().manual_seed(1))
    f32 = model(x)
    seen = []
    model.Attention_0.register_forward_hook(
        lambda m, i, o: seen.append(m.precision))
    nets.set_precision(model, "fp8")
    low = model(x)
    assert seen == ["fp8"] and model.Dense_0.precision == "fp8"
    assert (low - f32).abs().max() > 1e-3
    model.Dense_0.precision = model.Dense_1.precision = "float32"
    model.Conv_0.precision = "float32"
    assert (model(x) - f32).abs().max() > 1e-4  # the products alone


def test_seeded_by_its_own_hook_and_sized_by_its_output(toy):
    model = networks.reference_network(TOY)
    gen.init_weights([model], 2 ** 31 + 5, "cpu")
    assert torch.equal(model.LayerNorm_0.weight, torch.ones(96))
    assert model.token.abs().sum() > 0 and model.token.isfinite().all()
    assert model(torch.zeros(2, 64, 32, 3)).shape == (2, 96)
    s = run.settings_of(toy, minicell.MINI_TRAFFIC)
    assert (s.body_feature_dim, s.face_feature_dim) == (96, 256)
