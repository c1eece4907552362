"""The networks a configuration names: the seeded weights as they were
before configurations named them, every tensor written or an error, the
embedding widths from the networks alone, and the two import prefixes."""

import copy
import hashlib

import pytest
import torch
from torch import nn

from portbench import gen, networks, registry, run
from portbench.tests import minicell

# sha256 of every tensor of the seeded state dicts (calibrated detector,
# body, face), in key order, of the miniature configuration on the CPU at
# one thread (the detector's calibration sums in another order on more),
# as the harness gave them when it still chose networks by a named
# architecture.
DIGESTS = {
    2147483901: (
        "a34af73f7c2af30525c9ad6db6fb18d1065a0384b1631cb1ebaf0d3a027dcb1a",
        "101d85fba1e4af09141998e6b3112144770c67bebe8e15d20320f6d5aa0b6556",
        "369734279eb70175b8b6b404fa14c5eaceed0530df00320e6dd587a1a7e79f68"),
    1: (
        "bf6a37be3b3f3ce8fc7d8b5cdb78b2807e44aeabb19e4457d56edaf930b377f8",
        "89385d3c6cc4392392335e1ca804f53e2d4d9f5da43518a31e538d299e54766c",
        "33670bc28c9225c2be8f5d89632f1372f6b0fa78f3ed996bff71dc699b50cade"),
}
FRAMES = {
    2147483901:
        "fbf7efc18eecf7291c8e8b5e62e2ae11a5c5e96dab000b537506707ca6301ef4",
    1: "a260d320f6d7f838aab24a805a96b6bf12e30b522b3457912e41e2240a24c1d4",
}


def digest(state):
    h = hashlib.sha256()
    for k, v in state.items():
        assert v.dtype == torch.float32, k
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(DIGESTS))
def test_the_seeded_weights_and_frames_are_unchanged(seed):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = run.settings_of(minicell.MINI_CONFIG, minicell.MINI_TRAFFIC)
        pool = gen.frame_pool(seed, 4, 1, (120, 160), "cpu")
        models = gen.reference_networks(minicell.MINI_CONFIG, seed, "cpu",
                                        torch.from_numpy(pool[0, 0]), s)
    finally:
        torch.set_num_threads(threads)
    assert hashlib.sha256(pool.tobytes()).hexdigest() == FRAMES[seed]
    assert tuple(digest(m.state_dict()) for m in models) == DIGESTS[seed]


class Uncovered(nn.Module):
    """A dense layer the recipe knows, a table and an index it does not."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 4)
        self.table = nn.Parameter(torch.empty(3, 4))
        self.register_buffer("index", torch.empty(3, dtype=torch.long))


class Covered(Uncovered):
    def seed_(self, generator):
        self.table.copy_(torch.randn(self.table.shape, generator=generator))
        self.index.copy_(torch.arange(3))


def test_a_tensor_no_rule_writes_is_an_error():
    with torch.device("meta"):
        model = Uncovered()
    with pytest.raises(ValueError, match=r"\['index', 'table'\]"):
        gen.init_weights([model], 3, "cpu")


def test_a_seed_hook_covers_what_the_recipe_does_not():
    with torch.device("meta"):
        model = Covered()
    gen.init_weights([model], 3, "cpu")
    assert model.index.tolist() == [0, 1, 2]
    assert model.table.isfinite().all() and model.Dense_0.bias.eq(0).all()


def test_a_traffic_that_sets_an_embedding_width_is_an_error(
        tmp_path, monkeypatch):
    tracker = dict(minicell.MINI_TRAFFIC["tracker"], body_feature_dim=256)
    args = minicell.make(tmp_path, monkeypatch, traffic={"tracker": tracker})
    with pytest.raises(ValueError) as err:
        run.run(args, device_kind="cpu")
    text = str(err.value)
    assert "body_feature_dim" in text
    assert "configs/mini.json" in text and "traffic/mini.json" in text


def test_the_embedding_widths_come_from_the_networks():
    """Each encoder's ``feature_dim``: 2048 and 256 as published, the
    miniature body's 4 x its last stage, and what a constructor argument
    makes the face's; each the width of the encoder's output."""
    cfg = registry.config("yolox_x-mot17_sbs_s50_256")
    traffic = registry.traffic("loaded.1stream")
    s = run.settings_of(cfg, traffic)
    assert (s.body_feature_dim, s.face_feature_dim) == (2048, 256)
    mini = copy.deepcopy(minicell.MINI_CONFIG)
    mini["models"]["face"]["args"]["feature_dim"] = 128
    dims = networks.feature_dims(mini)
    assert dims == {"body_feature_dim": 256, "face_feature_dim": 128}
    for name, hw in (("body", (64, 32)), ("face", (32, 32))):
        with torch.no_grad():
            out = networks.reference_network(mini["models"][name])(
                torch.zeros((1, *hw, 3), device="meta"))
        assert out.shape == (1, dims[f"{name}_feature_dim"])


@pytest.mark.parametrize("spec, prefix", [
    ("botsort_tpu_torch.models.yolox:YOLOX", networks.REFERENCE),
    ("portbench.reference.nets:YOLOX", networks.PROGRAM),
    ("portbench.reference.nets", networks.REFERENCE),
    ("portbench/reference/nets.py:YOLOX", networks.REFERENCE),
])
def test_a_class_is_named_only_under_its_prefix(spec, prefix):
    with pytest.raises(ValueError):
        networks.split(spec, prefix)


def test_the_committed_configurations_name_their_networks():
    for c in registry.benchmark()["configs"]:
        cfg = registry.config(c["name"])
        assert "arch" not in cfg
        assert set(cfg["models"]) == set(networks.NETWORKS)
        for entry in cfg["models"].values():
            networks.split(entry["program"], networks.PROGRAM)
            networks.split(entry["reference"], networks.REFERENCE)
            assert set(entry) <= {"program", "reference", "args",
                                  "float32_norms"}
