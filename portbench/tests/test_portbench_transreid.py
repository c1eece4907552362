"""TransReID in the benchmark (configs/yolox_x-msmt17_transreid_s12_256.json,
reference/transreid.py): its published count, its seeded recipe, its
miniature cell run end to end on the CPU, a fault planted in it, its
control and the two readers of its layers."""

import copy
import json

import pytest
import torch

from portbench import counts, faults, gen, networks, registry, run
from portbench.reference import nets
from portbench.tests import minicell
from portbench.trace import Event

CELL = "transreid_256.loaded.1stream"
CONFIG = registry.config(registry.workload(registry.benchmark(),
                                           CELL)["config"])
BODY = CONFIG["models"]["body"]
LIMITS = registry.limits(CELL)["limits"]
MINI_ARGS = {"embed_dim": 64, "depth": 3, "heads": 4, "input_hw": [64, 32]}


def mini_body(**args):
    return dict(BODY, args=dict(BODY["args"], **MINI_ARGS, **args))


@pytest.fixture
def mini_config():
    cfg = copy.deepcopy(minicell.MINI_CONFIG)
    cfg["models"]["body"] = mini_body()
    return cfg


def published_flops():
    """40.77 GFLOP a crop at 256x128, from the layer equations: 12 blocks
    (11 shared and b1) on 211 tokens, attention's two products in each,
    b2 on 4 groups of 53 tokens, and the patch embedding's 210 patches."""
    c, heads, d, patches = 768, 12, 64, 210
    tokens, group = 1 + patches, 1 + patches // 4
    block = 2 * (c * 3 * c + c * c + 2 * c * 4 * c)   # qkv, proj, fc1, fc2
    products = lambda t: 2 * heads * t * t * 2 * d   # noqa: E731
    return (2 * c * patches * 3 * 16 * 16
            + 12 * (tokens * block + products(tokens))
            + 4 * (group * block + products(group)))


def dead_flops():
    """The published count's work that no output depends on: b1 and b2
    are read at the class token alone, so every other row's query,
    attention row, proj and MLP (210 rows of 211 keys in b1, 4 x 52 rows of
    53 keys in b2)."""
    c, patches = 768, 210
    row = 2 * (c * c + c * c + 2 * c * 4 * c)   # q, proj, fc1, fc2
    products = lambda keys: 2 * keys * 2 * c   # noqa: E731
    group = patches // 4
    return (patches * (row + products(1 + patches))
            + 4 * group * (row + products(1 + group)))


def test_the_published_count_is_exact():
    got = counts.network_counts(BODY, CONFIG["body_reid_input_hw"])
    assert published_flops() == 40_766_914_560
    assert dead_flops() == 5_100_914_688
    # counts.py counts the useful work: the published count less the rows
    # of b1 and b2 that no output reads.
    assert got["flops"] == published_flops() - dead_flops() == 35_665_999_872
    assert got["params"] == 92_910_336
    assert got["norm_bytes"] == 0  # no batch norm: K6 does not run here
    assert networks.feature_dims(CONFIG)["body_feature_dim"] == 3840


def test_seed_writes_every_tensor_the_recipe_does_not():
    model = networks.reference_network(mini_body())
    gen.init_weights([model], 2 ** 31 + 21, "cpu")
    for m in model.modules():
        if isinstance(m, torch.nn.LayerNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
    for t in (model.cls_token, model.pos_embed, model.sie_embed):
        assert t.isfinite().all() and 0.01 < t.std() < 0.04
    assert not torch.equal(model.pos_embed[0, 1], model.pos_embed[0, 2])
    # Without seed_ the tables and LayerNorms are left unwritten.
    cls = type(model)
    seed = cls.seed_
    try:
        del cls.seed_
        with pytest.raises(ValueError, match="cls_token"):
            gen.init_weights([networks.reference_network(mini_body())], 1,
                             "cpu")
    finally:
        cls.seed_ = seed


def test_the_miniature_cell_runs_and_is_correct(mini_config, tmp_path,
                                                monkeypatch, capsys):
    args = minicell.make(tmp_path, monkeypatch, limits=LIMITS,
                         config=mini_config)
    code = run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", "1", "--trace", "0"], device_kind="cpu")
    printed = capsys.readouterr()
    assert code == 0, printed.err[-2000:]
    out = json.loads(printed.out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 2
    assert out["checks"]["body_cos_gap"]["value"] < 1e-5


def test_a_half_batch_planted_in_the_encoder_fails_body_cos_gap(
        mini_config, tmp_path, monkeypatch):
    from botsort_tpu_torch.models.transreid import TransReID

    args = minicell.make(tmp_path, monkeypatch, limits=LIMITS,
                         config=mini_config)

    def make(original):
        def broken(self, images):
            out = original(self, images)
            half = max(out.shape[0] // 2, 1)
            return torch.cat([out[:half], out[:half].mean(
                dim=0, keepdim=True).expand(out.shape[0] - half, -1)])
        return broken

    with faults.patched(TransReID, "forward", make):
        out = run.run(args, device_kind="cpu")
    assert not out["correct"]
    check = out["checks"]["body_cos_gap"]
    assert check["value"] > check["limit"]


def test_the_control_rounds_attention_and_every_dense_layer():
    model = networks.reference_network(mini_body())
    gen.init_weights([model], 9, "cpu")
    x = torch.randn(3, 64, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        f32 = model(x)
        nets.set_precision(model, "fp8")
        low = model(x)
        assert model.blocks[0].attn.products.precision == "fp8"
        assert model.b2[0].mlp.fc1.precision == "fp8"
        assert (1 - (low * f32).sum(-1)).max() > 1e-4
        # The products of activations alone move the output too.
        for m in model.modules():
            if isinstance(m, (nets.QConv2d, nets.QLinear)):
                m.precision = "float32"
        assert (model(x) - f32).abs().max() > 1e-5


def ev(name, a, b, dev=True):
    return Event(name, dev, float(a), float(b))


@pytest.mark.parametrize("metric,names", [
    ("transreid.attention_device_ms",
     ["void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>",
      "fmha_cutlassF_bf16_aligned_64x128_rf_sm80(PyTorchMemEffAttention)"]),
    ("transreid.norm_act_device_ms",
     ["void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
      "<float, float>(int, float, float const*)",
      "void at::native::vectorized_elementwise_kernel<4, at::native::"
      "GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::"
      "GeluType)::{lambda()#1}>"]),
])
def test_the_readers_sum_their_kernels_by_name(metric, names):
    read = registry.metric_reader(metric)
    others = [ev("sm90_xmma_gemm_bf16bf16_bf16f32", 0, 500),
              ev("void bn_act_kernel<__nv_bfloat16, 1>", 500, 600),
              ev("void at::native::elementwise_kernel<128, 4>", 600, 650),
              ev(names[0], 0, 900, dev=False)]
    mine = [ev(names[0], 700, 800), ev(names[1], 800, 1000)]
    rec = {"events": others + mine, "profiled_updates": 2}
    assert read(rec) == pytest.approx(300 / 1e3 / 2)
    assert read(dict(rec, events=others)) is None
    assert read(dict(rec, profiled_updates=0)) is None
