"""TransReID, the port's attention body encoder
(botsort_tpu_torch/models/transreid.py), against the benchmark's plain
float32 reference (portbench/reference/transreid.py) on one seeded state
dict, at a miniature size on the CPU (width 64, 4 heads, depth 3, crops
64x32 and 64x40, the latter with an odd patch count); its jigsaw index
against the release's shift and shuffle; the body family chosen by name on
the normal path (build_bundle, the facade, a CLI); the refusals of the
paths written for the convolutional encoders; and no trace mark where
tracing is off. The ``cuda`` tests run the published width on the card
and skip without one."""

import dataclasses

import pytest
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.models import transreid
from botsort_tpu_torch.models.common import cast_compute
from botsort_tpu_torch.models.transreid import TransReID, jpm_index
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.runtime import assets
from botsort_tpu_torch.utils import profiling
from portbench import gen
from portbench.reference import transreid as ref_transreid

CPU = torch.device("cpu")
MINI = dict(embed_dim=64, depth=3, heads=4)
NAME = "transreid_vit_base_s12_msmt17_NMx3x256x128"
MINI_NAME = "transreid_vit_base_s12_msmt17_NMx3x64x32"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(input_hw, seed=2 ** 31 + 3, device=CPU, **args):
    """(reference, port) holding one seeded float32 state dict."""
    kw = dict(MINI, input_hw=input_hw, **args)
    with torch.device("meta"):
        ref = ref_transreid.TransReID(**kw)
    gen.init_weights([ref], seed, device)
    port = TransReID(**kw).to(device)
    port.load_state_dict(ref.state_dict())
    return ref, port.eval().requires_grad_(False)


def _crops(n, input_hw, seed=0, device=CPU):
    """ImageNet-normalised RGB crops, as fastreid.preprocess makes them."""
    g = torch.Generator().manual_seed(seed)
    bgr = torch.randint(0, 256, (n, *input_hw, 3), generator=g,
                        dtype=torch.uint8)
    return tfs.preprocess(bgr.to(device))


def _cos_gap(a, b):
    return float((1.0 - (a.double() * b.double()).sum(-1)).max())


@pytest.mark.parametrize("input_hw,patches", [((64, 32), 10),
                                              ((64, 40), 15)])
def test_float32_equals_the_reference(input_hw, patches):
    """The same float32 arithmetic in another order (one gather and one
    batch of groups against the release's concatenations and a loop;
    fused attention against softmax): equal to float32 rounding."""
    ref, port = _pair(input_hw)
    assert port.patches == patches
    x = _crops(6, input_hw)
    with torch.no_grad():
        want, got = ref(x), port(x)
    assert got.shape == (6, 5 * 64) and got.dtype == torch.float32
    assert torch.allclose(got, want, rtol=0, atol=2e-6)
    assert torch.allclose(got.norm(dim=-1), torch.ones(6), atol=1e-6)


@pytest.mark.parametrize("input_hw", [(64, 32), (64, 40)])
def test_bfloat16_close_to_the_reference(input_hw):
    """Dense layers, the patch embedding and attention in bfloat16 (8 bits
    of mantissa: each product's inputs rounded by up to 2^-9), LayerNorms
    and the residual stream in float32: 1 - cos within 4e-4 of the float32
    reference over 3 blocks (a few 1e-5 measured; the full width reads
    2.5e-5 to 3.1e-5 on the card, its float8 control 7.7e-3)."""
    ref, port = _pair(input_hw)
    cast_compute(port, torch.bfloat16)
    assert port.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert port.blocks[0].norm1.weight.dtype == torch.float32
    assert port.pos_embed.dtype == torch.float32
    x = _crops(6, input_hw, seed=1)
    with torch.no_grad():
        gap = _cos_gap(port(x), ref(x))
    assert gap < 4e-4, gap


def test_state_dict_names_and_shapes_are_the_references():
    ref, port = _pair((64, 32))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    names = set(port.state_dict())
    # The release's names, its "base." prefix dropped; block 11 and the
    # BNNecks not held.
    assert {"cls_token", "pos_embed", "sie_embed", "patch_embed.proj.weight",
            "blocks.1.attn.qkv.weight", "b1.0.mlp.fc2.bias", "b1.1.weight",
            "b2.0.norm1.weight", "b2.1.bias"} <= names
    assert not any(n.startswith("blocks.2.") for n in names)


def _published_groups(patches, shift=5, group=2, divide=4):
    """The release's shuffle_unit and cut, on token indices: features[:,
    i] is token i, the class token at 0."""
    features = torch.arange(1 + patches).view(1, -1, 1)
    begin = 1
    x = torch.cat([features[:, begin - 1 + shift:],
                   features[:, begin:begin - 1 + shift]], dim=1)
    try:
        x = x.view(1, group, -1, 1)
    except RuntimeError:
        x = torch.cat([x, x[:, -2:-1, :]], dim=1)
        x = x.view(1, group, -1, 1)
    x = torch.transpose(x, 1, 2).contiguous().view(1, -1, 1)
    length = patches // divide
    return tuple((0,) + tuple(x[0, j * length:(j + 1) * length, 0].tolist())
                 for j in range(divide))


@pytest.mark.parametrize("patches", [210, 10, 15, 209])
def test_jpm_index_is_the_published_shift_and_shuffle(patches):
    got = jpm_index(patches)
    assert got == _published_groups(patches)
    assert all(len(g) == 1 + patches // 4 for g in got)
    if patches == 210:
        # Shift 5: tokens 5..210 then 1..4; two rows of 105 read column
        # by column; 4 groups of 52, tokens 208 and 209 of the shuffle
        # dropped.
        assert got[0][:7] == (0, 5, 110, 6, 111, 7, 112)
        assert got[3][-2:] == (108, 3)


def test_a_camera_outside_the_table_is_refused():
    with pytest.raises(ValueError, match="camera"):
        TransReID(camera=15, cameras=15)


def test_build_bundle_picks_the_body_family_by_name():
    with torch.device("meta"):
        full = assets.body_encoder(NAME)
        sbs = assets.body_encoder(assets.DEFAULT_BODY_REID)
        s16 = assets.body_encoder(NAME.replace("_s12_", "_s16_").replace(
            "256x128", "384x128"))
    assert isinstance(full, TransReID) and full.feature_dim == 3840
    assert full.patches == 210 and full.pos_embed.shape == (1, 211, 768)
    assert type(sbs).__name__ == "FastReIDSBS" and sbs.feature_dim == 2048
    assert s16.patches == 24 * 8 and s16.input_hw == (384, 128)
    assert assets.parse_body_reid_input_hw(NAME + ".pt") == (256, 128)
    bundle = assets.build_bundle(body_reid_name=MINI_NAME, mini=True,
                                 seed=4, device=CPU, dtype=torch.float32)
    body = bundle.body_encoder
    assert isinstance(body, TransReID) and body.input_hw == (64, 32)
    assert body.feature_dim == 5 * 64
    assert body.blocks[0].norm1.weight.eq(1).all()
    assert 0.01 < float(body.pos_embed.std()) < 0.04
    again = assets.build_bundle(body_reid_name=MINI_NAME, mini=True, seed=4,
                                device=CPU, dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(
        body.state_dict().values(), again.body_encoder.state_dict().values()))


def test_a_cli_takes_the_embedding_width_from_the_encoder(tmp_path,
                                                          monkeypatch):
    from botsort_tpu_torch.cli import demo

    seen = {}

    class Stop(Exception):
        pass

    def recorder(bundle, tracker_cfg, *args, **kwargs):
        seen["bundle"], seen["tracker_cfg"] = bundle, tracker_cfg
        raise Stop

    monkeypatch.setattr(thost, "BoTSORTPipeline", recorder)
    vid = tmp_path / "a.mp4"
    vid.write_bytes(b"")
    with pytest.raises(Stop):
        demo.main(["-v", str(vid), "-ep", "cpu", "--mini", "--headless",
                   "-bfem", MINI_NAME + "_post_feature_only.onnx",
                   "--weights_dir", str(tmp_path)])
    assert isinstance(seen["bundle"].body_encoder, TransReID)
    assert seen["tracker_cfg"].body_feature_dim == 320


def test_the_facade_tracks_with_transreid_features():
    from tests.torch_scenes import REGIMES, TorchCountDetector, level_frames

    mini = assets.build_bundle(body_reid_name=MINI_NAME, mini=True, seed=5,
                               device=CPU, dtype=torch.float32)
    bundle = tfs.ModelBundle(TorchCountDetector(), mini.body_encoder,
                             mini.face_encoder)
    trk = TrackerConfig(
        max_tracks=16, body_feature_dim=bundle.body_encoder.feature_dim,
        face_feature_dim=256, det_score_threshold=0.05,
        track_high_thresh=0.22, track_low_thresh=0.05, new_track_thresh=0.24,
        max_dets=8)
    pipe_cfg = PipelineConfig(detector_input_hw=(96, 128),
                              body_reid_input_hw=(64, 32),
                              face_reid_input_hw=(32, 32), max_reid_batch=4,
                              compute_dtype="float32", crop_int8=False)
    pipe = thost.BoTSORTPipeline(bundle, trk, NMSConfig(
        max_boxes_per_class=8, score_threshold=0.01), pipe_cfg,
        graphs=False, trace=True)
    for t in range(3):
        pipe.update(level_frames([REGIMES["full"]], seed=t)[0])
    store = pipe.store
    feats = store.body_feat[store.det_index >= 0]
    assert store.body_feat.shape == (16, 320)
    assert feats.shape[0] == 7
    assert torch.allclose(feats.norm(dim=-1), torch.ones(7), atol=1e-5)
    # Traced: one body-encoder row a step run.
    assert len(pipe.timers.export()["body_encoder"]) == 3


@pytest.mark.parametrize("what", ["quantize", "export", "programs",
                                  "trainer"])
def test_the_convolutional_paths_refuse_transreid_by_name(what, tmp_path):
    mini = assets.build_bundle(body_reid_name=MINI_NAME, mini=True, seed=6,
                               device=CPU, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="TransReID"):
        if what == "quantize":
            from botsort_tpu_torch.models.quantize import quantize_bundle
            quantize_bundle(mini)
        elif what == "export":
            from botsort_tpu_torch.runtime import exported
            exported.export_frame_step(
                mini, TrackerConfig(body_feature_dim=320), NMSConfig(),
                PipelineConfig(), (120, 160), 4, 4)
        elif what == "programs":
            from botsort_tpu_torch.runtime import exported
            exported.Programs(str(tmp_path), mini, manifest={})
        else:
            from botsort_tpu_torch.train.reid_trainer import make_trainer
            make_trainer(mini.body_encoder, (CPU,))
    # The detector alone is still quantized with a TransReID body.
    assert transreid.refuse(mini.detector, "anything") is None


@pytest.mark.parametrize("traced", [False, True])
def test_untraced_steps_record_no_mark(traced, monkeypatch):
    """The SBS miniature's captured steps: untraced, no stage or part mark
    is recorded (so a CUDA graph gains no event node); traced, each
    capture holds the stage marks and the body encoder's pair."""
    from tests.test_torch_graphed import EagerReplayCache
    from tests.torch_scenes import REGIMES, level_frames

    made = []
    real = profiling.Marks.__init__

    def counting(self, *args, **kw):
        made.append(self)
        real(self, *args, **kw)

    monkeypatch.setattr(profiling.Marks, "__init__", counting)
    bundle = assets.build_bundle(mini=True, seed=2, device=CPU,
                                 dtype=torch.float32)
    trk = TrackerConfig(max_tracks=16, body_feature_dim=256,
                        face_feature_dim=256, max_dets=8)
    pipe_cfg = PipelineConfig(detector_input_hw=(96, 128),
                              body_reid_input_hw=(64, 32),
                              face_reid_input_hw=(32, 32), max_reid_batch=4,
                              compute_dtype="float32", crop_int8=False)
    for cfg in (pipe_cfg, dataclasses.replace(pipe_cfg,
                                              host_bucket_dispatch=False)):
        pipe = thost.BoTSORTPipeline(bundle, trk, NMSConfig(
            max_boxes_per_class=8), cfg, trace=traced)
        cache = EagerReplayCache(CPU)
        pipe._graphs = cache
        for t in range(2):
            pipe.update(level_frames([REGIMES["chunk"]], seed=t)[0])
        for entry in cache._entries.values():
            if traced:
                assert entry.marks.names == list(profiling.MARKS)
                assert [n for n, _ in entry.marks.parts] == \
                    ["body_encoder"] * 2
            else:
                assert entry.marks is None
    assert bool(made) == traced


# --- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the published width runs there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _full_pair(dev, seed=2 ** 31 + 11):
    with torch.device("meta"):
        ref = ref_transreid.TransReID()
    gen.init_weights([ref], seed, dev)
    with torch.device("meta"):
        port = TransReID()
    port.to_empty(device=dev)
    port.load_state_dict(ref.state_dict())
    return ref, cast_compute(port, torch.bfloat16).eval().requires_grad_(
        False)


@pytest.mark.cuda
def test_full_width_at_50_crops_is_close_to_the_reference(dev):
    """The published network at the loaded cell's 50 crops: bfloat16 on
    the card within the cell's body_cos_gap limit of the float32
    reference, and the crops' embeddings not near rank one."""
    from portbench import registry

    limit = registry.limits("transreid_256.loaded.1stream")["limits"][
        "body_cos_gap"]
    ref, port = _full_pair(dev)
    x = _crops(50, (256, 128), seed=3, device=dev)
    with torch.no_grad():
        want, got = ref(x), port(x)
    gap = _cos_gap(got, want)
    pair = 1.0 - want @ want.T
    off = pair[~torch.eye(50, dtype=torch.bool, device=dev)]
    print(f"body_cos_gap {gap:.3e}, median pairwise 1-cos "
          f"{float(off.median()):.4f}")
    assert gap < limit, gap
    assert float(off.median()) > 0.01


@pytest.mark.cuda
def test_graph_replay_equals_eager(dev):
    _, port = _full_pair(dev)
    x = _crops(50, (256, 128), seed=4, device=dev)
    with torch.no_grad():
        eager = port(x)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            port(x)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = port(x)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
