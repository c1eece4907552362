"""The port's ONNX importer against tools/import_onnx.py.

Both importers read the same wire bytes (written with tools/onnx_lite's
writer, or with the port's, which emits the same bytes) and the port's
checkpoint must equal runtime/from_flax.py applied to the JAX importer's
tree, every tensor bit for bit: the MINI networks, the fused and partly
fused layouts, the Focus remap, Gemm's ``transB`` variants and the
detector's post tail. The port's execution order equals the JAX one at
full scale; the report lines (fused norms, unmatched layers under
``--lenient``) and the refusals are the same. Outputs of the loaded MINI
bundle equal the JAX models' at tests/test_torch_models.py's tolerance
(rtol/atol 1e-4: float32 on both sides, two libraries' summation orders).
chip_smoke.py's release-layout writers are held to the JAX tests' here.
The full-scale round trip is ``slow``, as the JAX one is.
"""

import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import unflatten_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import import_onnx as jimp  # noqa: E402

from botsort_tpu.models import FaceReID, FastReIDSBS, YOLOX  # noqa: E402
from botsort_tpu.models.fastreid import preprocess as jpreprocess  # noqa: E402
from botsort_tpu.runtime.assets import MINI as JMINI  # noqa: E402
from botsort_tpu_torch.cli import import_onnx as cli  # noqa: E402
from botsort_tpu_torch.models.fastreid import preprocess as tpreprocess  # noqa: E402,E501
from botsort_tpu_torch.runtime import assets as tassets  # noqa: E402
from botsort_tpu_torch.runtime import import_onnx as timp  # noqa: E402
from botsort_tpu_torch.runtime import onnx_lite as tlite  # noqa: E402
from botsort_tpu_torch.runtime.from_flax import load_flax_variables  # noqa: E402,E501
from tests.test_import_adversarial import (  # noqa: E402
    _encode_with_tail,
    _fold_bn_layers,
)
from tests.test_import_fullscale import _feature_tail  # noqa: E402
from tests.test_import_mapping import synth_onnx_layers  # noqa: E402
from tests.test_onnx_lite import encode_model_from_layers  # noqa: E402
from tools import onnx_lite as jlite  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("yolox", "fastreid", "facereid")
FILES = {"yolox": tassets.DEFAULT_DETECTOR,
         "fastreid": tassets.DEFAULT_BODY_REID,
         "facereid": tassets.DEFAULT_FACE_REID}
# The JAX full-scale tests' trace sizes (tests/test_import_fullscale.py).
TRACE_HW = {"yolox": (96, 128), "fastreid": (64, 32),
            "facereid": (128, 128)}
JMODELS = {"yolox": lambda: YOLOX(**JMINI["detector"], dtype=jnp.float32),
           "fastreid": lambda: FastReIDSBS(**JMINI["body"],
                                           dtype=jnp.float32),
           "facereid": lambda: FaceReID(**JMINI["face"], dtype=jnp.float32)}


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """One intra-op thread, and a fresh jit cache around the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    yield
    jax.clear_caches()
    torch.set_num_threads(n)


def _random_params(name, seed, mini=True, hw=None):
    """(flax model, sample, variables, ordered entries): the JAX tool's
    network with every leaf drawn from ``seed`` (variances and scales in
    [0.5, 1.5], the rest normal(0, 0.05)) but GeM's exponent, which no
    graph holds: it keeps its init, 3, as the port's does."""
    model, sample = jimp.build_model(name, mini=mini, input_hw=hw)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), sample)
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        keys = "/".join(str(getattr(p, "key", p)) for p in path).lower()
        if keys.endswith("/p"):
            arr = np.asarray(leaf)
        elif "var" in keys or "scale" in keys:
            arr = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        else:
            arr = rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        leaves.append(arr)
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    return model, sample, params, jimp.ordered_flax_entries(model, sample,
                                                            params)


def _jax_import(name, path, mini=True, strict=True, hw=None):
    """tools/import_onnx.py::main up to its checkpoint, in memory: (the
    rebuilt variable tree as numpy, the assignments, the report)."""
    model, sample = jimp.build_model(name, mini=mini, input_hw=hw)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), sample)
    nodes, init = jimp.load_onnx_graph(path)
    layers = jimp.extract_onnx_layers(nodes, init)
    entries = jimp.ordered_flax_entries(model, sample, params)
    assigned, report = jimp.assign(entries, layers, strict=strict,
                                   fused_bn_eps=jimp.BN_EPS[name])
    flat = dict(entries)
    flat.update(assigned)
    tree = unflatten_dict({tuple(k.split("/")): np.asarray(v)
                           for k, v in flat.items()})
    return tree, assigned, report


def _port_import(name, path, mini=True, strict=True, hw=None):
    model, sample = timp.build_model(name, mini=mini, input_hw=hw)
    return timp.import_state(model, sample, str(path), timp.BN_EPS[name],
                             strict=strict)


def _from_flax(name, tree, mini=True):
    model, _ = timp.build_model(name, mini=mini, input_hw=(32, 32))
    load_flax_variables(model, tree)
    return model.state_dict()


def flax_key(key):
    """The JAX tool's leaf path of a port state-dict key (the modules carry
    the Flax names)."""
    *mods, leaf = key.split(".")
    bn = mods[-1].startswith("BatchNorm_")
    coll = "batch_stats" if leaf.startswith("running_") else "params"
    leaf = {"weight": "scale" if bn else "kernel", "running_mean": "mean",
            "running_var": "var"}.get(leaf, leaf)
    return "/".join([coll] + mods + [leaf])


def _in_flax_terms(lines):
    """Port report lines in the JAX tool's words."""
    out = []
    for line in lines:
        parts = line.replace(" model ", " flax ").split(" ")
        out.append(" ".join(flax_key(p) if p.endswith(".weight") else p
                            for p in parts))
    return out


def assert_states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k].float()), k


def _write(tmp_path, fname, data):
    path = tmp_path / fname
    path.write_bytes(data)
    return str(path)


# ------------------------------------------------------------ wire format

def _wire_sample(lite):
    """Bytes of ``lite``'s writer: every dtype the reader knows, int64
    attributes (a negative one too), named and unnamed nodes."""
    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.normal(size=(3, 2, 2)).astype(np.float32),
        "f16": rng.normal(size=(5,)).astype(np.float16),
        "i64": np.asarray([-3, 0, 2 ** 40, -(2 ** 62)], np.int64),
        "i32": np.asarray([[1, -2], [3, 4]], np.int32),
        "u8": np.arange(6, dtype=np.uint8).reshape(2, 3),
        "i8": np.asarray([-128, 0, 127], np.int8),
        "b": np.asarray([True, False]),
        "f64": rng.normal(size=(2, 2)),
        "scalar": np.float32(2.5),
    }
    inits = [lite.encode_tensor(k, v) for k, v in arrays.items()]
    nodes = [lite.encode_node("Conv", ["x", "f32", "f16"], ["y"],
                              name="conv_0"),
             lite.encode_node("Gemm", ["y", "f32"], ["z"], name="gemm",
                              int_attrs={"transB": 1, "axis": -7}),
             lite.encode_node("Identity", ["i64"], ["i64_id"]),
             lite.encode_node("Relu", ["z"], ["out"], name="r")]
    return lite.encode_model(nodes, inits, graph_name="wire"), arrays


def test_writer_emits_the_tools_writers_bytes():
    ours, _ = _wire_sample(tlite)
    theirs, _ = _wire_sample(jlite)
    assert ours == theirs
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 8, 3, 3)).astype(np.float32)
    assert tlite.encode_tensor("w", w) == jlite.encode_tensor("w", w)
    assert (tlite.encode_node("Gemm", ["a", "b"], ["c"],
                              int_attrs={"transB": 0})
            == jlite.encode_node("Gemm", ["a", "b"], ["c"],
                                 int_attrs={"transB": 0}))


def _packed_fields_model():
    """Hand-built fields the writers never emit: packed float_data,
    int64_data, int32_data and double_data, float and int attributes."""
    e = jlite
    t_float = (e._tag(1, 0) + e._varint(3) + e._tag(2, 0) + e._varint(1)
               + e._len_field(4, np.asarray([1.5, -2.0, 3.25],
                                            "<f4").tobytes())
               + e._len_field(8, b"pf"))
    t_i64 = (e._tag(1, 0) + e._varint(2) + e._tag(2, 0) + e._varint(7)
             + e._len_field(7, e._varint(5) + e._varint(-9))
             + e._len_field(8, b"pi64"))
    t_i32 = (e._tag(1, 0) + e._varint(2) + e._tag(2, 0) + e._varint(6)
             + e._tag(5, 0) + e._varint(4) + e._tag(5, 0) + e._varint(11)
             + e._len_field(8, b"pi32"))
    t_f64 = (e._tag(1, 0) + e._varint(1) + e._tag(2, 0) + e._varint(11)
             + e._tag(10, 1) + np.asarray([0.125], "<f8").tobytes()
             + e._len_field(8, b"pf64"))
    attr_f = (e._len_field(1, b"alpha") + e._tag(2, 5)
              + np.asarray([0.5], "<f4").tobytes())
    attr_fl = (e._len_field(1, b"scales")
               + e._len_field(7, np.asarray([1.0, 2.0], "<f4").tobytes()))
    attr_in = (e._len_field(1, b"pads")
               + e._len_field(8, e._varint(1) + e._varint(-1)))
    node = (e._len_field(1, b"x") + e._len_field(2, b"y")
            + e._len_field(4, b"Resize") + e._len_field(5, attr_f)
            + e._len_field(5, attr_fl) + e._len_field(5, attr_in))
    graph = (e._len_field(1, node) + e._len_field(2, b"packed")
             + b"".join(e._len_field(5, t)
                        for t in (t_float, t_i64, t_i32, t_f64)))
    return e._tag(1, 0) + e._varint(8) + e._len_field(7, graph)


def _summary(model):
    g = model.graph
    nodes = [(n.op_type, n.name, n.input, n.output,
              {k: (a.i, a.f, a.ints, a.floats)
               for k, a in n.attributes.items()}) for n in g.node]
    inits = [(t.name, t.dims, t.array.dtype, t.array.shape,
              t.array.tobytes()) for t in g.initializer]
    return g.name, nodes, inits


@pytest.mark.parametrize("source", ["writer", "packed"])
def test_reader_parses_like_the_tools_reader(source):
    data = (_wire_sample(jlite)[0] if source == "writer"
            else _packed_fields_model())
    ours, theirs = tlite.parse(data), jlite.parse(data)
    assert _summary(ours) == _summary(theirs)
    if source == "writer":
        _, arrays = _wire_sample(jlite)
        got = {t.name: t.array for t in ours.graph.initializer}
        for k, v in arrays.items():
            assert got[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got[k], v)
        gemm = ours.graph.node[1]
        assert gemm.attr_i("transB") == 1 and gemm.attr_i("axis") == -7
        assert ours.graph.node[2].name == ""
    else:
        got = {t.name: t.array for t in ours.graph.initializer}
        np.testing.assert_array_equal(got["pi64"], [5, -9])
        np.testing.assert_array_equal(got["pf"], [1.5, -2.0, 3.25])
        attrs = ours.graph.node[0].attributes
        assert attrs["pads"].ints == [1, -1]
        assert attrs["alpha"].f == 0.5


def test_load_onnx_graph_matches_the_tools_one(tmp_path):
    data, _ = _wire_sample(jlite)
    path = _write(tmp_path, "w.onnx", data)
    n_ours, i_ours = timp.load_onnx_graph(path)
    n_theirs, i_theirs = jimp.load_onnx_graph(path)
    assert n_ours == n_theirs
    assert i_ours.keys() == i_theirs.keys()
    for k in i_ours:
        assert i_ours[k].dtype == i_theirs[k].dtype
        np.testing.assert_array_equal(i_ours[k], i_theirs[k])


# -------------------------------------------------------- execution order

@pytest.mark.parametrize("mini", [False, True], ids=["full", "mini"])
@pytest.mark.parametrize("name", NAMES)
def test_execution_order_equals_the_jax_tools(name, mini):
    hw = None if mini else TRACE_HW[name]
    jmodel, jsample = jimp.build_model(name, mini=mini, input_hw=hw)
    want = jimp.execution_order(jmodel, jsample)
    model, sample = timp.build_model(name, mini=mini, input_hw=hw)
    got = timp.execution_order(model, sample)
    assert [p.replace(".", "/") for p in got] == want
    entries = timp.model_entries(model, got)
    assert [p for _, p in entries] == got  # the trace saw every module


# ------------------------------------------------------ MINI round trips

@pytest.fixture(scope="module")
def mini_imports(tmp_path_factory):
    """Per network: (source variables, JAX import, port import), both
    importers reading one wire file of the source's layers."""
    root = tmp_path_factory.mktemp("onnx_mini")
    out = {}
    for seed, name in enumerate(NAMES):
        _, _, params, entries = _random_params(name, seed)
        path = _write(root, FILES[name],
                      encode_model_from_layers(synth_onnx_layers(entries)))
        out[name] = (params, _jax_import(name, path),
                     _port_import(name, path))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_mini_round_trip_equals_the_jax_importer(mini_imports, name):
    params, (tree, assigned, jreport), (state, report, n) = \
        mini_imports[name]
    assert report == jreport == []
    assert n == len(assigned)
    assert_states_equal(state, _from_flax(name, tree))
    # A complete import reconstructs the source.
    assert_states_equal(state, _from_flax(name, params))


def test_mini_bundle_loads_and_matches_jax(mini_imports, tmp_path, capsys):
    for name in NAMES:
        tassets.save_state_dict(
            tassets.checkpoint_path(str(tmp_path), FILES[name]),
            mini_imports[name][2][0])
    capsys.readouterr()
    tb = tassets.build_bundle(weights_dir=str(tmp_path), mini=True, seed=3,
                              device="cpu", dtype=torch.float32)
    assert "WARNING" not in capsys.readouterr().err
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    crops = rng.integers(0, 255, (3, 64, 32, 3)).astype(np.uint8)
    faces = rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    src = {n: mini_imports[n][0] for n in NAMES}
    want_b, want_s = JMODELS["yolox"]().apply(src["yolox"], jnp.asarray(img))
    with torch.no_grad():
        got_b, got_s = tb.detector(torch.from_numpy(img))
        got_body = tb.body_encoder(tpreprocess(torch.from_numpy(crops)))
        got_face = tb.face_encoder(torch.from_numpy(faces))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(
        got_body.numpy(), np.asarray(JMODELS["fastreid"]().apply(
            src["fastreid"], jpreprocess(jnp.asarray(crops)))), **TOL)
    np.testing.assert_allclose(
        got_face.numpy(), np.asarray(JMODELS["facereid"]().apply(
            src["facereid"], jnp.asarray(faces))), **TOL)


# ----------------------------------------------------- adversarial cases

def _both(name, path, strict=True):
    tree, assigned, jreport = _jax_import(name, path, strict=strict)
    state, report, n = _port_import(name, path, strict=strict)
    return tree, assigned, jreport, state, report, n


@pytest.mark.parametrize("name", ["facereid", "fastreid"])
def test_fused_bn_equals_the_jax_importer(tmp_path, name):
    """Fully fused (the face network: every norm follows a conv) and
    partly fused (FastReID: the BNNeck and SplAt's norms after dense
    layers stay real BN nodes) exports."""
    eps = jimp.BN_EPS[name]
    _, _, _, entries = _random_params(name, 7)
    fused = _fold_bn_layers(entries, eps)
    n_real = sum(1 for k, _ in fused if k == "bn")
    assert (n_real == 0) == (name == "facereid")
    path = _write(tmp_path, "fused.onnx", encode_model_from_layers(fused))
    tree, _, jreport, state, report, _ = _both(name, path)
    assert report == jreport
    assert len(report) == 1 and report[0].startswith(
        "fused Conv+BN export detected")
    assert report[0].endswith(f"{n_real} real BN nodes kept")
    assert_states_equal(state, _from_flax(name, tree))
    # The identity norms: rsqrt(var + eps) == 1 in the port's formula.
    for key, v in state.items():
        if key.endswith("running_var") and torch.all(v == 1.0 - eps):
            mod = key[:-len(".running_var")]
            assert torch.all(torch.rsqrt(v + eps) == 1.0), mod


def test_fused_face_matches_its_source(tmp_path):
    """The imported fused face network computes its source's function."""
    eps = jimp.BN_EPS["facereid"]
    _, _, params, entries = _random_params("facereid", 8)
    path = _write(tmp_path, "fused.onnx", encode_model_from_layers(
        _fold_bn_layers(entries, eps)))
    state, _, _ = _port_import("facereid", path)
    src, _ = timp.build_model("facereid", mini=True)
    load_flax_variables(src, params)
    got, _ = timp.build_model("facereid", mini=True)
    got.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(got(x).numpy(), src(x).numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_focus_remap_equals_the_jax_importer(tmp_path):
    """A release-style stem (3x3 over 12 space-to-depth channels) lands in
    the port's folded 6x6 conv as the JAX tool maps it, and computes the
    space-to-depth conv's function."""
    _, _, _, entries = _random_params("yolox", 9)
    layers = synth_onnx_layers(entries)
    kind, stem = layers[0]
    o = stem["kernel"].shape[0]
    assert kind == "conv" and stem["kernel"].shape == (o, 3, 6, 6)
    w3 = np.random.default_rng(2).normal(0, 0.2, (o, 12, 3, 3)).astype(
        np.float32)
    layers[0] = ("conv", dict(stem, kernel=w3))
    path = _write(tmp_path, "focus.onnx", encode_model_from_layers(layers))
    tree, _, jreport, state, report, _ = _both("yolox", path)
    assert report == jreport == []
    assert_states_equal(state, _from_flax("yolox", tree))
    w6 = torch.from_numpy(timp.focus_weight_to_conv6(w3))
    assert torch.equal(state["CSPDarknet_0.Focus_0.Conv_0.weight"], w6)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 3, 16, 20)).astype(np.float32))
    s2d = torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                     x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1)
    torch.testing.assert_close(F.conv2d(x, w6, stride=2, padding=2),
                               F.conv2d(s2d, torch.from_numpy(w3),
                                        padding=1), rtol=1e-5, atol=1e-5)


def _encode_gemm_variant(layers, trans_b):
    """The layers as wire bytes with every Gemm stored for ``trans_b``:
    0 -> (in, out), 1 -> (out, in), "absent-in-out" / "absent-out-in" ->
    that layout and no attribute (the importer guesses by shape)."""
    nodes, inits, value = [], [], "x"
    for idx, (kind, arrs) in enumerate(layers):
        out = f"t{idx}"
        w = arrs.get("kernel")
        if kind == "bn":
            names = [f"{p}{idx}" for p in ("scale", "bias", "mean", "var")]
            inits += [tlite.encode_tensor(n, arrs[p]) for n, p in zip(
                names, ("scale", "bias", "mean", "var"))]
            nodes.append(tlite.encode_node("BatchNormalization",
                                           [value] + names, [out]))
        else:
            attrs = None
            if kind == "gemm":
                # synth_onnx_layers stores (out, in).
                if trans_b in (0, "absent-in-out"):
                    w = np.transpose(w)
                if trans_b in (0, 1):
                    attrs = {"transB": trans_b}
            inits.append(tlite.encode_tensor(f"w{idx}", w))
            ins = [value, f"w{idx}"]
            if arrs.get("bias") is not None:
                inits.append(tlite.encode_tensor(f"b{idx}", arrs["bias"]))
                ins.append(f"b{idx}")
            nodes.append(tlite.encode_node(
                "Conv" if kind == "conv" else "Gemm", ins, [out],
                int_attrs=attrs))
        value = out
    return tlite.encode_model(nodes, inits)


@pytest.mark.parametrize("trans_b", [0, 1, "absent-in-out",
                                     "absent-out-in"])
def test_gemm_transb_variants(tmp_path, trans_b):
    _, _, params, entries = _random_params("facereid", 10)
    path = _write(tmp_path, "gemm.onnx", _encode_gemm_variant(
        synth_onnx_layers(entries), trans_b))
    nodes, _ = timp.load_onnx_graph(path)
    want_attr = trans_b if trans_b in (0, 1) else None
    assert [n["transB"] for n in nodes if n["op_type"] == "Gemm"] == \
        [want_attr]
    tree, _, jreport, state, report, _ = _both("facereid", path)
    assert report == jreport == []
    assert_states_equal(state, _from_flax("facereid", tree))
    assert_states_equal(state, _from_flax("facereid", params))


def test_detector_post_tail_and_identity_wrap(tmp_path):
    _, _, params, entries = _random_params("yolox", 11)
    layers = synth_onnx_layers(entries)
    path = _write(tmp_path, "det_post.onnx",
                  _encode_with_tail(layers, identity_wrap_conv=1))
    nodes, init = timp.load_onnx_graph(path)
    assert [k for k, _ in timp.extract_onnx_layers(nodes, init)] == \
        [k for k, _ in layers]
    tree, _, jreport, state, report, _ = _both("yolox", path)
    assert report == jreport == []
    assert_states_equal(state, _from_flax("yolox", tree))
    assert_states_equal(state, _from_flax("yolox", params))


# --------------------------------------------------------------- refusals

def _face_layers(seed=12):
    _, _, _, entries = _random_params("facereid", seed)
    return synth_onnx_layers(entries)


def test_lenient_lcs_reports_like_the_jax_importer(tmp_path):
    """An extra conv in the graph: both align the rest by LCS, report the
    same lines and assign the same tensors."""
    layers = _face_layers()
    extra = ("conv", {"kernel": np.ones((7, 5, 1, 1), np.float32),
                      "bias": None})
    layers.insert(4, extra)
    path = _write(tmp_path, "extra.onnx", encode_model_from_layers(layers))
    tree, assigned, jreport, state, report, n = _both("facereid", path,
                                                      strict=False)
    assert report[0].startswith("WARNING: conv count mismatch: model ")
    assert any("unmatched onnx conv: conv_4 (7, 5, 1, 1)" in line
               for line in report)
    assert _in_flax_terms(report) == jreport
    assert n == len(assigned)
    ref = _from_flax("facereid", tree)
    for key, flax_path in ((k, flax_key(k)) for k in state):
        if flax_path in assigned:
            assert torch.equal(state[key], ref[key]), key


def test_lenient_reports_unmatched_model_layers(tmp_path):
    """A graph missing a conv: the unmatched layer is the network's, named
    by its state-dict key (the JAX tool's Flax path, mapped)."""
    layers = _face_layers(13)
    del layers[5]
    path = _write(tmp_path, "short.onnx", encode_model_from_layers(layers))
    _, _, jreport, _, report, _ = _both("facereid", path, strict=False)
    assert any(line.startswith("  unmatched model conv: ")
               for line in report)
    assert _in_flax_terms(report) == jreport


def test_strict_count_mismatch_raises(tmp_path):
    layers = _face_layers()
    del layers[3]
    path = _write(tmp_path, "short.onnx", encode_model_from_layers(layers))
    with pytest.raises(ValueError, match="conv count mismatch"):
        _jax_import("facereid", path)
    with pytest.raises(ValueError, match="conv count mismatch: model "):
        _port_import("facereid", path)
    with pytest.raises(ValueError, match="re-run with --lenient"):
        cli.main(["--model", "facereid", "--mini", "--onnx", path,
                  "--out", str(tmp_path / "x.pt")])
    assert not (tmp_path / "x.pt").exists()


def test_shape_mismatch_raises(tmp_path):
    layers = _face_layers()
    kind, arrs = layers[2]
    w = arrs["kernel"]
    layers[2] = (kind, dict(arrs, kernel=np.zeros(
        (w.shape[0], w.shape[1], 5, 5), np.float32)))
    path = _write(tmp_path, "shape.onnx", encode_model_from_layers(layers))
    with pytest.raises(ValueError, match="vs onnx"):
        _jax_import("facereid", path)
    with pytest.raises(ValueError, match=r"\.weight: model .* vs onnx "):
        _port_import("facereid", path)
    with pytest.raises(ValueError, match="vs onnx"):
        cli.main(["--model", "facereid", "--mini", "--onnx", path,
                  "--out", str(tmp_path / "x.pt")])


# -------------------------------------------------------------------- CLI

def test_cli_missing_file(tmp_path, capsys):
    missing = str(tmp_path / "none.onnx")
    assert cli.main(["--model", "yolox", "--onnx", missing]) == 2
    assert f"ERROR: ONNX file not found: {missing}" in capsys.readouterr().err


def test_cli_mini_conversion_then_build_bundle(mini_imports, tmp_path,
                                               capsys):
    """The default output path is the one build_bundle looks up for the
    release name; the file is the in-memory import; --selfcheck runs."""
    _, _, params, entries = _random_params("facereid", 2)
    onnx_path = _write(tmp_path, FILES["facereid"], encode_model_from_layers(
        synth_onnx_layers(entries)))
    wdir = str(tmp_path / "weights")
    capsys.readouterr()
    assert cli.main(["--model", "facereid", "--mini", "--onnx", onnx_path,
                     "--weights_dir", wdir, "--selfcheck", "-ep",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    target = tassets.checkpoint_path(wdir, FILES["facereid"])
    assert f"wrote {target} (" in out and "tensors converted" in out
    assert "selfcheck output[0]: shape (1, 256)" in out
    saved = torch.load(target, weights_only=True)
    assert_states_equal(saved, _port_import("facereid", onnx_path)[0])
    assert_states_equal(saved, _from_flax("facereid", params))
    tb = tassets.build_bundle(weights_dir=wdir, mini=True, device="cpu",
                              dtype=torch.float32)
    err = capsys.readouterr().err
    assert err.count("WARNING: no checkpoint at") == 2
    assert target not in err
    for k, v in tb.face_encoder.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_cli_selfcheck_refuses_a_missing_card(tmp_path, monkeypatch):
    path = _write(tmp_path, "f.onnx", encode_model_from_layers(
        _face_layers()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model", "facereid", "--mini", "--onnx", path,
                  "--selfcheck"])


def _manifest_rows(text):
    rows = []
    for line in text.splitlines():
        if line.startswith("=="):
            rows.append(line.replace(" model ", " flax "))
            continue
        left, right = line[8:].split(" | ")
        key, _, sig = left.rstrip().partition(" ")
        rows.append((line[:7], flax_key(key) if key.endswith(".weight")
                     else key, sig, right))
    return rows


def test_cli_dump_manifest_matches_the_jax_tool(tmp_path, capsys):
    layers = _face_layers()
    layers.insert(2, ("conv", {"kernel": np.ones((7, 5, 1, 1), np.float32),
                               "bias": None}))
    path = _write(tmp_path, "m.onnx", encode_model_from_layers(layers))
    capsys.readouterr()
    assert cli.main(["--model", "facereid", "--mini", "--onnx", path,
                     "--dump-manifest"]) == 0
    ours = capsys.readouterr().out
    model, sample = jimp.build_model("facereid", mini=True)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), sample)
    buf = io.StringIO()
    nodes, init = jimp.load_onnx_graph(path)
    jimp.dump_manifest(jimp.ordered_flax_entries(model, sample, params),
                       jimp.extract_onnx_layers(nodes, init), file=buf)
    assert "== conv: model " in ours and "!" in ours
    assert _manifest_rows(ours) == _manifest_rows(buf.getvalue())


# ------------------------------------------------- chip_smoke's writers

def test_chip_smoke_release_layers_equal_the_jax_tests(tmp_path):
    """chip_smoke.py writes its release-layout files from the port's
    networks: its layers are synth_onnx_layers' (kind by kind, in call
    order) and its wire bytes are the JAX tests' writers'."""
    for seed, name in enumerate(NAMES):
        _, _, params, entries = _random_params(name, 20 + seed)
        model, sample = timp.build_model(name, mini=True)
        load_flax_variables(model, params)
        ours = chip_smoke.release_layers(torch, timp, model, sample)
        theirs = synth_onnx_layers(entries)
        for kind in ("conv", "bn", "gemm"):
            a = [x for k, x in ours if k == kind]
            b = [x for k, x in theirs if k == kind]
            assert len(a) == len(b), (name, kind)
            for x, y in zip(a, b):
                for part in ("kernel", "bias", "scale", "mean", "var"):
                    if y.get(part) is None:
                        assert x.get(part) is None
                    else:
                        assert x[part].dtype == y[part].dtype
                        np.testing.assert_array_equal(x[part], y[part])
        if name == "yolox":
            mine = chip_smoke.encode_release(tlite, theirs, "post",
                                             wrap_conv=1)
            assert mine == _encode_with_tail(theirs, identity_wrap_conv=1)
        else:
            mine = chip_smoke.encode_release(tlite, theirs, "feature")
            assert mine == _feature_tail(theirs)
        # The smoke's own file of the port's network imports bit for bit.
        tail = "post" if name == "yolox" else "feature"
        path = _write(tmp_path, f"{name}.onnx", chip_smoke.encode_release(
            tlite, ours, tail, wrap_conv=1 if name == "yolox" else None))
        assert_states_equal(_port_import(name, path)[0], model.state_dict())


def test_chip_smoke_fold_equals_the_jax_tests():
    eps = jimp.BN_EPS["facereid"]
    _, _, params, entries = _random_params("facereid", 30)
    model, sample = timp.build_model("facereid", mini=True)
    load_flax_variables(model, params)
    ours = chip_smoke.fold_norms(
        chip_smoke.release_layers(torch, timp, model, sample), eps)
    theirs = _fold_bn_layers(entries, eps)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (_, x), (_, y) in zip(ours, theirs):
        for part in ("kernel", "bias"):
            if y.get(part) is not None:
                np.testing.assert_array_equal(x[part], y[part])


# ------------------------------------------------------------ full scale

@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_fullscale_round_trip_bitwise(tmp_path, name):
    """The release architectures at their full layer counts and widths,
    with the releases' tails, through the CLI: every tensor of the
    checkpoint equals the source's and the JAX importer's."""
    _, _, params, entries = _random_params(name, 40, mini=False,
                                           hw=TRACE_HW[name])
    layers = synth_onnx_layers(entries)
    data = (_encode_with_tail(layers, identity_wrap_conv=1)
            if name == "yolox" else _feature_tail(layers))
    path = _write(tmp_path, FILES[name], data)
    hw = [str(v) for v in TRACE_HW[name]]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--model", name, "--onnx", path, "--weights_dir",
                         str(tmp_path), "--input-hw", *hw]) == 0
    state = torch.load(tassets.checkpoint_path(str(tmp_path), FILES[name]),
                       weights_only=True)
    tree, _, report = _jax_import(name, path, mini=False,
                                  hw=TRACE_HW[name])
    assert report == []
    assert_states_equal(state, _from_flax(name, tree, mini=False))
    assert_states_equal(state, _from_flax(name, params, mini=False))
