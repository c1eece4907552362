"""Map the reference's ONNX weights onto the port's networks (port of
tools/import_onnx.py).

The reference distributes pretrained ONNX graphs (the YOLOX-X detector,
FastReID SBS-S50 and face-reidentification-retail-0095). This module pairs
their initializers with the port's state-dict entries:

  * Conv weights: ONNX OIHW is ``nn.Conv2d``'s layout, kept as is; a
    Focus-stem 3x3 conv over the 12 space-to-depth channels becomes the
    port's folded 6x6 stride-2 conv (``focus_weight_to_conv6``).
  * BatchNormalization: (scale, B, mean, var) -> the port's ``BatchNorm``
    (weight, bias, running_mean, running_var).
  * Gemm / MatMul: to ``nn.Linear``'s (out, in) by the Gemm ``transB``
    attribute (a shape guess only where the attribute is absent).

Matching is structural, as in the JAX tool: the graph's weight layers in
node order are paired with the network's Conv2d, BatchNorm and Linear
modules in call order (``execution_order``), each kind on its own, with a
shape check on every pair. Where the counts differ, ``assign`` raises, or
with ``strict=False`` aligns the shape signatures by their longest common
subsequence and reports what stayed unmatched. A graph whose BatchNorms
were folded into the convolutions gets identity norms carrying the
exported conv biases. The results equal the JAX tool's carried through
runtime/from_flax.py, tensor for tensor.

The graph is read with runtime/onnx_lite.py; nothing here imports JAX,
the ``onnx`` package or the JAX package. cli/import_onnx.py writes the
result as a checkpoint ``build_bundle`` loads.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from botsort_tpu_torch.models.common import BatchNorm
from botsort_tpu_torch.models.yolox import DecoupledHead
from botsort_tpu_torch.runtime import assets, onnx_lite

# BatchNorm epsilon per model family: the port's modules' (ConvBN 1e-3 in
# the detector, 1e-5 in both encoders), so that an identity norm made for
# a fused export is exact (see ``assign``).
BN_EPS = {"yolox": 1e-3, "fastreid": 1e-5, "facereid": 1e-5}

# Trace-sample sizes: the networks' deployment inputs, and the MINI ones.
# The execution order and the parameters do not depend on the size.
INPUT_HW = {"yolox": (480, 640), "fastreid": (256, 128),
            "facereid": (128, 128)}
MINI_INPUT_HW = {"yolox": (96, 128), "fastreid": (64, 32),
                 "facereid": (32, 32)}

# Module types the importer fills, by the kind of ONNX layer they take.
KINDS = ((nn.Conv2d, "conv"), (BatchNorm, "bn"), (nn.Linear, "dense"))


def load_onnx_graph(path: str):
    """(nodes, initializers) of an ONNX file.

    nodes: [{op_type, name, input: [...], output: [...], transB: int|None}]
    initializers: {name: np.ndarray}
    """
    model = onnx_lite.load(path)
    init = {t.name: t.array for t in model.graph.initializer}
    nodes = []
    for n in model.graph.node:
        a = n.attributes.get("transB")
        nodes.append(dict(op_type=n.op_type, name=n.name,
                          input=list(n.input), output=list(n.output),
                          transB=a.i if a is not None else None))
    return nodes, init


def extract_onnx_layers(nodes, init):
    """[(kind, arrays)] in node order; kind in {conv, bn, gemm}.

    Post-processing tails (decode, NMS, normalisation nodes, even where
    they consume constant initializers) give no layer, and an initializer
    reaching a layer through Identity nodes is chased to its source.
    """
    init = dict(init)
    changed = True
    while changed:
        changed = False
        for node in nodes:
            if (node["op_type"] == "Identity" and node["input"]
                    and node["input"][0] in init
                    and node.get("output")
                    and node["output"][0] not in init):
                init[node["output"][0]] = init[node["input"][0]]
                changed = True
    layers = []
    for node in nodes:
        op = node["op_type"]
        inputs = node["input"]
        if op == "Conv":
            w = init.get(inputs[1]) if len(inputs) > 1 else None
            if w is None:
                continue
            b = init.get(inputs[2]) if len(inputs) > 2 else None
            layers.append(("conv", {"kernel": w, "bias": b,
                                    "name": node["name"]}))
        elif op == "BatchNormalization":
            arrs = [init.get(n) for n in inputs[1:5]]
            if any(a is None for a in arrs):
                continue
            scale, bias, mean, var = arrs
            layers.append(("bn", {"scale": scale, "bias": bias,
                                  "mean": mean, "var": var,
                                  "name": node["name"]}))
        elif op in ("Gemm", "MatMul"):
            w = init.get(inputs[1]) if len(inputs) > 1 else None
            if w is None:
                continue
            b = init.get(inputs[2]) if len(inputs) > 2 else None
            # Gemm's default transB=0 stores (in, out); PyTorch's exports
            # set transB=1, (out, in). MatMul is (in, out).
            trans = node["transB"] if op == "Gemm" else 0
            layers.append(("gemm", {"kernel": w, "bias": b,
                                    "transB": trans,
                                    "name": node["name"]}))
    return layers


def focus_weight_to_conv6(w_oihw: np.ndarray) -> np.ndarray:
    """A Focus-stem 3x3 conv over 4C space-to-depth channels as the equal
    6x6 stride-2 pad-2 conv over the C raw channels
    (models/common.py::Focus).

    w_oihw: (O, 4C, 3, 3), phase blocks [tl, bl, tr, br] = row/col phases
    [(0,0), (1,0), (0,1), (1,1)] (the reference stem's concat order).
    Returns OIHW (O, C, 6, 6): tap (di, dj) of phase (pi, pj) reads the
    full-resolution offset (2(di-1)+pi, 2(dj-1)+pj) from output pixel
    (2i, 2j), which is kernel index (2di+pi, 2dj+pj) under padding 2.
    """
    o, c4, kh, kw = w_oihw.shape
    if kh != 3 or kw != 3 or c4 % 4:
        raise ValueError(f"not a Focus conv weight: {w_oihw.shape}")
    c = c4 // 4
    out = np.zeros((o, c, 6, 6), w_oihw.dtype)
    for p, (pi, pj) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        for di in range(3):
            for dj in range(3):
                out[:, :, 2 * di + pi, 2 * dj + pj] = \
                    w_oihw[:, p * c:(p + 1) * c, di, dj]
    return out


class _ReadRecorder(TorchFunctionMode):
    """Records, in first-read order, the modules whose parameters or
    buffers a torch function receives."""

    def __init__(self, owner: Dict[int, str]):
        super().__init__()
        self.owner = owner
        self.order: List[str] = []
        self._seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for x in tree_flatten((args, kwargs))[0]:
            path = self.owner.get(id(x)) if isinstance(x, torch.Tensor) \
                else None
            if path is not None and path not in self._seen:
                self._seen.add(path)
                self.order.append(path)
        return func(*args, **kwargs)


def _kind(module: nn.Module) -> Optional[str]:
    for cls, kind in KINDS:
        if isinstance(module, cls):
            return kind
    return None


def _reference_head_order(model: nn.Module, order: List[str]) -> List[str]:
    """The detector head's predictors where the reference calls them. The
    port's ``DecoupledHead`` runs a level's class predictor (``Conv_{3l}``)
    after the regression branch, as it concatenates the maps (box, obj,
    cls); the reference, and so its ONNX graph and the JAX package, runs it
    at the end of the class branch (``ConvBN_{5l+2}``)."""
    order = list(order)
    for path, m in model.named_modules():
        if not isinstance(m, DecoupledHead):
            continue
        prefix = f"{path}." if path else ""
        for lvl in range(3):
            pred = f"{prefix}Conv_{3 * lvl}"
            after = f"{prefix}ConvBN_{5 * lvl + 2}.BatchNorm_0"
            if pred in order and after in order:
                order.remove(pred)
                order.insert(order.index(after) + 1, pred)
    return order


def execution_order(model: nn.Module, sample: torch.Tensor) -> List[str]:
    """Module paths of the Conv2d, BatchNorm and Linear modules in CALL
    order, the order of the reference's forward and so of its ONNX graph's
    weights: one forward of ``sample`` on the CPU, recording which
    module's parameters or buffers each torch function reads, with the
    detector head's class predictors where the reference calls them
    (``_reference_head_order``). Reads, not module calls: the face
    encoder's head reads ``Dense_0``'s weight without calling the module.
    Trace the nominal modules (``fused_stem=False``, ``dw_mode="conv"``):
    the fused paths read their weights through folds."""
    owner = {}
    for path, m in model.named_modules():
        if _kind(m) is not None:
            for t in (*m.parameters(recurse=False),
                      *m.buffers(recurse=False)):
                owner[id(t)] = path
    recorder = _ReadRecorder(owner)
    with torch.no_grad(), recorder:
        model(sample)
    return _reference_head_order(model, recorder.order)


def model_entries(model: nn.Module, order: Sequence[str]
                  ) -> List[Tuple[str, str]]:
    """[(kind, module path)] of the Conv2d ("conv"), BatchNorm ("bn") and
    Linear ("dense") modules in ``order``; modules the trace did not see
    follow in definition order (``assign`` never pairs them by
    position)."""
    kinds = {p: _kind(m) for p, m in model.named_modules()
             if _kind(m) is not None}
    seen = [p for p in order if p in kinds]
    traced = set(seen)
    return [(kinds[p], p) for p in seen + [p for p in kinds
                                           if p not in traced]]


def _model_shape_of(kind, shape):
    """A weight's signature in the JAX tool's terms: OIHW for a conv,
    (in, out) for a dense layer, (C,) for a norm."""
    return tuple(reversed(shape)) if kind == "dense" else tuple(shape)


def _onnx_shape_of(kind, arrs):
    if kind == "bn":
        return tuple(arrs["scale"].shape)
    w = arrs["kernel"]
    if kind == "gemm" and arrs.get("transB"):
        return tuple(np.transpose(w).shape)
    return tuple(w.shape)


def _lcs_align(model_sigs, onnx_sigs):
    """Longest-common-subsequence alignment over shape signatures.

    Returns [(model_idx, onnx_idx)] for matched pairs: the fallback when
    layer counts differ (an export with an extra or a missing layer).
    Order is kept, equal-shape runs align greedily, insertions and
    deletions are skipped and reported by the caller.
    """
    n, m = len(model_sigs), len(onnx_sigs)
    lcs = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(n - 1, -1, -1):
        for j in range(m - 1, -1, -1):
            if model_sigs[i] == onnx_sigs[j]:
                lcs[i, j] = 1 + lcs[i + 1, j + 1]
            else:
                lcs[i, j] = max(lcs[i + 1, j], lcs[i, j + 1])
    pairs = []
    i = j = 0
    while i < n and j < m:
        if model_sigs[i] == onnx_sigs[j]:
            pairs.append((i, j))
            i += 1
            j += 1
        elif lcs[i + 1, j] >= lcs[i, j + 1]:
            i += 1
        else:
            j += 1
    return pairs


def assign(entries, state, onnx_layers, strict=True, fused_bn_eps=None):
    """In-order assignment with shape verification.

    entries: ``model_entries`` of the network; state: its state dict (the
    shapes, and which modules have a bias). Returns ({state-dict key:
    np.ndarray}, [report lines]). With strict=True a count mismatch
    raises; otherwise the LCS fallback aligns what it can and reports the
    rest. A shape mismatch on an aligned pair always raises; same-shape
    swaps cannot be seen by construction (check activations after the
    import: ``--selfcheck``).

    fused_bn_eps: inference exports often fold BatchNorm into the conv
    before it (convs carry biases, few or no BatchNormalization nodes).
    The port keeps explicit norms after bias-free convs, so where the graph
    has fewer norms than the network, each norm whose nearest preceding
    conv carries an exported bias gets identity parameters made up:
    weight 1, mean 0, var 1 - eps (so rsqrt(var + eps) == 1 exactly in
    ``BatchNorm``'s formula at the model's eps) and bias the conv's bias.
    """
    out = {}
    report = []

    def shape(key):
        return tuple(state[key].shape)

    def take(kind_name, model_list, onnx_list, emit):
        pairs = list(zip(range(len(model_list)), range(len(onnx_list))))
        if len(model_list) != len(onnx_list):
            msg = (f"{kind_name} count mismatch: model {len(model_list)} "
                   f"vs onnx {len(onnx_list)}")
            if strict:
                raise ValueError(msg + " — architectures differ (re-run "
                                 "with --lenient for LCS alignment, or "
                                 "--dump-manifest to inspect)")
            model_sigs = [_model_shape_of(kind_name, shape(p + ".weight"))
                          for p in model_list]
            onnx_sigs = [_onnx_shape_of(kind_name, a) for a in onnx_list]
            pairs = _lcs_align(model_sigs, onnx_sigs)
            matched_m = {i for i, _ in pairs}
            matched_o = {j for _, j in pairs}
            report.append(f"WARNING: {msg}; LCS aligned {len(pairs)}")
            for i, p in enumerate(model_list):
                if i not in matched_m:
                    report.append(f"  unmatched model {kind_name}: "
                                  f"{p}.weight {model_sigs[i]}")
            for j, a in enumerate(onnx_list):
                if j not in matched_o:
                    report.append(f"  unmatched onnx {kind_name}: "
                                  f"{a.get('name', '?')} {onnx_sigs[j]}")
        for mi, oi in pairs:
            arrs = onnx_list[oi]
            for key, w in emit(model_list[mi], arrs):
                if tuple(w.shape) != shape(key):
                    raise ValueError(
                        f"{key}: model {shape(key)} vs onnx "
                        f"{tuple(w.shape)} (onnx node "
                        f"{arrs.get('name', '?')})")
                out[key] = w

    # Convolutions: OIHW as is; a Focus-stem 3x3-over-4C conv meeting a
    # 6x6-over-C weight becomes its folded equivalent.
    convs = [p for k, p in entries if k == "conv"]
    onnx_convs = [a for k, a in onnx_layers if k == "conv"]

    def emit_conv(path, arrs):
        w = arrs["kernel"]
        ref = shape(path + ".weight")
        if (ref[2:] == (6, 6) and w.shape[2:] == (3, 3)
                and w.shape[1] == 4 * ref[1] and w.shape[0] == ref[0]):
            w = focus_weight_to_conv6(w)
        emitted = [(path + ".weight", w)]
        if arrs["bias"] is not None and path + ".bias" in state:
            emitted.append((path + ".bias", arrs["bias"]))
        return emitted

    take("conv", convs, onnx_convs, emit_conv)

    # BatchNormalization: (scale, B, mean, var) -> weight, bias,
    # running_mean, running_var.
    bns = [p for k, p in entries if k == "bn"]
    onnx_bns = [a for k, a in onnx_layers if k == "bn"]

    if (fused_bn_eps is not None and len(onnx_bns) < len(bns)
            and len(convs) == len(onnx_convs)):
        # (Partly) fused export: for each norm whose nearest PRECEDING
        # conv in call order (the blocks run conv, then norm) carries an
        # exported bias, an identity norm with that bias; the other norms
        # (FastReID's BNNeck follows pooling, so no exporter folds it)
        # take the graph's real BN nodes in order.
        position = {p: i for i, (_, p) in enumerate(entries)}
        bias_of = {p: a.get("bias") for p, a in zip(convs, onnx_convs)}
        rebuilt, n_synth = [], 0
        real_iter = iter(onnx_bns)
        claimed = set()
        for bn in bns:
            prev = [p for p in convs if position[p] < position[bn]]
            c = prev[-1] if prev else None
            if c in claimed:
                # That conv already feeds an earlier norm: this one does
                # not follow a conv (the BNNeck after pooling).
                c = None
            bias = bias_of.get(c) if c is not None else None
            n = shape(bn + ".weight")[0]
            if bias is not None and bias.shape == (n,):
                claimed.add(c)
                n_synth += 1
                rebuilt.append({
                    "scale": np.ones(n, np.float32),
                    "bias": np.asarray(bias, np.float32),
                    "mean": np.zeros(n, np.float32),
                    "var": np.full(n, 1.0 - fused_bn_eps, np.float32),
                    "name": f"synth_identity_bn<-{c}",
                })
            else:
                rebuilt.append(next(real_iter, None))
        leftover = sum(1 for _ in real_iter)
        if all(b is not None for b in rebuilt) and leftover == 0:
            onnx_bns = rebuilt
            report.append(
                f"fused Conv+BN export detected: synthesized {n_synth} "
                f"identity BatchNorm layers (eps={fused_bn_eps}) "
                f"carrying the exported conv biases; "
                f"{len(rebuilt) - n_synth} real BN nodes kept")
        else:
            report.append(
                "WARNING: fused-BN reconstruction failed (real BN nodes "
                f"left over: {leftover}); falling back to count-mismatch "
                "handling")

    def emit_bn(path, arrs):
        return [(path + ".weight", arrs["scale"]),
                (path + ".bias", arrs["bias"]),
                (path + ".running_mean", arrs["mean"]),
                (path + ".running_var", arrs["var"])]

    take("bn", bns, onnx_bns, emit_bn)

    # Gemm: to (in, out) by transB (transB=1 stores (out, in)); MatMul and
    # an attribute-free Gemm are (in, out) already, and only without the
    # attribute does a shape decide. Then (out, in), nn.Linear's layout.
    dense = [p for k, p in entries if k == "dense"]
    onnx_dense = [a for k, a in onnx_layers if k == "gemm"]

    def emit_dense(path, arrs):
        w = arrs["kernel"]
        if arrs.get("transB"):
            w = np.transpose(w)
        elif arrs.get("transB") is None:
            if tuple(w.shape) != shape(path + ".weight")[::-1]:
                w = np.transpose(w)
        emitted = [(path + ".weight", np.transpose(w))]
        if arrs.get("bias") is not None and path + ".bias" in state:
            emitted.append((path + ".bias", arrs["bias"]))
        return emitted

    take("dense", dense, onnx_dense, emit_dense)
    return out, report


def dump_manifest(entries, state, onnx_layers, file=None):
    """Print both signatures side by side for manual alignment."""
    file = file if file is not None else sys.stdout
    ours = {kind: [(f"{p}.weight", _model_shape_of(
        kind, tuple(state[p + ".weight"].shape)))
        for k, p in entries if k == kind] for kind in ("conv", "bn", "dense")}
    ours["gemm"] = ours.pop("dense")
    for kind in ("conv", "bn", "gemm"):
        mine = ours[kind]
        theirs = [(a.get("name", "?"), _onnx_shape_of(kind, a))
                  for k, a in onnx_layers if k == kind]
        print(f"== {kind}: model {len(mine)} vs onnx {len(theirs)}",
              file=file)
        for i in range(max(len(mine), len(theirs))):
            left = f"{mine[i][0]} {mine[i][1]}" if i < len(mine) else "-"
            right = (f"{theirs[i][0]} {theirs[i][1]}"
                     if i < len(theirs) else "-")
            mark = " " if (i < len(mine) and i < len(theirs)
                           and mine[i][1] == theirs[i][1]) else "!"
            print(f"{mark} [{i:3d}] {left:<60s} | {right}", file=file)


def build_model(name: str, mini: bool = False,
                input_hw: Optional[Tuple[int, int]] = None):
    """(network, trace sample): the nominal float32 network on the CPU
    with ``assets.seeded_init_`` of seed 0 (what a tensor the graph does
    not hold keeps: zero biases, identity norms), and a zero NHWC sample of
    ``input_hw`` (default: the deployment input, or the MINI one). Any
    size works: the execution order does not depend on it, so a small one
    traces faster."""
    arch = assets.MINI if mini else assets.FULL
    model = {"yolox": lambda: assets.YOLOX(**arch["detector"]),
             "fastreid": lambda: assets.FastReIDSBS(**arch["body"]),
             "facereid": lambda: assets.FaceReID(**arch["face"])}[name]()
    assets.seeded_init_(model, np.random.default_rng(0))
    model.eval().requires_grad_(False)
    hw = input_hw or (MINI_INPUT_HW if mini else INPUT_HW)[name]
    return model, torch.zeros((1,) + tuple(hw) + (3,))


def import_state(model: nn.Module, sample: torch.Tensor, onnx_path: str,
                 fused_bn_eps: float, strict: bool = True):
    """The network's state dict with the graph's weights in it, as float32
    tensors on the CPU: (state, report lines, number of tensors taken from
    the graph)."""
    nodes, init = load_onnx_graph(onnx_path)
    layers = extract_onnx_layers(nodes, init)
    entries = model_entries(model, execution_order(model, sample))
    state = {k: v.detach().to("cpu", torch.float32)
             for k, v in model.state_dict().items()}
    assignments, report = assign(entries, state, layers, strict=strict,
                                 fused_bn_eps=fused_bn_eps)
    for key, value in assignments.items():
        state[key] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))
    return state, report, len(assignments)
