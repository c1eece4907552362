"""Post-training int8 quantization for the conv backbones (port of
botsort_tpu/models/quantize.py).

The same recipe as the JAX module, with the same functions:

- ``calibrate`` runs the unmodified model over representative inputs and
  records, per ``nn.Conv2d`` (keyed by its module path: Flax's
  ``a/b/Conv_0`` is ``a.b.Conv_0`` here), the largest |x| entering the
  conv, in float32, through forward pre-hooks. Only convolutions that run
  are found, as JAX's interceptor finds only the ``nn.Conv`` calls that
  happen; the port's networks run the JAX package's nominal lowering, so
  both find the same paths (tests/test_torch_quantize.py).
- ``quantize_params`` quantizes each calibrated conv's weight with
  per-output-channel symmetric scales ``s = max|k| / 127`` (1.0 where the
  channel is all zero), ``k8 = clip(rint(k / s), -127, 127)``: JAX's
  numbers, in PyTorch's OIHW layout instead of JAX's HWIO.
- ``QuantizedModule`` runs a copy of the module with each calibrated
  ``Conv2d`` swapped for ``Int8Conv2d``:
      x8 = clip(round(float(x) / s_x), -127, 127)      (half to even)
      y  = float(int8 convolution of x8 and k8, exact in int32)
           * (s_w * s_x)  [+ bias]   -> the module's dtype
  with ``s_x = max(amax, 1e-12) / 127`` and the multiplier formed in
  float32 first, as JAX forms it. Everything around the convolutions (the
  norms, activations, pooling, the heads) runs as before.

The int8 convolution is no Pallas kernel in the JAX package: it is XLA's
``lax.conv_general_dilated(..., preferred_element_type=int32)``. Here it is
an im2col (``F.unfold``; the int8 values are integers of at most 127, which
bfloat16 holds exactly) and one int8 GEMM per group, ``torch._int_mm``,
with int32 accumulation on both devices: a plain matrix product outside any
kernel of this repository. ``_int8_matmul`` is the only caller of that
private op; it zero-pads the product to the card's shape rules (more than
16 rows, depth and width multiples of 8), which keeps it exact.

``QuantizedModule`` needs no content hash here: JAX hashes it to ride in a
jitted function's static arguments, while the port's graph cache keys its
steps by shapes and buckets, and a quantized bundle runs through
``BoTSORTPipeline`` and the graph cache unchanged.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torch._int_mm's shape rules on the card: more than 16 rows, depth and
# width multiples of 8.
_MIN_ROWS = 17
_ALIGN = 8


def _conv_modules(module: nn.Module):
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, nn.Conv2d)]


def calibrate(module: nn.Module, batches: Iterable[Any]) -> Dict[str, float]:
    """Max |activation| entering each convolution that runs, over batches.

    batches: iterable of module inputs (each one positional argument).
    Returns {conv module path: amax} as Python floats."""
    amax: Dict[str, float] = {}

    def hook(name):
        def record(mod, args):
            x = args[0]
            if x.dim() == 4:
                v = float(x.detach().float().abs().max())
                amax[name] = max(amax.get(name, 0.0), v)
        return record

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in _conv_modules(module)]
    try:
        with torch.no_grad():
            for x in batches:
                module(x)
    finally:
        for h in handles:
            h.remove()
    return amax


def quantize_params(module: nn.Module, act_amax: Dict[str, float]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, np.ndarray]]:
    """int8 weights of every calibrated convolution, per-output-channel
    scales. Returns ({path: int8 [O, I, kh, kw] tensor on the conv's
    device}, {path: np.ndarray [O] float32 scales})."""
    qweights: Dict[str, torch.Tensor] = {}
    w_scales: Dict[str, np.ndarray] = {}
    for name, conv in _conv_modules(module):
        if name not in act_amax:
            continue
        k = conv.weight.detach().float().cpu().numpy()
        s = np.max(np.abs(k), axis=(1, 2, 3)) / 127.0
        s = np.where(s > 0, s, 1.0).astype(np.float32)
        k8 = np.clip(np.rint(k / s[:, None, None, None]), -127, 127)
        qweights[name] = torch.from_numpy(k8.astype(np.int8)).to(
            conv.weight.device)
        w_scales[name] = s
    return qweights, w_scales


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact. The one
    caller of ``torch._int_mm``: the operands are zero-padded to its shape
    rules and the result cut back."""
    m, k = a.shape
    n = b.shape[1]
    kp = -(-k // _ALIGN) * _ALIGN
    np_ = -(-n // _ALIGN) * _ALIGN
    a = _pad_to(_pad_to(a, 1, kp), 0, _MIN_ROWS).contiguous()
    # b as the transpose of a contiguous [N, K]: the column-major operand
    # the int8 GEMM takes.
    b = _pad_to(_pad_to(b.t(), 1, kp), 0, np_).contiguous().t()
    return torch._int_mm(a, b)[:m, :n]


def int8_conv2d(x8: torch.Tensor, w8: torch.Tensor, stride, padding,
                dilation, groups: int) -> torch.Tensor:
    """Exact int32 convolution of int8 x8 [N, C, H, W] and int8 w8 [O,
    C / groups, kh, kw]: im2col and one int8 GEMM per group."""
    n = x8.shape[0]
    o, cg, kh, kw = w8.shape
    if (kh, kw) == (1, 1) and tuple(padding) == (0, 0):
        xs = x8[:, :, ::stride[0], ::stride[1]]
        hout, wout = xs.shape[2], xs.shape[3]
        cols = xs.permute(0, 2, 3, 1).reshape(n * hout * wout, -1)
    else:
        # unfold has no integer kernels: the values are integers of at most
        # 127 in magnitude, which bfloat16 holds exactly.
        xf = x8.to(torch.bfloat16 if x8.is_cuda else torch.float32)
        hout = (x8.shape[2] + 2 * padding[0] - dilation[0] * (kh - 1) - 1) \
            // stride[0] + 1
        wout = (x8.shape[3] + 2 * padding[1] - dilation[1] * (kw - 1) - 1) \
            // stride[1] + 1
        cols = F.unfold(xf, (kh, kw), dilation, padding, stride)
        cols = cols.transpose(1, 2).reshape(n * hout * wout, -1).to(
            torch.int8)
    depth = cg * kh * kw
    og = o // groups
    w2 = w8.reshape(o, depth)
    out = [_int8_matmul(cols[:, g * depth:(g + 1) * depth],
                        w2[g * og:(g + 1) * og].t()) for g in range(groups)]
    y = out[0] if groups == 1 else torch.cat(out, dim=1)
    return y.reshape(n, hout, wout, o).permute(0, 3, 1, 2)


class Int8Conv2d(nn.Module):
    """A calibrated ``nn.Conv2d`` run in int8 (the module docstring's
    formula). Keeps the float weight as ``weight``: its dtype is the
    network's compute dtype, which the networks read from their first
    convolution."""

    def __init__(self, conv: nn.Conv2d, act_amax: float,
                 w_scale: np.ndarray, qweight: torch.Tensor):
        super().__init__()
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        self.weight = conv.weight
        self.bias = conv.bias
        sx = np.float32(max(act_amax, 1e-12) / 127.0)
        dev = conv.weight.device
        self.register_buffer("qweight", qweight.to(dev))
        self.register_buffer("act_scale", torch.tensor(sx, device=dev))
        self.register_buffer("out_scale", torch.from_numpy(
            np.asarray(w_scale, np.float32) * sx).to(dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x8 = torch.clamp(torch.round(x.float() / self.act_scale), -127, 127)
        y = int8_conv2d(x8.to(torch.int8), self.qweight, self.stride,
                        self.padding, self.dilation, self.groups)
        y = y.float() * self.out_scale.view(1, -1, 1, 1)
        if self.bias is not None:
            y = y + self.bias.float().view(1, -1, 1, 1)
        return y.to(self.weight.dtype)


class QuantizedModule(nn.Module):
    """A module with int8 convolution execution: a copy of ``module`` in
    which each convolution with a scale in both ``act_amax`` and
    ``w_scales`` is an ``Int8Conv2d`` (its int8 weight from
    ``quantize_params``); ``module`` itself is left as it is. Called like
    the module."""

    def __init__(self, module: nn.Module, act_amax: Dict[str, float],
                 w_scales: Dict[str, np.ndarray]):
        super().__init__()
        qweights = quantize_params(module, {
            p: v for p, v in act_amax.items() if p in w_scales})[0]
        self.module = copy.deepcopy(module)
        self.act_scale = {
            p: np.float32(max(v, 1e-12) / 127.0)
            for p, v in act_amax.items() if p in w_scales}
        self.w_scales = {p: np.asarray(s, np.float32)
                         for p, s in w_scales.items()}
        for name in self.act_scale:
            parent, _, leaf = name.rpartition(".")
            owner = self.module.get_submodule(parent) if parent \
                else self.module
            conv = getattr(owner, leaf)
            setattr(owner, leaf, Int8Conv2d(conv, act_amax[name],
                                            w_scales[name], qweights[name]))

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)


def quantize_module(module: nn.Module, batches: Iterable[Any],
                    path_filter: Optional[Callable[[str], bool]] = None
                    ) -> QuantizedModule:
    """One call: calibrate -> quantize the weights -> wrap. The port's
    modules own their weights, so this returns the ``QuantizedModule``
    alone (JAX returns it with the rewritten parameter tree).

    path_filter: optional predicate over conv module paths; convolutions it
    rejects stay in the compute dtype."""
    amax = calibrate(module, batches)
    if path_filter is not None:
        amax = {p: v for p, v in amax.items() if path_filter(p)}
    return QuantizedModule(module, amax, quantize_params(module, amax)[1])


def _mid_scope_body(path: str) -> bool:
    """The body encoder's int8 scope "mid": bottlenecks from index 3 (stages
    2-4) only, as in the JAX package."""
    m = re.search(r"SplAtBottleneck_(\d+)", path)
    return m is not None and int(m.group(1)) >= 3


def _mid_scope_detector(path: str) -> bool:
    """The detector's int8 scope "mid": not the stem, not dark2 and not the
    decoupled heads, as in the JAX package."""
    if "Focus_0" in path or "DecoupledHead_0" in path:
        return False
    if "CSPDarknet_0.ConvBN_0." in path or \
            "CSPDarknet_0.CSPLayer_0." in path:
        return False
    return True


def _resize(img: np.ndarray, hw: Tuple[int, int], device) -> torch.Tensor:
    """[H, W, 3] -> [h, w, 3] float32 by antialiased bilinear
    interpolation."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
    x = F.interpolate(x.permute(2, 0, 1)[None], size=tuple(hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return x[0].permute(1, 2, 0)


def quantize_bundle(bundle, frames: Optional[Any] = None,
                    which: Tuple[str, ...] = ("body",), pipe_cfg=None,
                    num_calib: int = 4, scope: str = "mid"):
    """Quantize the heavy CNNs of a ModelBundle for int8 serving.

    frames: [K, H, W, 3] uint8 source frames for calibration (random frames
    from ``np.random.default_rng(0)`` if None). The detector calibrates on
    the resized frames, the body encoder on preprocessed crops drawn from
    the frames with the same generator calls as the JAX package's. JAX
    resizes with ``jax.image.resize(..., "linear")``, which antialiases when
    it shrinks; this uses PyTorch's antialiased bilinear interpolation, so
    the calibration batches are close to JAX's, not equal to them. The face
    encoder stays in its compute dtype.

    which: the networks to quantize ("detector", "body"); the body encoder
    alone by default, as in the JAX package; a TransReID body is refused
    (NotImplementedError). scope: "mid" quantizes the mid-network
    convolutions only (``_mid_scope_body`` / ``_mid_scope_detector``),
    "full" every calibrated one.
    """
    from botsort_tpu_torch.config import PipelineConfig
    from botsort_tpu_torch.models.fastreid import preprocess
    from botsort_tpu_torch.models.transreid import refuse
    from botsort_tpu_torch.pipeline.frame_step import ModelBundle

    if "body" in which:
        refuse(bundle.body_encoder, "quantize_bundle's int8 body encoder")
    pipe_cfg = pipe_cfg or PipelineConfig()
    rng = np.random.default_rng(0)
    if frames is None:
        frames = rng.integers(0, 255, (num_calib, 720, 1280, 3),
                              dtype=np.uint8)
    frames = np.asarray(frames)[:num_calib]
    dev = bundle.device
    detector, body = bundle.detector, bundle.body_encoder
    if "detector" in which:
        batches = [_resize(f, pipe_cfg.detector_input_hw, dev)[None]
                   for f in frames]
        detector = quantize_module(
            detector, batches,
            path_filter=_mid_scope_detector if scope == "mid" else None)
    if "body" in which:
        bh, bw = pipe_cfg.body_reid_input_hw
        batches = []
        for f in frames:
            h, w = f.shape[:2]
            ys = rng.integers(0, max(h - bh, 1), 4)
            xs = rng.integers(0, max(w - bw, 1), 4)
            crops = torch.stack([
                _resize(f[y:y + max(bh, h // 3), x:x + max(bw, w // 4)],
                        (bh, bw), dev) for y, x in zip(ys, xs)])
            batches.append(preprocess(crops))
        body = quantize_module(
            body, batches,
            path_filter=_mid_scope_body if scope == "mid" else None)
    return ModelBundle(detector=detector, body_encoder=body,
                       face_encoder=bundle.face_encoder)
