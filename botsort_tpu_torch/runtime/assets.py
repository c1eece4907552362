"""Model bundles (port of botsort_tpu/runtime/assets.py).

``build_bundle`` builds the three networks at the repo's architectures —
YOLOX-X (depth 1.33, width 1.25, four classes), a body encoder and the
MobileNetV2 face encoder — or at the JAX package's MINI presets, with a
numpy-seeded random init drawn by the JAX package's ``fake_params``
recipe: conv and dense kernels normal x fan_in^-1/2, norm scales and
variances 1, biases and means 0 (GeM's exponent keeps its init, 3).
Random weights give no tracking accuracy, but non-degenerate detections
flow through every stage. The body encoder's name picks its family
(``body_encoder``): FastReID SBS-S50 (``<train>_sbs_S50_NMx3xHxW``, the
default) or TransReID (``transreid_vit_base_s<stride>_<train>_NMx3xHxW``,
models/transreid.py, whose class token, position table and camera rows
the seeded init draws normal x 0.02, LayerNorms at scale 1).

Checkpoints are torch's own format: ``{weights_dir}/{stem}.pt`` holds one
network's ``state_dict`` as float32 tensors, ``stem`` being the model
file name without its extension (the names the reference's ``-odm`` /
``-bfem`` / ``-ffem`` options take). ``build_bundle`` loads the files it
finds (``torch.load(..., weights_only=True)``) and warns on stderr about
every network left at its seeded init; ``save_bundle`` writes them.
cli/import_onnx.py turns the reference's ONNX releases into these files
(runtime/import_onnx.py), with no JAX; runtime/from_flax.py loads a Flax
variable tree into a built network, and tools/convert_orbax_to_torch.py
turns the JAX package's orbax checkpoints into these files. Fetching
checkpoints over the network is not ported.
"""

from __future__ import annotations

import math
import os
import re
import sys
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from botsort_tpu_torch.models.common import BatchNorm, cast_compute
from botsort_tpu_torch.models.facereid import FaceReID
from botsort_tpu_torch.models.fastreid import FastReIDSBS
from botsort_tpu_torch.models.transreid import TransReID
from botsort_tpu_torch.models.yolox import YOLOX
from botsort_tpu_torch.pipeline.frame_step import ModelBundle

# Reference model names; the detector's names embed NxCxHxW, the body
# ReID's its crop size.
DETECTOR_NAME_RE = re.compile(r"x(?P<h>\d+)x(?P<w>\d+)(?:_|\.)")
REID_NAME_RE = re.compile(
    r"(?P<train>mot\d+)_sbs_S50_NMx3x(?P<h>\d+)x(?P<w>\d+)")
TRANSREID_NAME_RE = re.compile(
    r"transreid_vit_base_s(?P<stride>\d+)_(?P<train>[A-Za-z0-9]+)_"
    r"NMx3x(?P<h>\d+)x(?P<w>\d+)")
DEFAULT_DETECTOR = (
    "yolox_x_body_head_hand_face_0076_0.5228_post_1x3x480x640_"
    "score015_iou080_box050.onnx")
DEFAULT_BODY_REID = "mot17_sbs_S50_NMx3x256x128_post_feature_only.onnx"
DEFAULT_FACE_REID = (
    "face-reidentification-retail-0095_NMx3x128x128_post_feature_only.onnx")

# Miniature architectures for tests (the JAX package's MINI presets).
MINI = {
    "detector": dict(num_classes=4, depth=0.33, width=0.25),
    "body": dict(stage_blocks=(1, 1, 1, 1), stage_widths=(8, 16, 32, 64),
                 stem_width=8),
    "face": dict(layout=((1, 8, 1, 1), (6, 16, 1, 2), (6, 32, 1, 2)),
                 head_width=64),
    "transreid": dict(embed_dim=64, depth=3, heads=4),
}
FULL = {
    "detector": dict(num_classes=4, depth=1.33, width=1.25),
    "body": {},
    "face": {},
}


def parse_detector_input_hw(name: str) -> Tuple[int, int]:
    m = DETECTOR_NAME_RE.search(name)
    return (int(m.group("h")), int(m.group("w"))) if m else (480, 640)


def parse_body_reid_input_hw(name: str) -> Tuple[int, int]:
    m = TRANSREID_NAME_RE.search(name) or REID_NAME_RE.search(name)
    return (int(m.group("h")), int(m.group("w"))) if m else (256, 128)


def body_encoder(name: str, mini: bool = False) -> nn.Module:
    """The body encoder a model name selects: TransReID for a
    ``transreid_vit_base_s<stride>_<train>_NMx3xHxW`` name, at the name's
    patch stride and crop size, else FastReID SBS-S50; at published
    widths or, with ``mini``, miniature ones (TransReID's at 64x32)."""
    m = TRANSREID_NAME_RE.search(name)
    if m is None:
        return FastReIDSBS(**(MINI if mini else FULL)["body"])
    hw = (64, 32) if mini else (int(m.group("h")), int(m.group("w")))
    return TransReID(stride=int(m.group("stride")), input_hw=hw,
                     **(MINI["transreid"] if mini else {}))


def seeded_init_(module: nn.Module, rng: np.random.Generator) -> nn.Module:
    """The ``fake_params`` recipe, drawn from ``rng`` in module order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, TransReID):
                m.draw_tables_(rng)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                fan_in = max(math.prod(w.shape[1:]), 1)
                draw = rng.standard_normal(tuple(w.shape), np.float32)
                w.copy_(torch.from_numpy(draw * np.float32(fan_in ** -0.5)))
                if m.bias is not None:
                    m.bias.zero_()
    return module


def perturb_norms_(module: nn.Module, rng: np.random.Generator
                   ) -> nn.Module:
    """Draw every batch norm's scale, bias, mean and variance and every
    dense bias from ``rng``, in module order: with the recipe's identity
    norms a folded batch norm (kernel K4) is a no-op, so checks of the fold
    run on perturbed norms."""
    def draw(t, lo, hi, normal):
        a = (rng.normal(lo, hi, tuple(t.shape)) if normal
             else rng.uniform(lo, hi, tuple(t.shape)))
        t.copy_(torch.from_numpy(a.astype(np.float32)))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                draw(m.weight, 0.5, 1.5, False)
                draw(m.bias, 0.0, 0.2, True)
                draw(m.running_mean, 0.0, 0.2, True)
                draw(m.running_var, 0.3, 1.8, False)
            elif isinstance(m, nn.Linear) and m.bias is not None:
                draw(m.bias, 0.0, 0.1, True)
    return module


def checkpoint_path(weights_dir: str, model_name: str) -> str:
    """``{weights_dir}/{stem}.pt`` for a model file name."""
    stem = os.path.splitext(os.path.basename(model_name))[0]
    return os.path.join(weights_dir, stem + ".pt")


def save_state_dict(path: str, state: Dict[str, torch.Tensor]) -> None:
    """Write one network's checkpoint: its state dict as float32 tensors
    on the CPU."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous()
                for k, v in state.items()}, path)


def save_bundle(bundle: ModelBundle, weights_dir: str,
                detector_name: str = DEFAULT_DETECTOR,
                body_reid_name: str = DEFAULT_BODY_REID,
                face_reid_name: str = DEFAULT_FACE_REID) -> Tuple[str, ...]:
    """Write the three networks' checkpoints where ``build_bundle`` with
    the same names and ``weights_dir`` finds them; returns the paths."""
    paths = []
    for model, name in ((bundle.detector, detector_name),
                        (bundle.body_encoder, body_reid_name),
                        (bundle.face_encoder, face_reid_name)):
        paths.append(checkpoint_path(weights_dir, name))
        save_state_dict(paths[-1], model.state_dict())
    return tuple(paths)


def build_bundle(detector_name: str = DEFAULT_DETECTOR,
                 body_reid_name: str = DEFAULT_BODY_REID,
                 face_reid_name: str = DEFAULT_FACE_REID,
                 weights_dir: str = "weights", mini: bool = False,
                 seed: int = 0, device: Any = "cuda",
                 dtype: torch.dtype = torch.bfloat16) -> ModelBundle:
    """The three networks on ``device`` (the card unless the caller asks
    for another), convolutions and dense layers in ``dtype``, with the
    checkpoints ``{weights_dir}/{stem}.pt`` of the three model names where
    they exist. A network without a checkpoint keeps its seeded init
    (``seed``) and a warning on stderr says so. ``mini`` builds the
    miniature architectures. The body encoder's family is the one its
    name gives (``body_encoder``). The names' input sizes are
    ``parse_detector_input_hw`` / ``parse_body_reid_input_hw`` of them:
    the convolutional networks take any size, so the sizes configure the
    pipeline (``PipelineConfig``); TransReID's position table is built for
    its name's crop size."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_bundle: no CUDA device; pass device='cpu' "
                           "to build the networks on the CPU")
    arch = MINI if mini else FULL
    models = (YOLOX(**arch["detector"]), body_encoder(body_reid_name, mini),
              FaceReID(**arch["face"]))
    rng = np.random.default_rng(seed)
    for model, name in zip(models, (detector_name, body_reid_name,
                                    face_reid_name)):
        seeded_init_(model, rng)  # every network draws, loaded or not
        path = checkpoint_path(weights_dir, name)
        if os.path.isfile(path):
            model.load_state_dict(
                torch.load(path, map_location="cpu", weights_only=True))
        else:
            # stderr: callers may keep stdout for their own output.
            print(f"WARNING: no checkpoint at {path}; using random init "
                  "(python -m botsort_tpu_torch.cli.import_onnx converts "
                  "the reference's ONNX releases, "
                  "tools/convert_orbax_to_torch.py the JAX package's "
                  "checkpoints)", file=sys.stderr)
        cast_compute(model.to(device), dtype).eval().requires_grad_(False)
    return ModelBundle(*models)
