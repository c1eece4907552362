#!/usr/bin/env python3
"""Convert the JAX package's orbax checkpoints to the PyTorch port's files.

    python tools/convert_orbax_to_torch.py --weights_dir weights \\
        [--out_dir weights] [--mini] [-odm NAME] [-bfem NAME] [-ffem NAME]

For each of the three model names it restores the orbax checkpoint
directory ``{weights_dir}/{stem}/`` (what
``botsort_tpu.runtime.assets.save_checkpoint`` and tools/import_onnx.py
write) as a tree of numpy arrays, loads that tree into the port's network
of the same architecture (``botsort_tpu_torch/runtime/from_flax.py``,
which checks every leaf's name and shape) and writes the network's state
dict to ``{out_dir}/{stem}.pt``, the file
``botsort_tpu_torch.runtime.assets.build_bundle(weights_dir=out_dir)``
loads. A name without a checkpoint directory is skipped with a note.

This is the one place where both packages' dependencies meet: it needs
jax and orbax (to restore) and torch (to write). It runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def restore_numpy_tree(path: str):
    """An orbax checkpoint directory as nested dicts of numpy arrays."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    restored = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), restored)


def convert(weights_dir: str, out_dir: str, names, mini: bool = False):
    """Convert the checkpoints of ``names`` = (detector, body, face) model
    names; returns the paths written."""
    import torch

    from botsort_tpu_torch.models.facereid import FaceReID
    from botsort_tpu_torch.models.fastreid import FastReIDSBS
    from botsort_tpu_torch.models.yolox import YOLOX
    from botsort_tpu_torch.runtime import assets
    from botsort_tpu_torch.runtime.from_flax import load_flax_variables

    arch = assets.MINI if mini else assets.FULL
    makers = (lambda: YOLOX(**arch["detector"]),
                lambda: FastReIDSBS(**arch["body"]),
                lambda: FaceReID(**arch["face"]))
    written = []
    for build, name in zip(makers, names):
        stem = os.path.splitext(os.path.basename(name))[0]
        src = os.path.join(weights_dir, stem)
        if not os.path.isdir(src):
            print(f"skipped {stem}: no checkpoint directory at {src}")
            continue
        with torch.no_grad():
            model = load_flax_variables(build(), restore_numpy_tree(src))
        dst = assets.checkpoint_path(out_dir, name)
        assets.save_state_dict(dst, model.state_dict())
        print(f"wrote {dst}")
        written.append(dst)
    return written


def main(argv=None) -> int:
    from botsort_tpu_torch.runtime import assets

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--weights_dir", default="weights",
                        help="Directory of the orbax checkpoints.")
    parser.add_argument("--out_dir", default=None,
                        help="Where the .pt files go (default: "
                             "--weights_dir).")
    parser.add_argument("-odm", "--object_detection_model",
                        default=assets.DEFAULT_DETECTOR)
    parser.add_argument("-bfem", "--body_feature_extractor_model",
                        default=assets.DEFAULT_BODY_REID)
    parser.add_argument("-ffem", "--face_feature_extractor_model",
                        default=assets.DEFAULT_FACE_REID)
    parser.add_argument("--mini", action="store_true",
                        help="The miniature architectures.")
    args = parser.parse_args(argv)
    written = convert(
        args.weights_dir, args.out_dir or args.weights_dir,
        (args.object_detection_model, args.body_feature_extractor_model,
         args.face_feature_extractor_model), args.mini)
    return 0 if written else 1


if __name__ == "__main__":
    raise SystemExit(main())
