"""Convert the reference's ONNX weights into the port's checkpoints (port of
tools/import_onnx.py::main).

Reads one ONNX graph (runtime/onnx_lite.py), pairs its weight layers with
the network's modules in call order (runtime/import_onnx.py) and writes
one float32 state dict with ``runtime/assets.py::save_state_dict``: to
``--out``, or by default to ``checkpoint_path(--weights_dir, <the .onnx
file name>)``, where ``build_bundle`` with the same model names finds it.
The release files' names are the default model names, so

    python -m botsort_tpu_torch.cli.import_onnx --model yolox \\
        --onnx yolox_x_body_head_hand_face_..._box050.onnx

makes ``weights/yolox_x_body_head_hand_face_..._box050.pt``. The import
runs on the CPU and needs neither JAX nor the ``onnx`` package;
``--selfcheck`` then runs the imported network on the card (``-ep cpu``:
on the CPU) over a zero input and prints its output statistics, to compare
with the ONNX model's on the same input.

Run: python -m botsort_tpu_torch.cli.import_onnx --model \\
         {yolox,fastreid,facereid} --onnx FILE [--out FILE.pt]
         [--weights_dir weights] [--dump-manifest] [--lenient] [--mini]
         [--input-hw H W] [--selfcheck [-ep cuda]]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=["yolox", "fastreid", "facereid"],
                        required=True)
    parser.add_argument("--onnx", required=True)
    parser.add_argument("--out", help="checkpoint file to write (default: "
                        "{weights_dir}/{onnx file stem}.pt)")
    parser.add_argument("--weights_dir", type=str, default="weights")
    parser.add_argument("--dump-manifest", action="store_true",
                        help="print both layer signatures and exit")
    parser.add_argument("--lenient", action="store_true",
                        help="on layer-count mismatch, LCS-align by shape "
                             "signature instead of aborting")
    parser.add_argument("--mini", action="store_true",
                        help="miniature architectures (tests)")
    parser.add_argument("--input-hw", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="trace-sample spatial dims (the import does "
                             "not depend on them; smaller is faster)")
    parser.add_argument("--selfcheck", action="store_true",
                        help="after the import, run the network on a zero "
                             "input and print output statistics (compare "
                             "against an onnxruntime run of the source "
                             "model where available)")
    parser.add_argument("-ep", "--execution_provider", type=str,
                        choices=["cuda", "cpu"], default="cuda",
                        help="Device of --selfcheck: an NVIDIA GPU or the "
                             "CPU.")
    args = parser.parse_args(argv)

    if not os.path.isfile(args.onnx):
        print(f"ERROR: ONNX file not found: {args.onnx}", file=sys.stderr)
        return 2
    if (args.selfcheck and args.execution_provider == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("-ep cuda: no CUDA device is available")

    from botsort_tpu_torch.runtime import import_onnx as imp
    from botsort_tpu_torch.runtime.assets import (checkpoint_path,
                                                  save_state_dict)

    model, sample = imp.build_model(args.model, mini=args.mini,
                                    input_hw=args.input_hw)
    if args.dump_manifest:
        nodes, init = imp.load_onnx_graph(args.onnx)
        entries = imp.model_entries(model, imp.execution_order(model, sample))
        imp.dump_manifest(entries, model.state_dict(),
                          imp.extract_onnx_layers(nodes, init))
        return 0

    state, report, n = imp.import_state(
        model, sample, args.onnx, imp.BN_EPS[args.model],
        strict=not args.lenient)
    for line in report:
        print(line, file=sys.stderr)
    out = args.out or checkpoint_path(args.weights_dir, args.onnx)
    save_state_dict(out, state)
    print(f"wrote {out} ({n} tensors converted)")

    if args.selfcheck:
        device = torch.device(args.execution_provider)
        model.load_state_dict(state)
        model.to(device)
        with torch.no_grad():
            outputs = model(sample.to(device))
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        for i, o in enumerate(outputs):
            o = o.double().cpu().numpy()
            print(f"selfcheck output[{i}]: shape {o.shape} "
                  f"mean {o.mean():.6f} std {o.std():.6f} "
                  f"absmax {np.abs(o).max():.6f}")
        print("selfcheck: compare these against the ONNX model run with "
              "onnxruntime on a zeros input to catch same-shape swaps.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
