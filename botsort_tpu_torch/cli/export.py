"""Export the frame step's programs (port of botsort_tpu/cli/export.py).

Writes one ``torch.export`` program per (source resolution, host-dispatch
bucket pair) and a manifest (runtime/exported.py); with
``--streams S`` also the batched programs of S streams. A serving host
loads them with ``runtime.exported.load_pipeline`` /
``load_batched_pipeline`` (cli/serve.py and cli/multitrack.py
``--artifact_dir``): no model code is traced there. The weights are not
written into the programs: the host passes its own checkpoints
(``--weights_dir``), of the same architecture. ``-ep`` chooses the platform
the programs run on: a ``cuda`` program calls the hand-written kernels and
loads only on a card, a ``cpu`` program calls their plain versions.

Run: python -m botsort_tpu_torch.cli.export --out exported/ \\
         --resolutions 1080x1920 [--streams 8] [--mini] [-ep cuda]
"""

from __future__ import annotations

from argparse import ArgumentParser

import torch


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--out", required=True,
                        help="Output directory for the programs.")
    parser.add_argument("--resolutions", nargs="+", default=["1080x1920"],
                        help="Source frame HxW resolutions to export.")
    parser.add_argument("--weights_dir", type=str, default="weights")
    parser.add_argument("-ep", "--execution_provider", type=str,
                        choices=["cuda", "cpu"], default="cuda",
                        help="Platform the programs run on.")
    parser.add_argument(
        "--streams", type=int, default=0,
        help="Also export the batched programs of S streams "
             "(load_batched_pipeline, multitrack --artifact_dir); 0 = one "
             "stream only.")
    parser.add_argument("--mini", action="store_true")
    args = parser.parse_args(argv)
    if args.execution_provider == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-ep cuda: no CUDA device is available")
    device = torch.device(args.execution_provider)

    from botsort_tpu_torch.config import (
        NMSConfig,
        PipelineConfig,
        TrackerConfig,
    )
    from botsort_tpu_torch.runtime.assets import build_bundle
    from botsort_tpu_torch.runtime.exported import export_all

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    bundle = build_bundle(weights_dir=args.weights_dir, mini=args.mini,
                          device=device, dtype=dtype)
    tracker_cfg = TrackerConfig() if not args.mini else TrackerConfig(
        max_tracks=16, max_dets=8, body_feature_dim=256,
        face_feature_dim=256)
    pipe_cfg = PipelineConfig() if not args.mini else PipelineConfig(
        detector_input_hw=(96, 128), body_reid_input_hw=(64, 32),
        face_reid_input_hw=(32, 32), max_reid_batch=4)
    resolutions = [tuple(int(v) for v in r.split("x"))
                   for r in args.resolutions]
    manifest = export_all(bundle, tracker_cfg, NMSConfig(), pipe_cfg,
                          args.out, resolutions, streams=args.streams,
                          mini=args.mini)
    n = len(manifest["artifacts"]) + len(manifest["batched_artifacts"])
    print(f"wrote {n} programs + manifest to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
