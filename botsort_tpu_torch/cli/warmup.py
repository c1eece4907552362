"""Build the kernels and capture every step a stream can run.

The port of botsort_tpu/cli/warmup.py. The JAX package's warm-up fills its
persistent compilation cache; the port's counterparts are the kernel
libraries, built once per source into build/ and kept across processes
(runtime/kernels.py), and the CUDA graphs of the step, which a process
captures for itself (pipeline/graphed.py; cli/serve.py ``--warmup_hw``
captures them before it serves). This command builds every kernel
(``kernels.load_all``), then runs and captures the step of every
(resolution, bucket pair) a facade can pick, with both NMS programs,
printing the time of each and the memory the card holds reserved
afterwards. With ``-ep cpu`` it runs each step eagerly once.

Run: python -m botsort_tpu_torch.cli.warmup --resolutions 1080x1920 \\
         [-ep cuda] [--mini]
"""

from __future__ import annotations

import time
from argparse import ArgumentParser

import torch


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--resolutions", nargs="+", default=["1080x1920"],
                        help="Source frame HxW resolutions to warm.")
    parser.add_argument("--weights_dir", type=str, default="weights")
    parser.add_argument(
        "-bfem", "--body_feature_extractor_model", type=str, default=None,
        help="Body ReID model name; its crop size is warmed.")
    parser.add_argument("-ep", "--execution_provider", type=str,
                        choices=["cuda", "cpu"], default="cuda",
                        help="Device: an NVIDIA GPU or the CPU.")
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
    from botsort_tpu_torch.pipeline.host import BoTSORTPipeline, warm_up
    from botsort_tpu_torch.runtime import assets, kernels

    if device.type == "cuda":
        t0 = time.perf_counter()
        kernels.load_all()
        print(f"built {len(kernels.KERNELS)} kernel libraries in "
              f"{time.perf_counter() - t0:.3f} s")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    bundle = assets.build_bundle(weights_dir=args.weights_dir,
                                 mini=args.mini, device=device, dtype=dtype)
    tracker_cfg = TrackerConfig() if not args.mini else TrackerConfig(
        max_tracks=16, max_dets=8, body_feature_dim=256,
        face_feature_dim=256)
    if args.mini:
        pipe_cfg = PipelineConfig(
            detector_input_hw=(96, 128), body_reid_input_hw=(64, 32),
            face_reid_input_hw=(32, 32), max_reid_batch=4)
    else:
        pipe_cfg = PipelineConfig(
            body_reid_input_hw=assets.parse_body_reid_input_hw(
                args.body_feature_extractor_model
                or assets.DEFAULT_BODY_REID))
    pipeline = BoTSORTPipeline(bundle, tracker_cfg, NMSConfig(), pipe_cfg)
    verb = "captured" if pipeline._graphs is not None else "ran"
    for res in args.resolutions:
        h, w = (int(v) for v in res.split("x"))
        for (b, fb, iters), dt in warm_up(pipeline, (h, w)):
            print(f"{verb} {h}x{w} buckets ({b},{fb}) NMS "
                  f"{iters or 'fixed'} in {dt:.3f} s")
    if device.type == "cuda":
        print(f"graph pool: {torch.cuda.memory_reserved(device)} bytes "
              f"reserved, {torch.cuda.max_memory_reserved(device)} at most")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
