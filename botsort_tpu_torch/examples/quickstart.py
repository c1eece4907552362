"""Minimal library usage: track a video file on the card.

Run from the repository root:

    python -m botsort_tpu_torch.examples.quickstart video.mp4 [-ep cpu --mini]
"""

from __future__ import annotations

from argparse import ArgumentParser

from botsort_tpu_torch.pipeline.host import BoTSORTPipeline
from botsort_tpu_torch.runtime.assets import build_bundle


def main(argv=None) -> int:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("video")
    parser.add_argument("-ep", "--execution_provider", default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--mini", action="store_true")
    args = parser.parse_args(argv)

    import cv2
    import torch

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)

    device = torch.device(args.execution_provider)
    bundle = build_bundle(weights_dir="weights", mini=args.mini,
                          device=device,
                          dtype=torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
    cfgs = (TrackerConfig(), NMSConfig(), PipelineConfig())
    if args.mini:
        cfgs = (TrackerConfig(body_feature_dim=256, max_dets=8), NMSConfig(),
                PipelineConfig(detector_input_hw=(96, 128),
                               body_reid_input_hw=(64, 32),
                               face_reid_input_hw=(32, 32),
                               max_reid_batch=4))
    tracker = BoTSORTPipeline(bundle, *cfgs)
    cap = cv2.VideoCapture(args.video)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        for t in tracker.update(frame):
            x1, y1, x2, y2 = (int(v) for v in t.tlbr)
            print(f"frame {tracker.frame_id}: id={t.track_id} "
                  f"box=({x1},{y1},{x2},{y2}) score={t.score:.2f}")
    cap.release()
    print(f"tracked {tracker.frame_id} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
