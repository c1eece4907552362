"""Multi-stream scale-out: N videos data-parallel over the cards.

``MeshBatchedBoTSORTPipeline`` splits the streams over the devices of a
mesh (parallel/streams.py), each device stepping its slice as one batched
step. Run from the repository root:

    python -m botsort_tpu_torch.examples.multi_stream a.mp4 b.mp4 ... \\
        [--chips N] [-ep cpu --mini]

(one slice per card by default; on the CPU, ``--chips`` slices share the
one device).
"""

from __future__ import annotations

from argparse import ArgumentParser

from botsort_tpu_torch.parallel.streams import make_mesh
from botsort_tpu_torch.pipeline.host import MeshBatchedBoTSORTPipeline
from botsort_tpu_torch.runtime.assets import build_bundle


def main(argv=None) -> int:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("videos", nargs="+")
    parser.add_argument("--chips", type=int, default=None,
                        help="Devices of the mesh (default: every card).")
    parser.add_argument("-ep", "--execution_provider", default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--mini", action="store_true")
    args = parser.parse_args(argv)

    import cv2
    import torch

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)

    device = torch.device(args.execution_provider)
    mesh = make_mesh(args.chips, device.type)
    bundle = build_bundle(weights_dir="weights", mini=args.mini,
                          device=mesh[0],
                          dtype=torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
    cfgs = dict(tracker_cfg=TrackerConfig(), nms_cfg=NMSConfig(),
                pipe_cfg=PipelineConfig())
    if args.mini:
        cfgs = dict(tracker_cfg=TrackerConfig(body_feature_dim=256,
                                              max_dets=8),
                    nms_cfg=NMSConfig(),
                    pipe_cfg=PipelineConfig(detector_input_hw=(96, 128),
                                            body_reid_input_hw=(64, 32),
                                            face_reid_input_hw=(32, 32),
                                            max_reid_batch=4))
    n = len(args.videos)
    pipeline = MeshBatchedBoTSORTPipeline(bundle, n, mesh=mesh, **cfgs)
    caps = [cv2.VideoCapture(p) for p in args.videos]
    frame_no = 0
    while True:
        frames = []
        for cap in caps:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        if len(frames) < n:
            break
        frame_no += 1
        for s, tracks in enumerate(pipeline.update(frames)):
            print(f"frame {frame_no} stream {s}: ids "
                  f"{[t.track_id for t in tracks]}")
    for cap in caps:
        cap.release()
    print(f"{frame_no} steps of {n} streams over {len(mesh)} devices")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
