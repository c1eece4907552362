"""Export per-frame track traces (MOT challenge CSV format).

The port of botsort_tpu/cli/eval_trace.py. Runs the tracker over a video
and writes one row per (frame, track): ``frame,id,x,y,w,h,score,class,
visibility``, the format of MOT17/MOT20 evaluation (cli/eval_mot.py reads
it). The options are the demo's (``-ep cuda|cpu``, ``--mini``,
``--weights_dir``, ...), plus ``-o`` and ``-tb T``: T consecutive frames a
step through the temporal step (``TemporalBatchedBoTSORTPipeline`` at one
stream), which tracks exactly what per-frame steps track. A last group
shorter than T coasts on its last frame; only real frames are written.

Run: python -m botsort_tpu_torch.cli.eval_trace -v video.mp4 -o trace.csv \\
         -ep cuda
"""

from __future__ import annotations

import time

import torch

from botsort_tpu_torch.cli.demo import build_parser


def write_tracks(f, frame_no: int, tracks) -> None:
    for t in tracks:
        x1, y1, x2, y2 = t.tlbr
        f.write(f"{frame_no},{t.track_id},{x1:.2f},{y1:.2f},"
                f"{x2 - x1:.2f},{y2 - y1:.2f},{t.score:.4f},1,1\n")


def main(argv=None):
    parser = build_parser()
    parser.add_argument("-o", "--trace_output", type=str,
                        default="trace.csv")
    parser.add_argument(
        "-tb", "--temporal_batch", type=int, default=1,
        help="Consecutive frames per step (the temporal step; the same "
             "tracks as per-frame steps).")
    args = parser.parse_args(argv)
    if args.int8:
        raise NotImplementedError(
            "--int8 is not ported yet (ROADMAP Queue 1 item 13)")
    if args.execution_provider == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-ep cuda: no CUDA device is available")
    device = torch.device(args.execution_provider)

    import numpy as np

    from botsort_tpu_torch.config import (
        NMSConfig,
        PipelineConfig,
        TrackerConfig,
    )
    from botsort_tpu_torch.io.video import PrefetchingCapture
    from botsort_tpu_torch.pipeline.host import (
        BoTSORTPipeline,
        TemporalBatchedBoTSORTPipeline,
    )
    from botsort_tpu_torch.runtime import assets

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    bundle = assets.build_bundle(
        args.object_detection_model, args.body_feature_extractor_model,
        args.face_feature_extractor_model, weights_dir=args.weights_dir,
        mini=args.mini, device=device, dtype=dtype)
    pipe_cfg = PipelineConfig(
        detector_input_hw=assets.parse_detector_input_hw(
            args.object_detection_model) if not args.mini else (96, 128),
        body_reid_input_hw=assets.parse_body_reid_input_hw(
            args.body_feature_extractor_model) if not args.mini else (64, 32),
        face_reid_input_hw=(128, 128) if not args.mini else (32, 32),
        track_target_classes=tuple(args.track_target_classes),
        disable_reid=args.no_reid)
    tracker_cfg = TrackerConfig(
        body_feature_dim=2048 if not args.mini else 256,
        face_feature_dim=256,
        max_dets=TrackerConfig().max_dets if not args.mini else 8)
    tb = max(args.temporal_batch, 1)
    if tb == 1:
        pipeline = BoTSORTPipeline(bundle, tracker_cfg, NMSConfig(),
                                   pipe_cfg)
    else:
        pipeline = TemporalBatchedBoTSORTPipeline(
            bundle, 1, tb, tracker_cfg, NMSConfig(), pipe_cfg)

    cap = PrefetchingCapture(args.video)
    n = 0
    t0 = time.perf_counter()
    try:
        with open(args.trace_output, "w") as f:
            frames = cap.frames()
            while True:
                group = []
                for frame in frames:
                    group.append(frame)
                    if len(group) == tb or (
                            args.max_frames and n + len(group) >=
                            args.max_frames):
                        break
                if not group:
                    break
                if tb == 1:
                    out = [pipeline.update(group[0])]
                else:
                    real = len(group)
                    group += [group[-1]] * (tb - real)
                    res = pipeline.update(np.stack(group)[None])
                    out = [res[t][0] for t in range(real)]
                for tracks in out:
                    n += 1
                    write_tracks(f, n, tracks)
                if len(out) < tb or (args.max_frames
                                     and n >= args.max_frames):
                    break
    finally:
        cap.release()
    dt = time.perf_counter() - t0
    print(f"{n} frames -> {args.trace_output} "
          f"({n / max(dt, 1e-9):.1f} fps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
