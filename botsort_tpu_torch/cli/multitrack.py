"""Multi-stream tracking CLI: N videos stepped together on one NVIDIA GPU.

The port of botsort_tpu/cli/multitrack.py. The videos ride one card as B
streams of ``BatchedBoTSORTPipeline``: perception batched over the
streams, the B association cascades one launch of kernel K2 per step.
``-ep cuda|cpu`` chooses the device; ``cuda`` fails when no card is
present. Video decoding, writing and drawing use OpenCV, which only the
CLI entry points import. ``--weights_dir`` holds the checkpoints
(``{stem}.pt`` per default model name, runtime/assets.py); a network
without one runs its seeded random init, with a warning.

Run:
  python -m botsort_tpu_torch.cli.multitrack -v a.mp4 b.mp4 [...] \\
      -ep cuda [--output_dir out/] [--max_frames N] [--temporal T]

Writes one annotated {stem}_tracked.mp4 per input (unless -dvw) and
prints the aggregate frame rate. All videos must share one resolution;
streams that end early are fed their last frame (their tracker state
keeps coasting, outputs ignored). ``--temporal T`` steps T consecutive
frames per stream at once (``TemporalBatchedBoTSORTPipeline``): more
frames per second for T - 1 frames of added latency; a stream that ends
inside a group coasts on its last frame to the group's end and only its
real frames are written.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.runtime import assets


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("-v", "--videos", nargs="+", required=True,
                        help="Video files (one stream each; same WxH).")
    parser.add_argument("-ep", "--execution_provider", type=str,
                        choices=["cuda", "cpu"], default="cuda",
                        help="Device: an NVIDIA GPU or the CPU.")
    parser.add_argument("-dvw", "--disable_video_writer",
                        action="store_true")
    parser.add_argument("--output_dir", type=str, default=".")
    parser.add_argument("--weights_dir", type=str, default="weights",
                        help="Checkpoint directory: {stem}.pt per model "
                             "name.")
    parser.add_argument("--max_frames", type=int, default=0,
                        help="Stop after N frames per stream (0 = until "
                             "every video ends).")
    parser.add_argument("--artifact_dir", type=str, default="",
                        help="Serve from exported artifacts (not ported "
                             "yet: ROADMAP Queue 1 item 12).")
    parser.add_argument("--mini", action="store_true",
                        help="Miniature architectures (smoke tests).")
    parser.add_argument("--chips", default="1",
                        help="Cards to spread the streams over (only 1 is "
                             "ported: ROADMAP Queue 1 item 11).")
    parser.add_argument("--temporal", type=int, default=1, metavar="T",
                        help="Consecutive frames per stream per step: "
                             "T - 1 frames of added latency for a higher "
                             "frame rate.")
    parser.add_argument("--profile", action="store_true",
                        help="Print per-stage timing averages at exit "
                             "(every stage then waits for the card).")
    return parser


def _check_ported(args) -> None:
    if str(args.chips) != "1":
        raise NotImplementedError(
            "--chips other than 1 is not ported yet (ROADMAP Queue 1 "
            "item 11)")
    if args.artifact_dir:
        raise NotImplementedError(
            "--artifact_dir is not ported yet (ROADMAP Queue 1 item 12)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    for path in args.videos:
        if not os.path.isfile(path):
            print(f"ERROR: video file not found: {path}")
            return 1
    _check_ported(args)
    if args.execution_provider == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-ep cuda: no CUDA device is available")
    device = torch.device(args.execution_provider)

    import cv2

    from botsort_tpu_torch.io.draw import draw_tracks
    from botsort_tpu_torch.io.video import make_writer
    from botsort_tpu_torch.pipeline.host import (
        BatchedBoTSORTPipeline,
        TemporalBatchedBoTSORTPipeline,
    )

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    # bfloat16 networks on the card; float32 on the CPU.
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    bundle = assets.build_bundle(weights_dir=args.weights_dir,
                                 mini=args.mini, device=device, dtype=dtype)
    pipe_cfg = PipelineConfig() if not args.mini else PipelineConfig(
        detector_input_hw=(96, 128), body_reid_input_hw=(64, 32),
        face_reid_input_hw=(32, 32), max_reid_batch=4)
    tracker_cfg = TrackerConfig(
        body_feature_dim=2048 if not args.mini else 256,
        face_feature_dim=256,
        max_dets=TrackerConfig().max_dets if not args.mini else 8)
    b = len(args.videos)
    t_batch = max(1, int(args.temporal))
    if t_batch > 1:
        print(f"temporal batching: {t_batch} frames per stream per step "
              f"({t_batch - 1} frame(s) of added latency)")
        pipeline = TemporalBatchedBoTSORTPipeline(
            bundle, b, t_batch, tracker_cfg, NMSConfig(), pipe_cfg,
            profile=args.profile)
    else:
        pipeline = BatchedBoTSORTPipeline(bundle, b, tracker_cfg,
                                          NMSConfig(), pipe_cfg,
                                          profile=args.profile)

    caps = [cv2.VideoCapture(p) for p in args.videos]
    writers = [None] * b
    last = [None] * b
    live = [True] * b
    n = 0
    live_frames = 0  # frames of live streams after the first step
    t_start = None
    prev = None  # (frames[t][s], real frames per stream, tracks[t][s])

    def emit(frames, real_t, tracks):
        # A group's frames past a stream's last real one are coasting
        # copies: dropped, as the streams that have ended are.
        for tt in range(len(frames)):
            for s in range(b):
                if tt >= real_t[s]:
                    continue
                if writers[s] is None and not args.disable_video_writer:
                    stem = os.path.splitext(
                        os.path.basename(args.videos[s]))[0]
                    h, w = frames[tt][s].shape[:2]
                    writers[s] = make_writer(
                        os.path.join(args.output_dir, f"{stem}_tracked.mp4"),
                        caps[s].get(cv2.CAP_PROP_FPS) or 30.0, (w, h))
                draw_tracks(frames[tt][s], tracks[tt][s])
                if writers[s] is not None:
                    writers[s].write(frames[tt][s])

    try:
        while any(live):
            # One group: t_batch frames per stream. A stream that ends
            # inside it coasts on its last frame; real_t counts its real
            # frames.
            group, real_t = [], [0] * b
            for tt in range(t_batch):
                row = []
                for s, cap in enumerate(caps):
                    ok, f = cap.read() if live[s] else (False, None)
                    if not ok:
                        live[s] = False
                        f = last[s]
                        if f is None:
                            break
                    else:
                        real_t[s] = tt + 1
                    last[s] = f
                    row.append(f)
                if len(row) < b:
                    break
                group.append(row)
            if len(group) < t_batch or not any(real_t):
                break
            shapes = {f.shape[:2] for row in group for f in row}
            if len(shapes) > 1:
                print("ERROR: all videos must share one resolution; got "
                      f"{sorted(shapes)} (HxW).")
                if prev is not None:
                    emit(*prev)
                    prev = None
                return 1
            # Enqueue this step, then draw and encode the previous one
            # while the card works on it.
            if t_batch == 1:
                handle = pipeline.update_async(np.stack(group[0]))
            else:  # [T][B] -> [B, T, H, W, 3]
                handle = pipeline.update_async(np.stack(
                    [np.stack([group[tt][s] for tt in range(t_batch)])
                     for s in range(b)]))
            if prev is not None:
                emit(*prev)
            tracks = handle.result()
            prev = (group, real_t, [tracks] if t_batch == 1 else tracks)
            if t_start is None:
                t_start = time.perf_counter()  # the first step warms up
            else:
                live_frames += sum(real_t)
            n += 1
            if args.max_frames and n * t_batch >= args.max_frames:
                break
        if prev is not None:
            emit(*prev)
    finally:
        for wtr in writers:
            if wtr is not None:
                wtr.release()
        for cap in caps:
            cap.release()
    dt = (time.perf_counter() - t_start) if t_start else 0.0
    agg = live_frames / dt if dt > 0 else float("nan")
    print(f"processed {n} steps x {b} streams ({agg:.1f} frames/s "
          "aggregate over live streams after the first step)")
    if args.profile:
        for stage, ms in sorted(pipeline.timers.report().items()):
            print(f"  {stage}: {ms:.2f} ms avg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
