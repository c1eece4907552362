"""Demo CLI: track people in a video or camera stream on an NVIDIA GPU.

The flags of botsort_tpu/cli/demo.py, with ``-ep cuda|cpu`` choosing the
device; ``cuda`` fails when no card is present. Video decoding, writing
and drawing use OpenCV, which only this entry point imports. The model
names select the input geometry and the checkpoints:
``{weights_dir}/{stem}.pt`` is loaded where it exists
(tools/convert_orbax_to_torch.py writes these files); a network without
one runs its seeded random init, with a warning. ``--gmc`` switches
camera-motion compensation on (io/gmc.py).

Run: python -m botsort_tpu_torch.cli.demo -v video.mp4 -ep cuda --headless
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.runtime import assets


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("-odm", "--object_detection_model", type=str,
                        default=assets.DEFAULT_DETECTOR,
                        help="Detector model name (sets the input size).")
    parser.add_argument("-bfem", "--body_feature_extractor_model", type=str,
                        default=assets.DEFAULT_BODY_REID,
                        help="Body ReID model name (sets the crop size).")
    parser.add_argument("-ffem", "--face_feature_extractor_model", type=str,
                        default=assets.DEFAULT_FACE_REID,
                        help="Face ReID model name.")
    parser.add_argument("-v", "--video", type=str, default="0",
                        help="Video file path or camera index.")
    parser.add_argument("-ep", "--execution_provider", type=str,
                        choices=["cuda", "cpu"], default="cuda",
                        help="Device: an NVIDIA GPU or the CPU.")
    parser.add_argument("-dvw", "--disable_video_writer", action="store_true",
                        help="Disable the output.mp4 writer.")
    parser.add_argument("-fm", "--face_mosaic", action="store_true",
                        help="Face mosaic.")
    parser.add_argument("-tc", "--track_target_classes", type=int, nargs="+",
                        default=[0, 1, 2, 3], choices=[0, 1, 2, 3],
                        help="Classes rendered/attached in outputs (0 body, "
                             "1 head, 2 hand, 3 face).")
    parser.add_argument("--weights_dir", type=str, default="weights",
                        help="Checkpoint directory: {stem}.pt per model "
                             "name.")
    parser.add_argument("--output", type=str, default="output.mp4")
    parser.add_argument("--headless", action="store_true",
                        help="No GUI window; default when no DISPLAY.")
    parser.add_argument("--max_frames", type=int, default=0,
                        help="Stop after N frames (0 = entire stream).")
    parser.add_argument("--mini", action="store_true",
                        help="Use miniature model architectures.")
    parser.add_argument("--no_reid", action="store_true",
                        help="IoU-only association: skip both ReID encoders.")
    parser.add_argument("--gmc", action="store_true",
                        help="Camera-motion compensation: a sparse "
                             "optical-flow affine per frame, applied to "
                             "the Kalman states.")
    parser.add_argument("--int8", action="store_true",
                        help="int8 body ReID (not ported yet: ROADMAP "
                             "Queue 1 item 13).")
    parser.add_argument("--int8_calib_frames", type=int, default=4,
                        help="Frames read for int8 calibration.")
    parser.add_argument("--profile", action="store_true",
                        help="Print per-stage timing averages at exit "
                             "(every stage then waits for the card).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.video.isdigit() and not os.path.isfile(args.video):
        print(f"ERROR: video file not found: {args.video}")
        return 1
    if args.int8:
        raise NotImplementedError(
            "--int8 is not ported yet (ROADMAP Queue 1 item 13)")
    if args.execution_provider == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-ep cuda: no CUDA device is available")
    device = torch.device(args.execution_provider)

    import cv2

    from botsort_tpu_torch.io.draw import draw_latency, draw_tracks
    from botsort_tpu_torch.io.video import PrefetchingCapture, make_writer
    from botsort_tpu_torch.pipeline.host import BoTSORTPipeline

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    # bfloat16 networks on the card; float32 on the CPU.
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
        enable_gmc=args.gmc,
        disable_reid=args.no_reid,
    )
    tracker_cfg = TrackerConfig(
        body_feature_dim=2048 if not args.mini else 256,
        face_feature_dim=256,
        max_dets=TrackerConfig().max_dets if not args.mini else 8,
    )
    pipeline = BoTSORTPipeline(bundle, tracker_cfg, NMSConfig(), pipe_cfg,
                               profile=args.profile)

    cap = PrefetchingCapture(args.video)
    writer = None
    if not args.disable_video_writer:
        writer = make_writer(args.output, cap.fps, cap.frame_size)
    headless = args.headless or not os.environ.get("DISPLAY")
    n = 0
    try:
        for frame in cap.frames():
            t0 = time.perf_counter()
            tracks = pipeline.update(frame)
            dt = time.perf_counter() - t0
            draw_latency(frame, dt)
            draw_tracks(frame, tracks, face_mosaic=args.face_mosaic)
            if writer is not None:
                writer.write(frame)
            if not headless:
                cv2.imshow("botsort_tpu_torch", frame)
                if cv2.waitKey(1) == 27:  # ESC
                    break
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        if writer is not None:
            writer.release()
        cap.release()
    print(f"processed {n} frames")
    if args.profile:
        for stage, ms in sorted(pipeline.timers.report().items()):
            print(f"  {stage}: {ms:.2f} ms avg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
