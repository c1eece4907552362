"""Tracking service: frames in over TCP, track JSON out.

The port of botsort_tpu/cli/serve.py, with its protocol. Per connection
(one connection = one tracking stream with its own TrackStore):

  client -> server:  [4-byte big-endian length][encoded image bytes]
  server -> client:  [4-byte big-endian length][JSON line]

JSON: {"frame": n, "tracks": [{"id": i, "tlbr": [x1,y1,x2,y2],
"score": s, "class": 0}, ...]}. A zero-length frame closes the stream.

Connections are served one after another (one card runs one step at a
time), and their pipelines share one graph cache (pipeline/graphed.py): a
step captured for one connection is replayed for the next.
``--warmup_hw HxW`` captures every bucket pair at that resolution before
the server accepts a connection, so no client waits for a capture.
``--artifact_dir`` serves the exported programs of cli/export.py instead
of the live models. The default decoder is OpenCV's (JPEG or PNG), imported
when the server starts; ``make_handler`` takes any other.

Run: python -m botsort_tpu_torch.cli.serve --port 8700 -ep cuda \\
         [--warmup_hw 1080x1920] [--artifact_dir exported/] [--mini]
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import time
from argparse import ArgumentParser
from typing import Callable, Optional

import numpy as np
import torch


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def send_message(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def recv_message(sock: socket.socket) -> bytes:
    (length,) = struct.unpack(">I", recv_exact(sock, 4))
    return recv_exact(sock, length)


def tracks_to_json(frame_no: int, tracks) -> bytes:
    return json.dumps({
        "frame": frame_no,
        "tracks": [
            {"id": t.track_id,
             "tlbr": [round(float(v), 2) for v in t.tlbr],
             "score": round(t.score, 4), "class": 0}
            for t in tracks
        ],
    }).encode()


def cv2_decoder() -> Callable[[bytes], Optional[np.ndarray]]:
    """OpenCV's image decoder: bytes -> [H, W, 3] uint8 BGR, or None."""
    import cv2

    def decode(data: bytes) -> Optional[np.ndarray]:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)

    return decode


def make_handler(pipeline_factory,
                 decode: Optional[Callable[[bytes], Optional[np.ndarray]]]
                 = None):
    """A request handler that tracks one stream per connection with a new
    pipeline from ``pipeline_factory``; ``decode`` turns a message into a
    frame (None: OpenCV's decoder)."""
    decode = decode or cv2_decoder()

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            pipeline = pipeline_factory()
            frame_no = 0
            sock = self.request
            while True:
                try:
                    (length,) = struct.unpack(">I", recv_exact(sock, 4))
                except ConnectionError:
                    return
                if length == 0:
                    return
                img = decode(recv_exact(sock, length))
                if img is None:
                    payload = json.dumps({"error": "decode failed"}).encode()
                else:
                    frame_no += 1
                    payload = tracks_to_json(frame_no, pipeline.update(img))
                send_message(sock, payload)

    return Handler


class Server(socketserver.TCPServer):
    """Connections one after another."""

    allow_reuse_address = True


def build_pipeline_factory(args):
    """The per-connection pipeline factory of the parsed options, and the
    graph cache its pipelines share (None off the card)."""
    from botsort_tpu_torch.config import (
        NMSConfig,
        PipelineConfig,
        TrackerConfig,
    )
    from botsort_tpu_torch.pipeline.graphed import GraphCache
    from botsort_tpu_torch.pipeline.host import BoTSORTPipeline
    from botsort_tpu_torch.runtime import assets

    if args.int8:
        raise NotImplementedError(
            "--int8 is not ported yet (ROADMAP Queue 1 item 13)")
    if args.execution_provider == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-ep cuda: no CUDA device is available")
    device = torch.device(args.execution_provider)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cache = GraphCache(device) if device.type == "cuda" else None
    if args.artifact_dir:
        from botsort_tpu_torch.runtime.exported import (
            Programs,
            load_pipeline,
            read_manifest,
        )

        manifest = read_manifest(args.artifact_dir)
        bundle = assets.build_bundle(weights_dir=args.weights_dir,
                                     mini=manifest["mini"], device=device,
                                     dtype=dtype)
        # One load per program for the whole server.
        programs = Programs(args.artifact_dir, bundle, manifest)

        def factory():
            return load_pipeline(args.artifact_dir, bundle,
                                 programs=programs, graph_cache=cache)

        return factory, cache
    bundle = assets.build_bundle(weights_dir=args.weights_dir,
                                 mini=args.mini, device=device, dtype=dtype)
    pipe_cfg = PipelineConfig() if not args.mini else PipelineConfig(
        detector_input_hw=(96, 128), body_reid_input_hw=(64, 32),
        face_reid_input_hw=(32, 32), max_reid_batch=4)
    tracker_cfg = TrackerConfig(
        body_feature_dim=2048 if not args.mini else 256,
        face_feature_dim=256,
        max_dets=TrackerConfig().max_dets if not args.mini else 8)

    def factory():
        return BoTSORTPipeline(bundle, tracker_cfg, NMSConfig(), pipe_cfg,
                               graph_cache=cache)

    return factory, cache


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8700)
    parser.add_argument("-ep", "--execution_provider", type=str,
                        choices=["cuda", "cpu"], default="cuda",
                        help="Device: an NVIDIA GPU or the CPU.")
    parser.add_argument("--weights_dir", default="weights")
    parser.add_argument("--mini", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="int8 body ReID (not ported yet: ROADMAP "
                             "Queue 1 item 13).")
    parser.add_argument(
        "--artifact_dir", type=str, default="",
        help="Serve the exported programs of cli/export.py (configs from "
             "their manifest; frames must be of an exported resolution).")
    parser.add_argument(
        "--max_connections", type=int, default=0,
        help="Exit after serving N connections (0 = forever).")
    parser.add_argument(
        "--warmup_hw", type=str, default="",
        help="HxW (e.g. 1080x1920) whose every bucket pair is captured "
             "(both NMS programs) before the server accepts connections.")
    args = parser.parse_args(argv)

    factory, cache = build_pipeline_factory(args)
    if args.warmup_hw:
        from botsort_tpu_torch.pipeline.host import warm_up

        h, w = (int(v) for v in args.warmup_hw.split("x"))
        t0 = time.perf_counter()
        for (b, fb, iters), dt in warm_up(factory(), (h, w)):
            print(f"warmed {h}x{w} buckets ({b},{fb}) NMS "
                  f"{iters or 'fixed'} in {dt:.3f} s")
        pool = (f", {torch.cuda.memory_reserved()} bytes reserved"
                if cache is not None else "")
        print(f"warmed {h}x{w} in {time.perf_counter() - t0:.3f} s{pool}")
    handler = make_handler(factory)
    with Server((args.host, args.port), handler) as srv:
        print(f"serving on {args.host}:{srv.server_address[1]}", flush=True)
        try:
            if args.max_connections:
                for _ in range(args.max_connections):
                    srv.handle_request()
            else:
                srv.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
