#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (botsort_tpu_torch) on one GPU.

Drives the port's main path on the card and fails loudly if any phase
fails:

  1. device   a CUDA card is required (no CPU fallback); prints its name
              and power limit; TF32 is switched off.
  2. build    builds every CUDA kernel of the path from csrc/.
  3. K1       the cascade solver kernel against its plain PyTorch version
              on the card: equal matchings on random, odd-shaped,
              degenerate and tie-heavy instances.
  4. small    the MINI networks in float32 on the card against the same
              networks on the CPU (the CPU path is the one held to the
              JAX package by the tests).
  5. main     BoTSORTPipeline.update at full model width (YOLOX-X,
              FastReID SBS-S50, the face encoder; bfloat16, seeded random
              weights) over 8 seeded 1080p frames; K1 must launch on every
              frame; the last frame's cascade re-run with the plain solver
              on the card must give the same tracks.
  6. timings  frame time and K1 against its plain version.

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

LIMITS = (0.8, 0.5, 0.7)
N_TRACKS, N_DETS = 64, 50
K1_SOURCE = "botsort_tpu_torch/csrc/cascade_lap.cu"
K1_REPLACES = "botsort_tpu/ops/assignment_pallas.py:350"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cascade_instance(rng, n, d, empty_rows=False, empty_cols=False,
                     quantum=None):
    """The solver tests' generator: three cost matrices and five masks."""
    costs = [rng.uniform(0, 1, (n, d)).astype(np.float32) for _ in range(3)]
    if quantum:
        costs = [(np.round(c / quantum) * quantum).astype(np.float32)
                 for c in costs]
    pool = rng.uniform(0, 1, n) < 0.6
    tracked = pool & (rng.uniform(0, 1, n) < 0.7)
    unconf = (~pool) & (rng.uniform(0, 1, n) < 0.4)
    high = rng.uniform(0, 1, d) < 0.6
    low = (~high) & (rng.uniform(0, 1, d) < 0.5)
    if empty_rows:
        pool[:] = tracked[:] = unconf[:] = False
    if empty_cols:
        high[:] = low[:] = False
    return (*costs, pool, tracked, unconf, high, low)


def phase_k1(torch, assignment, assignment_cuda, dev):
    """Kernel vs plain version on the card; returns the K1 inputs at the
    main path's shape for the timing phase and the max index error."""
    rng = np.random.default_rng(2024)
    cases = [(N_TRACKS, N_DETS, {})] * 200
    cases += [(n, d, {}) for n, d in ((12, 9), (5, 14), (16, 16), (3, 2))
              for _ in range(4)]
    cases += [(10, 8, dict(empty_rows=True)), (10, 8, dict(empty_cols=True)),
              (10, 8, dict(empty_rows=True, empty_cols=True))]
    cases += [(n, d, dict(quantum=0.05)) for n, d in
              ((N_TRACKS, N_DETS), (12, 9), (16, 16)) for _ in range(8)]
    timing_inputs = []
    max_err = 0
    t0 = time.perf_counter()
    for k, (n, d, kw) in enumerate(cases):
        inst = [torch.from_numpy(a).to(dev)
                for a in cascade_instance(rng, n, d, **kw)]
        costs, masks, big = assignment.prepare_cascade(*inst, LIMITS)
        args = (costs[None], masks[None], big[None], LIMITS)
        got = assignment_cuda.cascade_solve_cuda(*args)
        want = assignment.cascade_solve_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(
                    f"K1 != plain on instance {k} (N={n}, D={d}, {kw}):\n"
                    f"kernel {g.cpu().tolist()}\nplain  {w.cpu().tolist()}")
        if (n, d) == (N_TRACKS, N_DETS) and not kw and \
                len(timing_inputs) < 8:
            timing_inputs.append(args)
    log(f"K1: {len(cases)} instances equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    return timing_inputs, max_err


def phase_small(torch, assets, dev):
    """MINI float32 networks, card vs CPU, same seeded weights."""
    from botsort_tpu_torch.models.fastreid import preprocess

    cpu = assets.build_bundle(mini=True, seed=3, device="cpu",
                              dtype=torch.float32)
    gpu = assets.build_bundle(mini=True, seed=3, device=dev,
                              dtype=torch.float32)
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 96, 128, 3)).astype(
        np.float32))
    crops = torch.from_numpy(rng.integers(0, 255, (4, 64, 32, 3)).astype(
        np.uint8))
    faces = torch.from_numpy(rng.uniform(0, 255, (4, 32, 32, 3)).astype(
        np.float32))
    with torch.no_grad():
        want_det, got_det = cpu.detector(img), gpu.detector(img.to(dev))
        pairs = [
            ("detector boxes", want_det[0], got_det[0]),
            ("detector scores", want_det[1], got_det[1]),
            ("body features", cpu.body_encoder(preprocess(crops)),
             gpu.body_encoder(preprocess(crops.to(dev)))),
            ("face features", cpu.face_encoder(faces),
             gpu.face_encoder(faces.to(dev))),
        ]
    # float32 on both sides with TF32 off; cuDNN and the CPU sum the
    # convolutions in different orders. Boxes are pixels (cx -/+ w/2).
    for name, want, got in pairs:
        atol = 1e-2 if "boxes" in name else 1e-4
        got = got.cpu()
        if not torch.allclose(got, want, rtol=1e-4, atol=atol):
            raise AssertionError(
                f"{name}: card differs from CPU by "
                f"{float((got - want).abs().max())}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite values")
    log("small: MINI networks on the card equal the CPU's "
        "(rtol 1e-4; atol 1e-4, boxes 1e-2 px)")


def phase_main(torch, assets, assignment, assignment_cuda, dev, card):
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.pipeline.host import BoTSORTPipeline
    from botsort_tpu_torch.track import cascade

    t0 = time.perf_counter()
    bundle = assets.build_bundle(mini=False, seed=0, device=dev,
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (bundle.detector, bundle.body_encoder,
                                       bundle.face_encoder)
                   for p in m.parameters())
    log(f"main: bundle built, {n_params} parameters "
        f"({time.perf_counter() - t0:.1f} s)")
    # The loaded operating point: thresholds at which random weights fill
    # the 50 body slots every frame.
    tracker_cfg = TrackerConfig(det_score_threshold=0.2,
                                track_high_thresh=0.15,
                                track_low_thresh=0.05, new_track_thresh=0.2)
    nms_cfg = NMSConfig()
    pipe_cfg = PipelineConfig()
    pipeline = BoTSORTPipeline(bundle, tracker_cfg, nms_cfg, pipe_cfg)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (1080, 1920, 3), dtype=np.uint8)
              for _ in range(8)]

    recorded = {}
    real_update = fs_mod.tracker_update

    def recording_update(store, *args):
        new_store, out = real_update(store, *args)
        recorded.update(store=store, args=args, out=out)
        return new_store, out

    frame_ms, launches_per_frame, n_tracks = [], [], []
    assignment_cuda.cascade_solve_cuda.launches = 0
    with mock.patch.object(fs_mod, "tracker_update", recording_update):
        for frame in frames:
            before = assignment_cuda.cascade_solve_cuda.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tracks = pipeline.update(frame)
            end.record()
            torch.cuda.synchronize()
            frame_ms.append(start.elapsed_time(end))
            launches_per_frame.append(
                assignment_cuda.cascade_solve_cuda.launches - before)
            n_tracks.append(len(tracks))
            res = pipeline.last_result
            for name in ("det_boxes", "det_scores"):
                if not np.isfinite(getattr(res, name)).all():
                    raise AssertionError(f"non-finite {name}")
            for name in ("tlbr", "score"):
                if not np.isfinite(getattr(res.tracks, name)).all():
                    raise AssertionError(f"non-finite tracks.{name}")
            if res.det_boxes.shape != (4, nms_cfg.max_boxes_per_class, 4):
                raise AssertionError(f"det_boxes {res.det_boxes.shape}")
    main_launches = assignment_cuda.cascade_solve_cuda.launches
    log(f"main: K1 launches per frame {launches_per_frame}, live tracks "
        f"per frame {n_tracks}, bodies in the last frame "
        f"{int(res.det_valid[0].sum())}")
    if min(launches_per_frame) < 1:
        raise AssertionError("K1 did not launch on every frame")
    if max(n_tracks) < 1:
        raise AssertionError("no live tracks on any frame")

    # The last frame's cascade again, with the plain solver on the card.
    def plain_on_card(costs, masks, big, limits, max_iters):
        return assignment.cascade_solve_plain(costs, masks, big, limits,
                                              max_iters)

    with torch.no_grad(), mock.patch.object(
            assignment_cuda, "cascade_solve_cuda", plain_on_card):
        _, plain_out = cascade.tracker_update(recorded["store"],
                                              *recorded["args"])
    if assignment_cuda.cascade_solve_cuda.launches != main_launches:
        raise AssertionError("the plain re-run launched K1")
    for name, want, got in zip(plain_out._fields, plain_out,
                               recorded["out"]):
        if not torch.equal(want, got):
            raise AssertionError(f"tracks.{name}: K1 path != plain path")
    log("main: last frame's tracks with the plain solver equal K1's")

    steady = frame_ms[2:]
    median = statistics.median(steady)
    log(f"timing: BoTSORTPipeline.update median {median:.3f} ms over "
        f"frames 3-8 (all: {[round(x, 3) for x in frame_ms]}), "
        f"{int(res.det_valid[0].sum())} bodies, {card}")
    log(f"timing: stages {json.dumps(pipeline.timers.report())}")
    return main_launches, median


def phase_k1_timing(torch, assignment, assignment_cuda, inputs, card):
    """CUDA-event times at the main path's shape (N=64, D=50)."""
    def event_ms(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kernel, plain = [], []
    for args in inputs:
        kernel.append(event_ms(
            lambda: assignment_cuda.cascade_solve_cuda(*args), 50))
        plain.append(event_ms(
            lambda: assignment.cascade_solve_plain(*args), 1))
    k_ms, p_ms = statistics.median(kernel), statistics.median(plain)
    log(f"timing: K1 cascade solve N={N_TRACKS} D={N_DETS}: kernel "
        f"{k_ms:.4f} ms, plain PyTorch on the card {p_ms:.3f} ms "
        f"(medians over {len(inputs)} instances), {card}")
    return k_ms, p_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from botsort_tpu_torch.ops import assignment, assignment_cuda
    from botsort_tpu_torch.runtime import assets, kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: TF32 off for matmul and cuDNN "
        f"({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    kernels.load("cascade_lap")
    log(f"build: cascade_lap in {time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in kernels.BUILD_INFO.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    timing_inputs, max_err = phase_k1(torch, assignment, assignment_cuda,
                                      dev)
    phase_small(torch, assets, dev)
    main_launches, frame_ms = phase_main(torch, assets, assignment,
                                         assignment_cuda, dev, card)
    k_ms, p_ms = phase_k1_timing(torch, assignment, assignment_cuda,
                                 timing_inputs, card)
    log(card)
    print(json.dumps({"kernels": [{
        "name": "cascade_lap",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
