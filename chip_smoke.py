#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (botsort_tpu_torch) on one GPU.

Drives the port's paths on the card and fails loudly if any phase fails:

  1. device   a CUDA card is required (no CPU fallback); prints its name
              and power limit; TF32 is switched off.
  2. build    builds every CUDA kernel from csrc/ (five libraries), one
              nvcc per source, all at once; prints registers and spills.
  3. K1       the cascade solver kernel against its plain PyTorch version
              on the card: equal matchings on random, odd-shaped,
              degenerate and tie-heavy instances (k1_instances).
  4. K3       the square JV kernel against its plain version: random,
              odd-shaped, all-parked and tie-heavy problems, S up to 114
              (k3_problems).
  5. K2       eight 8-stream batches at N=64, D=50 (one stream without
              live rows), each one launch: equal to the plain version
              and to eight one-stream K1 launches.
  6. oracle   K1's and K2's matchings equal three chained solve_masked
              calls (K3) per stream: the on-card oracle.
  7. small    the MINI networks in float32 on the card against the same
              networks on the CPU (the CPU path is the one held to the
              JAX package by the tests).
  8. main     BoTSORTPipeline.update at full model width (YOLOX-X,
              FastReID SBS-S50, the face encoder; bfloat16, seeded random
              weights) over 8 seeded 1080p frames at the loaded point,
              twice in this call: eagerly (graphs=False) and replayed from
              CUDA graphs (the default). Every FrameResult field of every
              frame and the final store must be bit-equal, over a bucket
              change and a forced overflow re-run; K1 must launch once per
              step run (a replay counts what its capture enqueued, a
              capture's warm-up call is one more); the last eager frame's
              cascade re-run with the plain solver on the card must give
              the same tracks. Prints both medians, device kernels and
              host launch calls a frame (torch.profiler) and the busy
              share.
  9. multi    the same for BatchedBoTSORTPipeline at 8 streams, full width,
              over 8 steps of 8 seeded 1080p frames at the moderate-16
              point, with K2 once per step run; counts K6's launches.
      nosync  one loaded full-width frame_step, its replay from the graph
              and an 8-stream update_async under
              torch.cuda.set_sync_debug_mode("error"): nothing between the
              upload and the readback may wait for the card.
      async   update_async makes no torch.cuda.synchronize and no readback
              (counted with mock.patch); result() makes one readback.
      K6      the batch norm + activation kernel against its plain version
              on every norm shape of an 8-stream step (recorded from the
              three networks), and on odd shapes in float32 and bfloat16
              with the four activations: bit for bit, SiLU within one unit
              in the last place; timed against the plain version and the
              eager chain it replaced, beside its bound.
      temporal TemporalBatchedBoTSORTPipeline at full width, B = 8, T = 2,
              moderate-16, seeded per-stream affines, replayed from CUDA
              graphs: the first groups equal T chained frame_step_batched
              calls at equal buckets (their perception taken from the same
              batch of B*T frames); K2 launches T times per step run.
      checkpoint save_bundle of the full-width bundle to a temporary
              directory and build_bundle(weights_dir=...) back: no warning
              on stderr, the three networks' outputs bit-equal; a directory
              without files gives the three warnings.
 10. K5       the depthwise stencil against its plain version: the face
              encoder's 13 stride-1 shapes at 50 faces, odd shapes in
              float32 and bfloat16, C > 1024, a partial span of planes,
              narrow planes on the scalar path; bit for bit.
 11. K4       the fused stem + stage 1 against its plain version at full
              width (N = 1, 7, 50, 128 at 256x128, N = 8 at 384x128;
              relative L2 <= 1e-2, no element off by more than 5% of the
              largest) and against the unfused modules (3e-2, 15%), seeded
              weights with perturbed batch norms; two calls on one input
              give the same bits (no atomics).
 12. lowered  the 8-stream path again with FastReIDSBS(fused_stem=True)
              and FaceReID(dw_mode="kernel") loaded with the same weights,
              replayed from CUDA graphs: K4 once per step run with body
              crops, K5 13 times per step run with face crops, K2 once per
              step run; the last step's encoder inputs re-run with K4 and
              K5 replaced by their plain versions on the card give the same
              features (face: equal, body: relative L2 <= 1e-2).
 13. timings  frame and step times, stage tables, and each kernel against
              its plain version (and a PyTorch call for the same function,
              where there is one) at the main paths' shapes, beside the
              least time the card could take for the same work; the
              solvers' pops per solve and time per pop, K4's and K5's
              eager time minus their CUDA-graph time (the wrappers' host
              cost), and K4's time split by CUDA kernel (torch.profiler)
              with each convolution's achieved TFLOP/s, its scratch bytes
              and the least time its layer-by-layer bytes allow.
 14. export   both NMS programs of one bucket pair exported with
              torch.export (runtime/exported.py), saved, loaded and
              replayed from CUDA graphs: load_pipeline at the loaded
              one-stream point (K1) and load_batched_pipeline at 8
              streams, moderate-16 (K2); over 8 frames every FrameResult
              field and the final stores equal the live facade's, the full
              NMS program equals the live step's, the graphs call the
              kernels as torch.ops.botsort_tpu_torch ops, and K1/K2 and
              K6 count on replay. Prints export and load seconds, bytes
              and live against loaded replay medians.
 15. serve    cli/serve.py's server on a localhost thread with a numpy
              decoder, cold and after warm_up captured both NMS programs
              of every bucket pair at 1080p: the JSON of 4 frames equals a
              direct pipeline's; prints the first request's latency both
              ways, capture seconds per step and the card's peak reserved
              memory.
 16. store    save_session mid-stream, load_store, load_session into a new
              facade: the rest of the run equals an uninterrupted run's.
 17. oproute  the loaded one-stream point run eagerly with the kernels
              called directly (the dispatchers' eager route) and through
              their custom ops (torch.ops.botsort_tpu_torch, the route a
              trace takes), runs in the order direct, op, op, direct:
              equal results and launches, and both routes' medians (the
              dispatcher's host cost).

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

LIMITS = (0.8, 0.5, 0.7)
N_TRACKS, N_DETS = 64, 50
STREAMS = 8
FRAME_HW = (1080, 1920)  # the seeded frames of every path
CASCADE_SOURCE = "botsort_tpu_torch/csrc/cascade_lap.cu"
JV_SOURCE = "botsort_tpu_torch/csrc/jv_lap.cu"
K1_REPLACES = "botsort_tpu/ops/assignment_pallas.py:350"
K2_REPLACES = "botsort_tpu/ops/assignment_pallas.py:655"
K3_REPLACES = "botsort_tpu/ops/assignment_pallas.py:48"
K4_SOURCE = "botsort_tpu_torch/csrc/stem_stage1.cu"
K4_REPLACES = "botsort_tpu/models/fastreid_pallas.py:178"
K5_SOURCE = "botsort_tpu_torch/csrc/dw_conv3x3.cu"
K5_REPLACES = "botsort_tpu/models/facereid_pallas.py:40"
K6_SOURCE = "botsort_tpu_torch/csrc/bn_act.cu"
# K6 replaces no TPU kernel: on the TPU XLA fuses the Flax BatchNorm and
# the activation of botsort_tpu/models/common.py::ConvBN (and the two
# encoders' blocks) into the convolution before them.
K6_REPLACES = "botsort_tpu/models/common.py:62"
# The face encoder's 13 stride-1 depthwise 3x3 layers at 128x128 faces,
# (H, W, C), and the face count they are checked and timed at.
FACE_DW_SHAPES = ([(64, 64, 32), (32, 32, 144)] + [(16, 16, 192)] * 2
                  + [(8, 8, 384)] * 4 + [(8, 8, 576)] * 2
                  + [(4, 4, 960)] * 3)
N_FACES = 50
# K4's checks (N, H, W) and timings (N at 256x128), on a full-width stem
# and stage 1 (later stages one block each: K4 does not reach them).
K4_CASES = ((1, 256, 128), (7, 256, 128), (N_FACES, 256, 128),
            (128, 256, 128), (8, 384, 128))
K4_TIMING_N = (N_FACES, 128)
K4_LAYOUT = dict(stage_blocks=(3, 1, 1, 1))
# The H100's published peaks (NVIDIA data sheet, SXM, dense): bytes/s of
# HBM3, float32 FLOP/s outside the tensor cores, bfloat16 tensor FLOP/s.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12


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


def index_err(torch, got, want, what) -> int:
    """Max index difference of two int tensors; raises if not 0."""
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{what}:\nkernel {got.cpu().tolist()}\n"
                             f"plain  {want.cpu().tolist()}")
    return err


def event_ms(torch, fn, reps):
    """CUDA-event time of one call, averaged over reps after a warm-up."""
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


def graph_ms(torch, fn, calls=20, replays=10):
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    and replayed, so no host work (Python, wrapper checks, launch
    overhead) sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(nbytes, flops, peak_flops):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type;
    returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_instances(torch, assignment, dev):
    """phase_k1's instances in order: (N, D, generator options, the
    kernel's arguments). The first 8 at N_TRACKS x N_DETS without options
    are the timing inputs."""
    rng = np.random.default_rng(2024)
    cases = [(N_TRACKS, N_DETS, {})] * 100
    cases += [(n, d, {}) for n, d in ((12, 9), (5, 14), (16, 16), (3, 2))
              for _ in range(4)]
    cases += [(10, 8, dict(empty_rows=True)), (10, 8, dict(empty_cols=True)),
              (10, 8, dict(empty_rows=True, empty_cols=True))]
    cases += [(n, d, dict(quantum=0.05)) for n, d in
              ((N_TRACKS, N_DETS), (12, 9), (16, 16)) for _ in range(8)]
    for n, d, kw in cases:
        inst = [torch.from_numpy(a).to(dev)
                for a in cascade_instance(rng, n, d, **kw)]
        costs, masks, big = assignment.prepare_cascade(*inst, LIMITS)
        yield n, d, kw, (costs[None], masks[None], big[None], LIMITS)


def is_k1_timing(n, d, kw):
    return (n, d) == (N_TRACKS, N_DETS) and not kw


def phase_k1(torch, assignment, assignment_cuda, dev):
    """Kernel vs plain version on the card; returns the K1 inputs at the
    main path's shape for the timing phase and the max index error."""
    timing_inputs = []
    max_err = 0
    for k, (n, d, kw, args) in enumerate(k1_instances(torch, assignment,
                                                      dev)):
        got = assignment_cuda.cascade_solve_cuda(*args)
        want = assignment.cascade_solve_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            max_err = max(max_err, index_err(
                torch, g, w, f"K1 != plain on instance {k} (N={n}, D={d}, "
                f"{kw})"))
        if is_k1_timing(n, d, kw) and len(timing_inputs) < 8:
            timing_inputs.append(args)
    log(f"K1: {k + 1} instances equal to the plain version")
    return timing_inputs, max_err


def k3_problems(torch, assignment, dev):
    """phase_k3's problems in order, as the kernel's arguments: K3 on
    solve_masked's square problems (S = N + D) and on dense ones. The
    first 8 at S = N_TRACKS + N_DETS are the timing inputs."""
    rng = np.random.default_rng(33)
    problems = []
    for n, d, kind in ([(N_TRACKS, N_DETS, "random")] * 12
                       + [(N_TRACKS, N_DETS, "ties")] * 4
                       + [(n, d, "random") for n, d in
                          ((12, 9), (5, 14), (3, 2), (1, 1))]
                       + [(10, 8, "parked")] * 2):
        cost = rng.uniform(0, 1.2, (n, d)).astype(np.float32)
        if kind == "ties":
            cost = (np.round(cost / 0.05) * 0.05).astype(np.float32)
        rv = rng.uniform(0, 1, n) < (0.0 if kind == "parked" else 0.8)
        cv = rng.uniform(0, 1, d) < 0.8
        ext, p0, order, n_live, _, _ = assignment.masked_problem(
            *[torch.from_numpy(a).to(dev) for a in (cost, rv, cv)], 0.8)
        problems.append((ext[None], p0[None], order[None], n_live[None]))
    for s, live in ((114, 114), (114, 57), (31, 0)):  # dense, tie-heavy
        ext = (np.round(rng.uniform(0, 1, (1, s, s)) / 0.05) * 0.05)
        idx = np.arange(s)
        p0 = np.where(idx < live, -1, idx)[None].astype(np.int32)
        order = np.where(idx < live, idx, s)[None].astype(np.int32)
        problems.append(tuple(torch.from_numpy(a).to(dev) for a in (
            ext.astype(np.float32), p0, order,
            np.array([live], np.int32))))
    return problems


def phase_k3(torch, assignment, assignment_cuda, dev):
    """K3 vs jv_solve_plain on k3_problems; returns the S = 114 timing
    inputs and the max index error."""
    problems = k3_problems(torch, assignment, dev)
    max_err = 0
    timing_inputs = []
    for k, args in enumerate(problems):
        got = assignment_cuda.jv_solve_cuda(*args)
        want = assignment.jv_solve_plain(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, index_err(
            torch, got, want, f"K3 != plain on problem {k} "
            f"(S={args[0].shape[1]})"))
        if args[0].shape[1] == N_TRACKS + N_DETS and len(timing_inputs) < 8:
            timing_inputs.append(args)
    log(f"K3: {len(problems)} problems equal to the plain version")
    return timing_inputs, max_err


def phase_k2(torch, assignment, assignment_cuda, dev):
    """Eight 8-stream batches, one launch each, against the plain version
    and against one-stream K1 launches; returns the batches' raw
    instances and prepared inputs, and the max index error."""
    rng = np.random.default_rng(77)
    batches, max_err = [], 0
    cuda = assignment_cuda.cascade_solve_cuda
    for k in range(8):
        insts = [cascade_instance(rng, N_TRACKS, N_DETS,
                                  empty_rows=(s == k % STREAMS))
                 for s in range(STREAMS)]
        tensors = [torch.from_numpy(np.stack(x)).to(dev)
                   for x in zip(*insts)]
        costs, masks, big = assignment.prepare_cascade(*tensors, LIMITS)
        before = cuda.batched_launches
        got = cuda(costs, masks, big, LIMITS)
        if cuda.batched_launches != before + 1:
            raise AssertionError("an 8-stream solve was not one launch")
        want = assignment.cascade_solve_plain(costs, masks, big, LIMITS)
        singles = [cuda(costs[s:s + 1], masks[s:s + 1], big[s:s + 1],
                        LIMITS) for s in range(STREAMS)]
        torch.cuda.synchronize()
        for i in range(2):
            max_err = max(
                max_err,
                index_err(torch, got[i], want[i], f"K2 != plain, batch {k}"),
                index_err(torch, got[i],
                          torch.cat([s[i] for s in singles]),
                          f"K2 != eight K1 launches, batch {k}"))
        batches.append((tensors, (costs, masks, big, LIMITS), got))
    log(f"K2: {len(batches)} batches of {STREAMS} streams, one launch "
        "each, equal to the plain version and to one-stream K1 launches")
    return batches, max_err


def phase_oracle(torch, assignment, assignment_cuda, batches):
    """K1's and K2's matchings against three chained solve_masked calls
    (K3 on the card) per stream; returns K3's launch count on this path
    and the max index error."""
    jv = assignment_cuda.jv_solve_cuda
    jv.launches = 0
    max_err = 0
    for k, (tensors, prepared, k2_out) in enumerate(batches):
        for s in range(STREAMS):
            d1, iou, d3, pool, tracked, unconf, high, low = (
                t[s] for t in tensors)
            res1 = assignment.solve_masked(d1, pool, high, LIMITS[0])
            res2 = assignment.solve_masked(
                iou, tracked & (res1.col_for_row < 0), low, LIMITS[1])
            res3 = assignment.solve_masked(
                d3, unconf, high & (res1.row_for_col < 0), LIMITS[2])
            k1_out = assignment.solve_cascade_masked(
                d1, iou, d3, pool, tracked, unconf, high, low, LIMITS)
            for p, want in enumerate((res1, res2, res3)):
                for name, i in (("col_for_row", 0), ("row_for_col", 1)):
                    w = getattr(want, name)
                    max_err = max(
                        max_err,
                        index_err(torch, k2_out[i][s, p], w,
                                  f"K2 != K3 chain, batch {k} stream {s} "
                                  f"pass {p + 1} {name}"),
                        index_err(torch, getattr(k1_out[p], name), w,
                                  f"K1 != K3 chain, batch {k} stream {s} "
                                  f"pass {p + 1} {name}"))
    launches = jv.launches
    if launches != 3 * STREAMS * len(batches):
        raise AssertionError(f"solve_masked launched K3 {launches} times")
    log(f"oracle: K1 and K2 equal three chained K3 solves on "
        f"{STREAMS * len(batches)} streams ({launches} K3 launches)")
    return launches, max_err


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


class CascadeRecorder:
    """Wraps frame_step's tracker_update_batched: keeps the last call's
    inputs and outputs, to replay its cascade with the plain solver."""

    def __init__(self, fs_mod):
        self.real = fs_mod.tracker_update_batched
        self.last = None

    def __call__(self, stores, *args):
        new_stores, out = self.real(stores, *args)
        self.last = (stores, args, out)
        return new_stores, out

    def replay_plain(self, torch, assignment, assignment_cuda, cascade):
        """The last call again with the plain solver on the card; fails
        unless its outputs are equal and no kernel launched."""
        cuda = assignment_cuda.cascade_solve_cuda
        counts = (cuda.launches, cuda.batched_launches)

        def plain_on_card(costs, masks, big, limits,
                          max_iters=assignment.MAX_ITERS):
            return assignment.cascade_solve_plain(costs, masks, big, limits,
                                                  max_iters)

        stores, args, out = self.last
        with torch.no_grad(), mock.patch.object(
                assignment_cuda, "cascade_solve_cuda", plain_on_card):
            _, plain_out = cascade.tracker_update_batched(stores, *args)
        if (cuda.launches, cuda.batched_launches) != counts:
            raise AssertionError("the plain re-run launched a kernel")
        for name, want, got in zip(plain_out._fields, plain_out, out):
            if not torch.equal(want, got):
                raise AssertionError(f"tracks.{name}: kernel path != "
                                     "plain path")


def check_finite(res, nms_cfg, streams=None):
    lead = () if streams is None else (streams,)
    for name in ("det_boxes", "det_scores"):
        if not np.isfinite(getattr(res, name)).all():
            raise AssertionError(f"non-finite {name}")
    for name in ("tlbr", "score"):
        if not np.isfinite(getattr(res.tracks, name)).all():
            raise AssertionError(f"non-finite tracks.{name}")
    if res.det_boxes.shape != lead + (4, nms_cfg.max_boxes_per_class, 4):
        raise AssertionError(f"det_boxes {res.det_boxes.shape}")


def loaded_cfg(TrackerConfig, **kw):
    """The JAX bench's loaded operating point: thresholds at which random
    weights fill every body slot."""
    return TrackerConfig(det_score_threshold=0.2, track_high_thresh=0.15,
                         track_low_thresh=0.05, new_track_thresh=0.2, **kw)


HOST_LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
    "cudaMemsetAsync"))


def step_profile(torch, fn, steps=2):
    """``steps`` calls of fn under torch.profiler: (device kernels and
    copies per call, host launch calls per call, device ms per call). One
    call more runs first and is not counted: a torch.profiler run can lose
    the events of its first milliseconds. The device synchronisation after
    that call marks where the counted events begin."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    syncs = sorted(e.time_range.end for e in events
                   if e.name == "cudaDeviceSynchronize")
    if not syncs:
        raise AssertionError("torch.profiler recorded no device "
                             "synchronisation to count from")
    n_dev = n_host = 0
    dev_us = 0.0
    for e in events:
        if e.time_range.start < syncs[0]:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "device_time", None)
            dev_us += e.cuda_time if us is None else us
            n_dev += 1
        elif e.name in HOST_LAUNCH_CALLS:
            n_host += 1
    if n_dev == 0 or dev_us <= 0.0:
        raise AssertionError("torch.profiler saw no device work in a step")
    return n_dev / steps, n_host / steps, dev_us / 1e3 / steps


def forget_counts(pipeline):
    """Make the facade pick bucket 0 for its next step, as if the last one
    had seen nobody: the step overflows and re-runs."""
    if hasattr(pipeline, "_last_n_live"):
        pipeline._last_n_live, pipeline._last_n_face = 0, 0
    else:
        pipeline._last_max_live, pipeline._last_max_face = 0, 0


def drive(torch, pipeline, inputs, launches_of, force_at=None, gmc=None,
          check=None):
    """A facade over ``inputs`` (one update each); per step its host-clock
    time to the end of the device's work, its step runs as (reid bucket,
    face bucket, whether the run captured a new graph), the kernel's
    launch-count difference, its tracks and its host FrameResult."""
    runs = []
    real_step = pipeline._step

    def step(*a):
        cache = pipeline._graphs
        known = len(cache.keys()) if cache is not None else 0
        out = real_step(*a)
        runs.append((a[2], a[3],
                     cache is not None and len(cache.keys()) > known))
        return out

    pipeline._step = step
    rows = []
    try:
        for i, x in enumerate(inputs):
            if i == force_at:
                forget_counts(pipeline)
            n_runs, before = len(runs), launches_of()
            t0 = time.perf_counter()
            tracks = pipeline.update(x) if gmc is None else \
                pipeline.update(x, gmc[i])
            torch.cuda.synchronize()
            ms = 1000.0 * (time.perf_counter() - t0)
            if check is not None:
                check(pipeline.last_result)
            rows.append(dict(ms=ms, runs=runs[n_runs:],
                             launches=launches_of() - before, tracks=tracks,
                             result=pipeline.last_result))
    finally:
        pipeline._step = real_step
    return rows


def expected_launches(row, per_run=1, ran=lambda run: True):
    """Launches a step's runs stand for: one per replay (or eager run), and
    the warm-up calls of a run that captured a new graph."""
    from botsort_tpu_torch.pipeline.graphed import WARMUP_CALLS

    return per_run * sum(1 + WARMUP_CALLS * new
                         for rb, fb, new in row["runs"] if ran((rb, fb)))


def steady_ms(rows):
    """Times of the steps that ran once, from a graph already captured (or
    eagerly), after the two first steps."""
    ms = [r["ms"] for r in rows[2:]
          if len(r["runs"]) == 1 and not r["runs"][0][2]]
    if not ms:
        raise AssertionError("no steady step to time")
    return ms


def same_results(torch, host, rows_a, rows_b, stores_a, stores_b, what):
    """Every FrameResult field of every step and the final stores (unless
    None) of two runs, bit for bit."""
    for i, (a, b) in enumerate(zip(rows_a, rows_b)):
        ra, rb = a["result"], b["result"]
        fields = list(zip(ra._fields[:-1], ra[:-1], rb[:-1])) + [
            (f"tracks.{n}", x, y) for n, x, y in zip(
                ra.tracks._fields, ra.tracks, rb.tracks)]
        for name, x, y in fields:
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{what}: step {i + 1} {name} differs")
    if stores_a is None:
        return
    for k, (x, y) in enumerate(zip(host._store_tensors(stores_a),
                                   host._store_tensors(stores_b))):
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what}: final store field {k} differs")


def report_point(torch, label, unit, pipes, rows, frames_per_step, card,
                 profile_input, gmc=None):
    """Medians, launches per step and busy share of the eager and the
    replayed facade of one operating point; returns {mode: (median ms,
    frames/s)}."""
    out = {}
    for mode in ("eager", "graphed"):
        ms = steady_ms(rows[mode])
        median = statistics.median(ms)
        fps = frames_per_step * len(ms) / (sum(ms) / 1000.0)
        pipe = pipes[mode]
        fn = (lambda: pipe.update(profile_input)) if gmc is None else (
            lambda: pipe.update(profile_input, gmc))
        n_dev, n_host, dev_ms = step_profile(torch, fn)
        log(f"timing: {label} {mode}: median {median:.3f} ms a {unit} over "
            f"{len(ms)} steady {unit}s (all: "
            f"{[round(r['ms'], 3) for r in rows[mode]]}), {fps:.2f} "
            f"frames/s; under torch.profiler: {n_dev:.0f} device kernels "
            f"and copies a {unit}, {n_host:.0f} host launch calls a {unit}"
            f"{'' if n_host else ' (not measured)'}, {dev_ms:.3f} ms of "
            f"device time a {unit}: busy share {dev_ms / median:.3f} of the "
            f"median; {card}")
        out[mode] = (median, fps)
    e, g = out["eager"][0], out["graphed"][0]
    log(f"timing: {label}: graphed {g:.3f} ms against eager {e:.3f} ms in "
        f"this call ({e / g:.2f}x); stages (host clock, no waiting) "
        f"{json.dumps(pipes['graphed'].timers.report())}")
    return out


def phase_main(torch, bundle, assignment, assignment_cuda, card):
    """The loaded one-stream point, eager and replayed from CUDA graphs
    over the same frames; returns K1's launches in the replayed run and
    the nosync / async material."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.track import cascade

    nms_cfg = NMSConfig()
    cfgs = (loaded_cfg(TrackerConfig), nms_cfg, PipelineConfig())
    pipes = {"eager": host.BoTSORTPipeline(bundle, *cfgs, graphs=False),
             "graphed": host.BoTSORTPipeline(bundle, *cfgs)}
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, FRAME_HW + (3,), dtype=np.uint8)
              for _ in range(8)]
    cuda = assignment_cuda.cascade_solve_cuda
    recorder = CascadeRecorder(fs_mod)
    check = lambda res: check_finite(res, nms_cfg)  # noqa: E731
    rows = {}
    with mock.patch.object(fs_mod, "tracker_update_batched", recorder):
        rows["eager"] = drive(torch, pipes["eager"], frames,
                              lambda: cuda.launches, force_at=4, check=check)
    recorder.replay_plain(torch, assignment, assignment_cuda, cascade)
    log("main: last eager frame's tracks with the plain solver equal K1's")
    cuda.launches = cuda.batched_launches = 0
    rows["graphed"] = drive(torch, pipes["graphed"], frames,
                            lambda: cuda.launches, force_at=4, check=check)
    main_launches = cuda.launches
    if cuda.batched_launches:
        raise AssertionError("the one-stream path launched K2")
    same_results(torch, host, rows["eager"], rows["graphed"],
                 pipes["eager"].store, pipes["graphed"].store,
                 "main: graphed != eager")
    for mode in rows:
        for i, r in enumerate(rows[mode]):
            if r["launches"] != expected_launches(r) or r["launches"] < 1:
                raise AssertionError(
                    f"main {mode}: frame {i + 1} launched K1 "
                    f"{r['launches']} times over runs {r['runs']}")
    cache = pipes["graphed"]._graphs
    n_runs = sum(len(r["runs"]) for r in rows["graphed"])
    if cache.replays != n_runs or cache.captures != len(cache.keys()):
        raise AssertionError("main: the graph cache's counts are off")
    buckets = sorted({run[:2] for r in rows["graphed"] for run in r["runs"]})
    if len(buckets) < 2 or max(len(r["runs"]) for r in rows["graphed"]) < 2:
        raise AssertionError(f"main: no bucket change or re-run: {buckets}")
    n_tracks = [len(r["tracks"]) for r in rows["graphed"]]
    res = rows["graphed"][-1]["result"]
    log(f"main: graphed equals eager on every FrameResult field of "
        f"{len(frames)} frames and on the final store; K1 launches per "
        f"frame {[r['launches'] for r in rows['graphed']]} over runs "
        f"{[r['runs'] for r in rows['graphed']]}; {cache.captures} graphs "
        f"for buckets {buckets}, {cache.replays} replays; live tracks per "
        f"frame {n_tracks}, bodies in the last frame "
        f"{int(res.det_valid[0].sum())}")
    if max(n_tracks) < 1:
        raise AssertionError("no live tracks on any frame")
    report_point(torch, "BoTSORTPipeline.update (loaded, one stream)",
                 "frame", pipes, rows, 1, card, frames[-1])
    return main_launches, pipes["graphed"], frames[-1], cfgs


def phase_multi(torch, bundle, assignment, assignment_cuda, bn_act, card):
    """BatchedBoTSORTPipeline, 8 streams, moderate-16, eager and replayed
    over the same frames; returns K2's and K6's launches in the replayed
    run, the replayed medians and the pipeline."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.track import cascade

    nms_cfg = NMSConfig()
    # The JAX bench's 8-stream point: the loaded thresholds with 16 body
    # slots per stream ("moderate-16").
    cfgs = (loaded_cfg(TrackerConfig, max_dets=16), nms_cfg, PipelineConfig())
    pipes = {"eager": host.BatchedBoTSORTPipeline(bundle, STREAMS, *cfgs,
                                                  graphs=False),
             "graphed": host.BatchedBoTSORTPipeline(bundle, STREAMS, *cfgs)}
    rng = np.random.default_rng(1)
    steps = [rng.integers(0, 255, (STREAMS,) + FRAME_HW + (3,), dtype=np.uint8)
             for _ in range(8)]
    cuda = assignment_cuda.cascade_solve_cuda
    k6 = bn_act.bn_act_cuda
    recorder = CascadeRecorder(fs_mod)
    check = lambda res: check_finite(res, nms_cfg, STREAMS)  # noqa: E731
    rows = {}
    with mock.patch.object(fs_mod, "tracker_update_batched", recorder):
        rows["eager"] = drive(torch, pipes["eager"], steps,
                              lambda: cuda.batched_launches, force_at=4,
                              check=check)
    recorder.replay_plain(torch, assignment, assignment_cuda, cascade)
    log(f"multi: last eager step's tracks with the plain solver equal K2's "
        f"on all {STREAMS} streams")
    cuda.launches = cuda.batched_launches = k6.launches = 0
    rows["graphed"] = drive(torch, pipes["graphed"], steps,
                            lambda: cuda.batched_launches, force_at=4,
                            check=check)
    k2_launches, k6_launches = cuda.batched_launches, k6.launches
    if cuda.launches:
        raise AssertionError("the 8-stream path launched one-stream K1")
    same_results(torch, host, rows["eager"], rows["graphed"],
                 pipes["eager"].stores, pipes["graphed"].stores,
                 "multi: graphed != eager")
    for mode in rows:
        for i, r in enumerate(rows[mode]):
            if r["launches"] != expected_launches(r) or r["launches"] < 1:
                raise AssertionError(
                    f"multi {mode}: step {i + 1} launched K2 "
                    f"{r['launches']} times over runs {r['runs']}")
    cache = pipes["graphed"]._graphs
    n_runs = sum(len(r["runs"]) for r in rows["graphed"])
    if cache.replays != n_runs or cache.captures != len(cache.keys()):
        raise AssertionError("multi: the graph cache's counts are off")
    buckets = sorted({run[:2] for r in rows["graphed"] for run in r["runs"]})
    if len(buckets) < 2 or max(len(r["runs"]) for r in rows["graphed"]) < 2:
        raise AssertionError(f"multi: no bucket change or re-run: {buckets}")
    n_tracks = [[len(t) for t in r["tracks"]] for r in rows["graphed"]]
    log(f"multi: graphed equals eager on every FrameResult field of "
        f"{len(steps)} steps and on the final stores; K2 launches per step "
        f"{[r['launches'] for r in rows['graphed']]} over runs "
        f"{[r['runs'] for r in rows['graphed']]}; {cache.captures} graphs "
        f"for buckets {buckets}, {cache.replays} replays; K6 launches in "
        f"the replayed run {k6_launches}; live tracks per stream "
        f"{n_tracks[-1]}")
    if max(max(n) for n in n_tracks) < 1:
        raise AssertionError("no live tracks on any stream")
    if k6_launches < n_runs:
        raise AssertionError("the networks did not run K6")
    point = report_point(
        torch, f"BatchedBoTSORTPipeline.update ({STREAMS} streams, "
        "moderate-16)", "step", pipes, rows, STREAMS, card, steps[-1])
    return (k2_launches, k6_launches, point["graphed"], pipes["graphed"],
            steps[-1], cfgs)


def phase_nosync(torch, bundle, main_pipe, frame, cfgs, multi_pipe, frames):
    """One loaded full-width step, eager and replayed, and one 8-stream
    update_async under torch's synchronisation debug mode: any wait
    between the upload and the readback raises."""
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.pipeline import host

    frame_dev = torch.from_numpy(frame).to(bundle.device)
    store = main_pipe.store
    buckets = max(main_pipe._graphs.keys(), key=lambda k: k[5])[5:7]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, result = fs_mod.frame_step(bundle, store, frame_dev, *cfgs,
                                      reid_bucket=buckets[0],
                                      face_bucket=buckets[1])
        eager = host.pack_result(result)
        _, replayed = main_pipe._step(store, frame_dev, *buckets)
        handle = multi_pipe.update_async(frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    a, b = eager.to_host(), replayed.to_host()
    for name, x, y in zip(a._fields[:-1], a[:-1], b[:-1]):
        if not np.array_equal(x, y):
            raise AssertionError(f"nosync: replayed {name} != eager")
    if not a.nms_converged.all():
        raise AssertionError("nosync: the NMS fixpoint did not converge")
    if len(handle.result()) != STREAMS:
        raise AssertionError("nosync: the batched step lost a stream")
    from botsort_tpu_torch.ops.nms import FIXPOINT_ITERS

    needed = (fixpoint_iterations(torch, bundle, frame_dev[None], cfgs),
              fixpoint_iterations(torch, bundle, torch.from_numpy(frames).to(
                  bundle.device), cfgs))
    log(f"nosync: NMS fixpoint iterations until nothing changes: {needed[0]} "
        f"on the loaded frame, {needed[1]} on the {STREAMS}-stream step's "
        f"frames (the step runs {FIXPOINT_ITERS})")
    if max(needed) > FIXPOINT_ITERS:
        raise AssertionError("the smoke scenes need more NMS iterations "
                             "than the step runs")
    log(f"nosync: a loaded full-width frame_step at buckets {buckets} "
        f"({int(a.det_valid[0].sum())} bodies), its replay from the graph "
        f"and an {STREAMS}-stream update_async ran under "
        "set_sync_debug_mode('error'): no wait between upload and readback")


def fixpoint_iterations(torch, bundle, frames_dev, cfgs):
    """The least iteration count at which the NMS fixpoint of these frames
    reports convergence (its last iteration changed nothing), found by
    trying counts outside any step."""
    from botsort_tpu_torch.ops import nms
    from botsort_tpu_torch.ops.crop import crop_and_resize_batched

    _, nms_cfg, pipe_cfg = cfgs
    h, w = frames_dev.shape[1:3]
    full = torch.tensor([0.0, 0.0, float(w), float(h)],
                        device=frames_dev.device).expand(
                            frames_dev.shape[0], 1, 4)
    with torch.no_grad():
        boxes, scores = bundle.detector(crop_and_resize_batched(
            frames_dev, full, pipe_cfg.detector_input_hw)[:, 0])
        for k in range(1, nms_cfg.pre_nms_top_k + 1):
            dets = nms.multiclass_nms_dense_batched(
                boxes, scores, nms_cfg.iou_threshold,
                nms_cfg.score_threshold, nms_cfg.max_boxes_per_class,
                nms_cfg.pre_nms_top_k, iters=k)
            if bool(dets.converged.all()):
                return k
    raise AssertionError("the NMS fixpoint never converged")


def phase_async(torch, multi_pipe, frames):
    """update_async returns without a synchronisation and without a
    readback; result() does one readback."""
    counts = {"synchronize": 0, "cpu": 0, "item": 0, "tolist": 0}
    real_sync, real_cpu = torch.cuda.synchronize, torch.Tensor.cpu
    real_item, real_tolist = torch.Tensor.item, torch.Tensor.tolist

    def counted(name, real):
        def call(*a, **k):
            counts[name] += 1
            return real(*a, **k)
        return call

    keys = len(multi_pipe._graphs.keys())
    with mock.patch.object(torch.cuda, "synchronize",
                           counted("synchronize", real_sync)), \
            mock.patch.object(torch.Tensor, "cpu", counted("cpu", real_cpu)), \
            mock.patch.object(torch.Tensor, "item",
                              counted("item", real_item)), \
            mock.patch.object(torch.Tensor, "tolist",
                              counted("tolist", real_tolist)):
        t0 = time.perf_counter()
        handle = multi_pipe.update_async(frames)
        t_dispatch = time.perf_counter() - t0
        in_dispatch = dict(counts)
        tracks = handle.result()
        t_total = time.perf_counter() - t0
    if len(multi_pipe._graphs.keys()) != keys:
        raise AssertionError("async: the step captured a new graph")
    if any(in_dispatch.values()):
        raise AssertionError(f"async: update_async waited or read back: "
                             f"{in_dispatch}")
    after = {k: counts[k] - in_dispatch[k] for k in counts}
    if after["cpu"] != 1 or after["synchronize"] or after["item"]:
        raise AssertionError(f"async: result() made {after}, expected one "
                             "readback")
    log(f"async: update_async returned after {1e3 * t_dispatch:.3f} ms with "
        f"no synchronisation and no readback; result() made one readback "
        f"and returned {1e3 * t_total:.3f} ms after the dispatch began "
        f"({sum(len(t) for t in tracks)} tracks)")


def phase_temporal(torch, bundle, assignment_cuda, card, batched_point):
    """TemporalBatchedBoTSORTPipeline at full width, B = 8, T = 2,
    moderate-16, seeded per-stream affines: equal to T chained
    frame_step_batched calls at equal buckets, K2 launched T times a step
    run."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.track.state import empty_stores

    t_batch, n_groups = 2, 5
    nms_cfg = NMSConfig()
    cfgs = (loaded_cfg(TrackerConfig, max_dets=16), nms_cfg, PipelineConfig())
    pipe = host.TemporalBatchedBoTSORTPipeline(bundle, STREAMS, t_batch,
                                               *cfgs)
    rng = np.random.default_rng(2)
    groups = [rng.integers(0, 255, (STREAMS, t_batch) + FRAME_HW + (3,),
                           dtype=np.uint8) for _ in range(n_groups)]
    gmc = np.tile(np.eye(2, 3, dtype=np.float32),
                  (n_groups, STREAMS, t_batch, 1, 1))
    gmc[..., :, 2] += rng.uniform(-8, 8, gmc.shape[:-2] + (2,))
    scale = 1.0 + rng.uniform(-0.02, 0.02, gmc.shape[:-2])
    gmc[..., 0, 0] = gmc[..., 1, 1] = scale
    cuda = assignment_cuda.cascade_solve_cuda
    cuda.launches = cuda.batched_launches = 0

    def check(res):
        if res.det_boxes.shape[:2] != (STREAMS, t_batch):
            raise AssertionError(f"temporal det_boxes {res.det_boxes.shape}")
        for x in (res.det_boxes, res.tracks.tlbr, res.tracks.score):
            if not np.isfinite(x).all():
                raise AssertionError("temporal: non-finite output")

    rows = drive(torch, pipe, groups, lambda: cuda.batched_launches,
                 force_at=3, gmc=gmc, check=check)
    k2_temporal = cuda.batched_launches
    for i, r in enumerate(rows):
        if r["launches"] != expected_launches(r, per_run=t_batch):
            raise AssertionError(
                f"temporal: step {i + 1} launched K2 {r['launches']} times "
                f"over runs {r['runs']} (expected {t_batch} a run)")

    # The reference: T chained frame_step_batched calls at the step's final
    # buckets, each frame's perception taken from the perception of all
    # B*T frames (a convolution at batch B*T is not promised to round like
    # one at batch B).
    stores = empty_stores(cfgs[0], STREAMS, bundle.device)
    for g in range(2):
        frames = torch.from_numpy(groups[g]).to(bundle.device)
        affines = torch.from_numpy(gmc[g]).to(bundle.device)
        rb, fb = rows[g]["runs"][-1][:2]
        with torch.no_grad():
            whole = fs_mod._perception_batched(
                bundle, frames.flatten(0, 1), *cfgs, rb, fb, None)
        res = rows[g]["result"]
        for tt in range(t_batch):
            def sliced(*_, tt=tt):
                pick = lambda x: x.reshape(  # noqa: E731
                    (STREAMS, t_batch) + tuple(x.shape[1:]))[:, tt]
                return fs_mod.Perception(
                    type(whole.dets)(*(pick(x) for x in whole.dets)),
                    *(pick(x) for x in whole[1:]))
            with mock.patch.object(fs_mod, "_perception_batched", sliced):
                stores, one = fs_mod.frame_step_batched(
                    bundle, stores, frames[:, tt], *cfgs, affines[:, tt],
                    rb, fb)
            want = host.to_host(one)
            fields = list(zip(res._fields[:-1], res[:-1], want[:-1])) + list(
                zip(res.tracks._fields, res.tracks, want.tracks))
            for name, x, y in fields:
                if not np.array_equal(x[:, tt], y):
                    raise AssertionError(f"temporal: group {g + 1} frame "
                                         f"{tt + 1} {name} != sequential")
    n_tracks = [[len(t) for t in frame] for frame in rows[-1]["tracks"]]
    log(f"temporal: B={STREAMS} T={t_batch}, seeded affines: the first 2 "
        f"groups equal {t_batch} chained frame_step_batched calls on every "
        f"field; K2 launches per step {[r['launches'] for r in rows]} over "
        f"runs {[r['runs'] for r in rows]}; live tracks of the last group "
        f"{n_tracks}")
    if max(max(n) for n in n_tracks) < 1:
        raise AssertionError("temporal: no live tracks")
    ms = [r["ms"] for r in rows if len(r["runs"]) == 1
          and not r["runs"][0][2]]
    if not ms:
        raise AssertionError("temporal: no steady step to time")
    median = statistics.median(ms)
    fps = STREAMS * t_batch * len(ms) / (sum(ms) / 1000.0)
    log(f"timing: TemporalBatchedBoTSORTPipeline.update ({STREAMS} streams "
        f"x {t_batch} frames, moderate-16, graphed) median {median:.3f} ms "
        f"a step over {len(ms)} steady steps (all: "
        f"{[round(r['ms'], 3) for r in rows]}), {fps:.2f} frames/s; the "
        f"{STREAMS}-stream step of this call: {batched_point[0]:.3f} ms, "
        f"{batched_point[1]:.2f} frames/s; {card}")
    return k2_temporal


def phase_checkpoint(torch, assets, bundle):
    """save_bundle of the full-width bundle, build_bundle back from the
    files: no warning, the three networks' outputs bit-equal."""
    import contextlib
    import io
    import shutil
    import tempfile

    from botsort_tpu_torch.models.fastreid import preprocess

    tmp = tempfile.mkdtemp(prefix="botsort_ckpt_")
    dtype = next(bundle.detector.parameters()).dtype  # the conv weights'
    try:
        paths = assets.save_bundle(bundle, tmp)
        size = sum(os.path.getsize(p) for p in paths)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            back = assets.build_bundle(weights_dir=tmp, seed=123,
                                       device=bundle.device, dtype=dtype)
            missing = assets.build_bundle(
                weights_dir=os.path.join(tmp, "none"), mini=True,
                device=bundle.device, dtype=dtype)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text = err.getvalue()
    if text.count("WARNING: no checkpoint at") != 3 or not all(
            os.path.basename(p) in text for p in paths):
        raise AssertionError(f"checkpoint: warnings were {text!r}")
    del missing
    rng = np.random.default_rng(12)
    dev = bundle.device
    img = torch.from_numpy(rng.uniform(0, 255, (1, 480, 640, 3)).astype(
        np.float32)).to(dev)
    crops = torch.from_numpy(rng.integers(0, 255, (4, 256, 128, 3)).astype(
        np.uint8)).to(dev)
    faces = torch.from_numpy(rng.uniform(0, 255, (4, 128, 128, 3)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        pairs = [("detector boxes", bundle.detector(img)[0],
                  back.detector(img)[0]),
                 ("detector scores", bundle.detector(img)[1],
                  back.detector(img)[1]),
                 ("body features", bundle.body_encoder(preprocess(crops)),
                  back.body_encoder(preprocess(crops))),
                 ("face features", bundle.face_encoder(faces),
                  back.face_encoder(faces))]
    torch.cuda.synchronize()
    for name, want, got in pairs:
        if not torch.equal(want, got) or not torch.isfinite(got).all():
            raise AssertionError(f"checkpoint: {name} differ after the "
                                 "round trip")
    log(f"checkpoint: save_bundle wrote {len(paths)} files, {size} bytes; "
        "build_bundle(weights_dir=...) loaded them with no warning and the "
        "three networks' outputs are bit-equal; a directory without files "
        "gave the three warnings")


def phase_export(torch, bundle, assignment_cuda, bn_act, card):
    """Both NMS programs of one bucket pair exported (runtime/exported.py),
    saved, loaded and replayed from CUDA graphs: load_pipeline at the
    loaded one-stream point (K1) and load_batched_pipeline at 8 streams,
    moderate-16 (K2). Over 8 seeded frames every FrameResult field and the
    final stores equal the live facade's, replayed from graphs at the same
    bucket set; the full NMS program equals the live step's; K1/K2 and K6
    are counted on replay, K6 as often as in the live run."""
    import shutil
    import tempfile

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.runtime import exported

    cuda, k6 = assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda
    tmp = tempfile.mkdtemp(prefix="botsort_export_")
    points = (("one stream, loaded", 0, loaded_cfg(TrackerConfig), 0),
              (f"{STREAMS} streams, moderate-16", STREAMS,
               loaded_cfg(TrackerConfig, max_dets=16), 1))
    try:
        for label, streams, tracker_cfg, seed in points:
            cfgs = (tracker_cfg, NMSConfig(), PipelineConfig())
            d = min(tracker_cfg.max_dets, cfgs[1].max_boxes_per_class)
            full = cfgs[1].pre_nms_top_k
            path = os.path.join(tmp, f"streams{streams}")
            t0 = time.perf_counter()
            manifest = exported.export_all(
                bundle, *cfgs, path, [FRAME_HW], streams=streams,
                buckets=[d], one_stream=not streams, log=lambda *_: None)
            export_s = time.perf_counter() - t0
            entries = manifest["batched_artifacts" if streams
                               else "artifacts"]
            t0 = time.perf_counter()
            programs = exported.Programs(path, bundle, manifest)
            for e in entries:
                programs.program(streams, FRAME_HW, d, d, e["nms_iters"])
            load_s = time.perf_counter() - t0
            ops = sorted({str(n.target) for e in entries
                          for n in programs.exported_program(
                              streams, FRAME_HW, d, d,
                              e["nms_iters"]).graph.nodes
                          if "botsort_tpu_torch" in str(n.target)})
            want_ops = ["botsort_tpu_torch.bn_act.default",
                        "botsort_tpu_torch.cascade_solve.default"]
            if ops != want_ops:
                raise AssertionError(f"export: the graph calls {ops}")
            if streams:
                loaded = exported.load_batched_pipeline(
                    path, bundle, streams, programs=programs)
                live = host.BatchedBoTSORTPipeline(bundle, streams, *cfgs)
                shape = (streams,) + FRAME_HW + (3,)
                launches_of = lambda: cuda.batched_launches  # noqa: E731
                other = lambda: cuda.launches  # noqa: E731
            else:
                loaded = exported.load_pipeline(path, bundle,
                                                programs=programs)
                live = host.BoTSORTPipeline(bundle, *cfgs)
                shape = FRAME_HW + (3,)
                launches_of = lambda: cuda.launches  # noqa: E731
                other = lambda: cuda.batched_launches  # noqa: E731
            live._buckets = [d]  # the exported bucket set
            rng = np.random.default_rng(seed)
            frames = [rng.integers(0, 255, shape, dtype=np.uint8)
                      for _ in range(8)]
            rows, k6_runs = {}, {}
            for mode, pipe in (("live", live), ("loaded", loaded)):
                cuda.launches = cuda.batched_launches = k6.launches = 0
                rows[mode] = drive(torch, pipe, frames, launches_of)
                k6_runs[mode] = k6.launches
                if other():
                    raise AssertionError(f"export {mode}: the other "
                                         "solver kernel launched")
            kernel_launches = sum(r["launches"] for r in rows["loaded"])
            same_results(torch, host, rows["live"], rows["loaded"],
                         live.stores if streams else live.store,
                         loaded.stores if streams else loaded.store,
                         f"export ({label}): loaded != live")
            for i, r in enumerate(rows["loaded"]):
                if r["launches"] != expected_launches(r) or \
                        r["launches"] < 1:
                    raise AssertionError(
                        f"export ({label}): step {i + 1} launched the "
                        f"solver {r['launches']} times over {r['runs']}")
            if k6_runs["loaded"] != k6_runs["live"] or \
                    k6_runs["loaded"] < len(frames):
                raise AssertionError(f"export ({label}): K6 {k6_runs}")
            # The full NMS program (the facades' re-run) on the last
            # frames, from the final stores, against the live step's.
            dev = bundle.device
            frame_dev = torch.from_numpy(frames[-1]).to(dev)
            before = (launches_of(), k6.launches)
            results = [p._step(p.stores if streams else p.store, frame_dev,
                               d, d, None, full)[1].to_host()
                       for p in (live, loaded)]
            same_results(torch, host, [dict(result=results[0])],
                         [dict(result=results[1])], None, None,
                         f"export ({label}): full NMS program")
            if launches_of() - before[0] < 2 or k6.launches == before[1]:
                raise AssertionError(f"export ({label}): the full NMS "
                                     "programs did not launch the kernels")
            nbytes = [e["bytes"] for e in entries]
            secs = [round(e["export_seconds"], 3) for e in entries]
            med = {m: statistics.median(steady_ms(rows[m])) for m in rows}
            log(f"export ({label}): {len(entries)} programs (fixed and "
                f"full NMS count, buckets ({d},{d})) in {export_s:.3f} s "
                f"(each {secs} s), {nbytes} bytes, loaded in {load_s:.3f} s;"
                f" the graph calls {ops}; over {len(frames)} frames "
                f"replayed from graphs every FrameResult field and the "
                f"final stores equal the live facade's, and the full NMS "
                f"program's step equals the live one's; solver launches "
                f"{kernel_launches} over runs "
                f"{[r['runs'] for r in rows['loaded']]}, K6 launches "
                f"{k6_runs['loaded']} (live {k6_runs['live']})")
            log(f"timing: export ({label}): replayed median live "
                f"{med['live']:.3f} ms, loaded {med['loaded']:.3f} ms a "
                f"step in this call; {card}")
            del live, loaded, programs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_serve(torch, bundle, card):
    """cli/serve.py's server on a localhost thread with a numpy decoder,
    its connections sharing one graph cache: cold, and after warm_up has
    captured both NMS programs of every bucket pair at 1080p
    (--warmup_hw). The JSON of 4
    frames equals a pipeline driven directly; prints the first request's
    latency both ways, each pair's capture time and the card's reserved
    memory afterwards."""
    import io
    import socket
    import threading

    from botsort_tpu_torch.cli import serve
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.pipeline.graphed import GraphCache

    cfgs = (loaded_cfg(TrackerConfig), NMSConfig(), PipelineConfig())
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, FRAME_HW + (3,), dtype=np.uint8)
              for _ in range(4)]

    def encode(img):
        buf = io.BytesIO()
        np.save(buf, img)
        return buf.getvalue()

    def decode(data):
        return np.load(io.BytesIO(data))

    direct = host.BoTSORTPipeline(bundle, *cfgs, graphs=False)
    want = [json.loads(serve.tracks_to_json(n + 1, direct.update(f)))
            for n, f in enumerate(frames)]
    out = {}
    for mode in ("cold", "warm"):
        cache = GraphCache(bundle.device)

        def factory(cache=cache):
            return host.BoTSORTPipeline(bundle, *cfgs, graph_cache=cache)

        warmed = []
        if mode == "warm":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            warmed = host.warm_up(factory(), FRAME_HW)
            reserved = torch.cuda.max_memory_reserved()
        server = serve.Server(("127.0.0.1", 0),
                              serve.make_handler(factory, decode))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        answers, ms = [], []
        try:
            with socket.create_connection(server.server_address) as sock:
                for img in frames:
                    t0 = time.perf_counter()
                    serve.send_message(sock, encode(img))
                    answers.append(json.loads(serve.recv_message(sock)))
                    ms.append(1e3 * (time.perf_counter() - t0))
                sock.sendall(b"\0\0\0\0")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
        if answers != want:
            raise AssertionError(f"serve ({mode}): the JSON differs from "
                                 "the direct pipeline's")
        out[mode] = (ms, cache.captures, warmed)
        del cache
        torch.cuda.empty_cache()
    ms_cold, caps_cold, _ = out["cold"]
    ms_warm, caps_warm, warmed = out["warm"]
    n_tracks = [len(a["tracks"]) for a in want]
    log(f"serve: {len(frames)} frames over one connection, cold and after "
        f"warm_up: the JSON equals the direct pipeline's ({n_tracks} "
        f"tracks); warm_up captured {len(warmed)} steps (both NMS programs "
        f"of {len({k[:2] for k, _ in warmed})} bucket pairs), {caps_warm} "
        f"graphs in all (cold server: {caps_cold})")
    log(f"timing: serve: first request {ms_cold[0]:.3f} ms cold, "
        f"{ms_warm[0]:.3f} ms after warm_up; later requests "
        f"{[round(x, 3) for x in ms_warm[1:]]} ms; capture seconds per "
        f"(reid bucket, face bucket, NMS count) "
        f"{[(k, round(t, 3)) for k, t in warmed]}; "
        f"torch.cuda.max_memory_reserved after all of them {reserved} B; "
        f"{card}")


def phase_store(torch, bundle):
    """save_session after 4 of 8 frames (runtime/checkpoint.py's
    save_store with the bucket hint), load_store, load_session into a new
    facade and the last 4 frames: every FrameResult field and the final
    store equal an uninterrupted run's."""
    import shutil
    import tempfile

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.pipeline.graphed import GraphCache
    from botsort_tpu_torch.runtime import checkpoint

    cfgs = (loaded_cfg(TrackerConfig), NMSConfig(), PipelineConfig())
    cache = GraphCache(bundle.device)

    def make():
        return host.BoTSORTPipeline(bundle, *cfgs, graph_cache=cache)

    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 255, FRAME_HW + (3,), dtype=np.uint8)
              for _ in range(8)]
    whole, first = make(), make()
    want = []
    for f in frames:
        whole.update(f)
        want.append(dict(result=whole.last_result))
    for f in frames[:4]:
        first.update(f)
    tmp = tempfile.mkdtemp(prefix="botsort_store_")
    try:
        path = os.path.join(tmp, "session.pt")
        t0 = time.perf_counter()
        first.save_session(path)
        save_ms = 1e3 * (time.perf_counter() - t0)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        store = checkpoint.load_store(path, bundle.device)
        load_ms = 1e3 * (time.perf_counter() - t0)
        same_results(torch, host, [], [], first.store, store,
                     "store: load_store != the saved store")
        resumed = make()
        if not resumed.load_session(path):
            raise AssertionError("store: no session at the saved path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = []
    for f in frames[4:]:
        resumed.update(f)
        got.append(dict(result=resumed.last_result))
    same_results(torch, host, want[4:], got, whole.store, resumed.store,
                 "store: resumed != uninterrupted")
    log(f"store: save_session after 4 of {len(frames)} frames ({size} B, "
        f"{save_ms:.3f} ms), load_store ({load_ms:.3f} ms) equal to the "
        f"saved store, load_session into a new facade: the last 4 frames "
        f"and the final store equal the uninterrupted run's "
        f"({len(resumed.last_result.tracks.valid.nonzero()[0])} live "
        f"tracks)")


def phase_oproute(torch, bundle, assignment_cuda, bn_act, dispatchers,
                  card):
    """The loaded one-stream point run eagerly over 8 frames, four times:
    with every dispatcher in ``dispatchers`` (the modules that hold one)
    calling its kernel's wrapper directly, as eager calls do, and with
    each routed through its custom op, as a trace is (their ``tracing``
    patched to say so), in the order direct, op, op, direct. Every
    FrameResult field, the final stores and the K1 and K6 launches are
    equal across the runs; prints each run's median and the two routes'
    (the dispatcher's host cost on the eager step)."""
    import contextlib

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import host

    cuda, k6 = assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda
    cfgs = (loaded_cfg(TrackerConfig), NMSConfig(), PipelineConfig())
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, FRAME_HW + (3,), dtype=np.uint8)
              for _ in range(8)]
    runs = []
    for route in ("direct", "op", "op", "direct"):
        pipe = host.BoTSORTPipeline(bundle, *cfgs, graphs=False)
        with contextlib.ExitStack() as stack:
            if route == "op":
                for m in dispatchers:
                    stack.enter_context(
                        mock.patch.object(m, "tracing", lambda: True))
            cuda.launches = cuda.batched_launches = k6.launches = 0
            rows = drive(torch, pipe, frames, lambda: cuda.launches)
        runs.append((route, rows, pipe.store,
                     (cuda.launches, cuda.batched_launches, k6.launches)))
    _, rows0, store0, launches0 = runs[0]
    for route, rows, store, launches in runs[1:]:
        same_results(torch, host, rows0, rows, store0, store,
                     f"oproute: the {route} route's run differs")
        if launches != launches0:
            raise AssertionError(f"oproute: launches (K1, K2, K6) "
                                 f"{launches} against {launches0}")
    if launches0[0] < len(frames) or launches0[1] or launches0[2] < 1:
        raise AssertionError(f"oproute: launches (K1, K2, K6) {launches0}")
    med = {}
    for route, rows, _, _ in runs:
        med.setdefault(route, []).extend(steady_ms(rows))
    each = [(route, round(statistics.median(steady_ms(rows)), 3))
            for route, rows, _, _ in runs]
    d, o = (statistics.median(med[r]) for r in ("direct", "op"))
    calls = (launches0[0] + launches0[2]) / len(frames)
    log(f"oproute: {len(frames)} eager frames at the loaded one-stream "
        f"point, kernels called directly and through torch.ops."
        f"botsort_tpu_torch, runs in the order direct, op, op, direct: "
        f"every FrameResult field, the final stores and the launches equal "
        f"(K1, K2, K6 per run: {launches0})")
    log(f"timing: oproute: eager one-stream step median {d:.3f} ms direct, "
        f"{o:.3f} ms through the custom ops ({o - d:+.3f} ms, "
        f"{1e3 * (o - d) / calls:+.1f} us a kernel call over {calls:.1f} "
        f"calls a frame); each run's median {each}, spread of the direct "
        f"runs' steady frames {min(med['direct']):.3f}-"
        f"{max(med['direct']):.3f} ms; {card}")


class NormRecorder:
    """Records (shape, dtype, activation) of every BatchNorm call of a
    bundle's networks."""

    def __init__(self, bundle, BatchNorm):
        self.calls = {}
        self.handles = [m.register_forward_pre_hook(self)
                        for net in (bundle.detector, bundle.body_encoder,
                                    bundle.face_encoder)
                        for m in net.modules() if isinstance(m, BatchNorm)]

    def __call__(self, module, args):
        act = args[1] if len(args) > 1 else "none"
        key = (tuple(args[0].shape), args[0].dtype, act)
        self.calls[key] = self.calls.get(key, 0) + 1

    def remove(self):
        for h in self.handles:
            h.remove()


def eager_chain(torch, F, x, mean, var, weight, bias, eps, act):
    """The PyTorch calls the networks made for one norm and activation
    before K6 (K6's yardstick; nothing in the port calls this)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + eps) * weight
    y = (x.float() - mean.view(shape)) * mul.view(shape)
    y = (y + bias.view(shape)).to(x.dtype)
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    return y


def ulp_apart(torch, got, want):
    """Largest distance of two tensors of one floating dtype in units in
    the last place (their bit patterns as ordered integers)."""
    int_t = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    mask = 2 ** (8 * got.element_size() - 1) - 1
    a, b = (t.contiguous().view(int_t).to(torch.int64) for t in (got, want))
    a, b = (torch.where(t < 0, -(t & mask), t) for t in (a, b))
    return int((a - b).abs().max())


def phase_k6(torch, F, bn_act, bundle, multi_pipe, frames, cfgs, card):
    """K6 against bn_act_plain on every norm shape of an 8-stream step
    (recorded from the networks) and on odd shapes, in float32 and
    bfloat16 with the four activations; then its time over one step's norms
    against the plain version, the eager chain it replaced and its bound.
    Returns (max abs error, (ms, plain ms, bound ms, bound by, library
    ms))."""
    from botsort_tpu_torch.models.common import BatchNorm
    from botsort_tpu_torch.pipeline import frame_step as fs_mod

    dev = bundle.device
    recorder = NormRecorder(bundle, BatchNorm)
    try:
        frames_dev = torch.from_numpy(frames).to(dev)
        d = cfgs[0].max_dets
        fs_mod.frame_step_batched(bundle, multi_pipe.stores, frames_dev,
                                  *cfgs, reid_bucket=d, face_bucket=d)
    finally:
        recorder.remove()
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(66)

    def draw(shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, device=dev, generator=gen)
        return lo + (hi - lo) * torch.rand(shape, device=dev, generator=gen)

    cases = [(shape, dtype, act, n) for (shape, dtype, act), n in
             sorted(recorder.calls.items(), key=str)]
    n_path = len(cases)
    odd = [(3, 7, 5, 3), (2, 1280, 15, 20), (5, 33), (1, 1, 1, 1),
           (2, 6, 9, 13)]
    cases += [(shape, dtype, act, 0) for shape in odd
              for dtype in (torch.float32, torch.bfloat16)
              for act in bn_act.ACTS]
    max_err, worst_ulp = 0.0, 0
    totals = dict(ms=0.0, graph=0.0, plain=0.0, lib=0.0, bytes=0, flops=0,
                  calls=0)
    for k, (shape, dtype, act, count) in enumerate(cases):
        c = shape[1]
        x = (2.0 * draw(shape)).to(dtype)
        mean, bias = 0.5 * draw((c,)), 0.5 * draw((c,))
        var, weight = draw((c,), 0.3, 1.8), draw((c,), 0.3, 1.8)
        mul = torch.rsqrt(var + 1e-3) * weight
        got = bn_act.bn_act_cuda(x, mean, mul, bias, act)
        want = bn_act.bn_act_plain(x, mean, mul, bias, act)
        torch.cuda.synchronize()
        ulps = ulp_apart(torch, got, want)
        if ulps > (1 if act == "silu" else 0) or (
                act != "silu" and not torch.equal(got, want)):
            raise AssertionError(f"K6 != plain on {shape} {dtype} {act}: "
                                 f"{ulps} units in the last place")
        worst_ulp = max(worst_ulp, ulps)
        max_err = max(max_err, float((got.float() - want.float()).abs()
                                     .max()))
        if count:
            reps = 20 if x.numel() < 2 ** 24 else 5
            ms = event_ms(torch, lambda: bn_act.bn_act_cuda(
                x, mean, mul, bias, act), reps)
            plain = event_ms(torch, lambda: bn_act.bn_act_plain(
                x, mean, mul, bias, act), reps)
            lib = event_ms(torch, lambda: eager_chain(
                torch, F, x, mean, var, weight, bias, 1e-3, act), reps)
            totals["ms"] += count * ms
            totals["graph"] += count * graph_ms(
                torch, lambda: bn_act.bn_act_cuda(x, mean, mul, bias, act),
                10, 5)
            totals["plain"] += count * plain
            totals["lib"] += count * lib
            # One read and one write of the activation and the three
            # per-channel vectors; subtract, multiply, add and at most
            # four more operations for the activation per element.
            totals["bytes"] += count * (2 * x.numel() * x.element_size()
                                        + 3 * c * 4)
            totals["flops"] += count * 7 * x.numel()
            totals["calls"] += count
    b_ms, b_by = bound(totals["bytes"], totals["flops"], F32_FLOPS)
    top = sorted(((n * int(np.prod(shape)), shape, str(dtype)[6:], act, n)
                  for shape, dtype, act, n in cases[:n_path]),
                 reverse=True)[:4]
    log(f"K6: {len(cases)} cases equal to the plain version ({n_path} norm "
        f"shapes of an {STREAMS}-stream step, {len(odd)} odd shapes x 2 "
        "dtypes x 4 activations): none / ReLU / ReLU6 bit for bit, SiLU "
        f"within {worst_ulp} unit in the last place")
    log(f"timing: K6 over the {totals['calls']} norms of one {STREAMS}-"
        f"stream moderate-16 step ({n_path} shapes; the largest by elements "
        f"x calls: {[t[1:] for t in top]}): kernel {totals['ms']:.4f} ms "
        f"eager, {totals['graph']:.4f} ms from CUDA graphs (eager minus "
        f"graph, the wrapper's host cost: "
        f"{totals['ms'] - totals['graph']:.4f} ms), plain "
        f"{totals['plain']:.4f} ms, the eager chain it replaced "
        f"{totals['lib']:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({totals['bytes'] / 1e6:.2f} MB: "
        f"{totals['bytes'] / totals['graph'] / 1e9:.3f} TB/s from graphs); "
        f"{card}")
    return max_err, (totals["ms"], totals["plain"], b_ms, b_by,
                     totals["lib"])


def phase_k5(torch, facereid_dw, dev):
    """K5 against dw_conv3x3_plain on the card, bit for bit; returns the
    13 face-encoder inputs at N_FACES (for the timings) and the max abs
    error (0)."""
    rng = np.random.default_rng(55)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [((N_FACES, c, h, w), bf16) for h, w, c in FACE_DW_SHAPES]
    cases += [((1, 8, 9, 13), f32), ((1, 8, 9, 13), bf16),
              ((4, 130, 6, 10), f32), ((4, 130, 6, 10), bf16),
              ((2, 1100, 5, 7), bf16), ((3, 40, 12, 24), bf16),
              ((1, 100, 16, 16), bf16), ((2, 33, 4, 4), bf16),
              ((2, 12, 6, 2), f32)]
    face_inputs, max_err = [], 0.0
    for k, (shape, dtype) in enumerate(cases):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            dev, dtype)
        taps = torch.from_numpy(rng.normal(size=(9, shape[1])).astype(
            np.float32)).to(dev)
        got = facereid_dw.dw_conv3x3_cuda(x, taps)
        want = facereid_dw.dw_conv3x3_plain(x, taps)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if err != 0.0 or not torch.equal(got, want):
            raise AssertionError(f"K5 != plain on {shape} {dtype}: max abs "
                                 f"error {err}")
        max_err = max(max_err, err)
        if k < len(FACE_DW_SHAPES):
            face_inputs.append((x, taps))
    log(f"K5: {len(cases)} cases equal to the plain version bit for bit "
        f"(13 face-encoder shapes at N={N_FACES}, odd shapes in float32 and "
        "bfloat16, C=1100, a partial span, narrow planes)")
    return face_inputs, max_err


def stem_trunk(torch, assets, fastreid, cast_compute, dev, seed):
    """A ResNeSt50 of K4_LAYOUT with seeded weights and perturbed batch
    norms, bfloat16 on the card."""
    rng = np.random.default_rng(seed)
    model = fastreid.ResNeSt50(**K4_LAYOUT, fused_stem=True)
    assets.perturb_norms_(assets.seeded_init_(model, rng), rng)
    return cast_compute(model, torch.bfloat16).to(dev).eval() \
        .requires_grad_(False)


def unfused_segment(torch, F, model, x_nhwc):
    """The port's unfused modules for the same segment: the stem's three
    _ConvBNs, the max pool and SplAtBottleneck_0..2 (cuDNN, bfloat16)."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = model._ConvBN_2(model._ConvBN_1(model._ConvBN_0(x)))
    x = F.max_pool2d(x, 3, 2, 1)
    for i in range(3):
        x = getattr(model, f"SplAtBottleneck_{i}")(x)
    return x


def rel_err(torch, got, want):
    """(relative L2 error, max abs error / max |want|, max abs error)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return (float((got - want).norm() / want.norm()),
            float(diff.max() / want.abs().max()), float(diff.max()))


def phase_k4(torch, F, assets, fastreid, fastreid_fused, cast_compute,
             dev):
    """K4 against stem_stage1_plain and against the unfused modules on the
    card; returns the model and the largest abs error against plain."""
    model = stem_trunk(torch, assets, fastreid, cast_compute, dev, 44)
    folded = model.folded_stem_stage1()
    rng = np.random.default_rng(45)
    max_abs = 0.0
    with torch.no_grad():
        for n, h, w in K4_CASES:
            x = torch.from_numpy(rng.normal(0, 1, (n, h, w, 3)).astype(
                np.float32)).to(dev, torch.bfloat16)
            got = fastreid_fused.stem_stage1_cuda(x, folded)
            again = fastreid_fused.stem_stage1_cuda(x, folded)
            want = fastreid_fused.stem_stage1_plain(x, folded)
            ref = unfused_segment(torch, F, model, x)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"K4 non-finite at N={n} {h}x{w}")
            if not torch.equal(got, again):
                raise AssertionError(f"K4 gave other bits on a second call "
                                     f"at N={n} {h}x{w}")
            rel, worst, abs_err = rel_err(torch, got, want)
            rel_u, worst_u, _ = rel_err(torch, got, ref)
            log(f"K4: N={n} {h}x{w}: vs plain relative L2 {rel:.3e}, max "
                f"{worst:.3e} of scale (abs {abs_err:.4g}); vs unfused "
                f"modules {rel_u:.3e}, max {worst_u:.3e}; a second call "
                "gives the same bits")
            if rel > 1e-2 or worst > 0.05:
                raise AssertionError(f"K4 differs from plain at N={n} "
                                     f"{h}x{w}")
            if rel_u >= 3e-2 or worst_u >= 0.15:
                raise AssertionError(f"K4 differs from the unfused modules "
                                     f"at N={n} {h}x{w}")
            max_abs = max(max_abs, abs_err)
    return model, max_abs


class CallCounter:
    """Counts a module's forward calls and keeps a copy of the last
    call's input."""

    def __init__(self, module):
        self.calls = 0
        self.last_input = None
        module.register_forward_pre_hook(self)

    def __call__(self, module, args):
        self.calls += 1
        self.last_input = args[0].detach().clone()


def phase_lowered(torch, bundle, assignment_cuda, fastreid_fused,
                  facereid_dw, card, unlowered, arch):
    """The 8-stream path with both lowered encoders of the bundle's
    architecture ``arch`` (assets.FULL), replayed from CUDA graphs; returns
    the K4 and K5 launch counts of its run."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.models.common import cast_compute
    from botsort_tpu_torch.models.facereid import FaceReID
    from botsort_tpu_torch.models.fastreid import FastReIDSBS
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.pipeline.frame_step import ModelBundle
    from botsort_tpu_torch.pipeline.host import BatchedBoTSORTPipeline
    from botsort_tpu_torch.track.state import empty_stores

    dev = bundle.device
    encoders = []
    for lowered, main in (
            (FastReIDSBS(**arch["body"], fused_stem=True),
             bundle.body_encoder),
            (FaceReID(**arch["face"], dw_mode="kernel"),
             bundle.face_encoder)):
        cast_compute(lowered, torch.bfloat16).to(dev).eval() \
            .requires_grad_(False)
        lowered.load_state_dict(main.state_dict())
        encoders.append(lowered)
    body, face = encoders
    # The face encoder's stride-1 depthwise layers: K5 launches per call.
    n_dw = sum(1 for m in face.modules() if getattr(m, "dw_kernel", False))
    if not arch["face"] and n_dw != len(FACE_DW_SHAPES):  # the default
        raise AssertionError(f"{n_dw} K5 layers in the full face encoder")
    cfgs = (loaded_cfg(TrackerConfig, max_dets=16), NMSConfig(),
            PipelineConfig())
    lowered_bundle = ModelBundle(bundle.detector, body, face)
    pipeline = BatchedBoTSORTPipeline(lowered_bundle, STREAMS, *cfgs)
    rng = np.random.default_rng(1)  # phase_multi's frames
    steps = [rng.integers(0, 255, (STREAMS,) + FRAME_HW + (3,), dtype=np.uint8)
             for _ in range(6)]
    k4, k5 = fastreid_fused.stem_stage1_cuda, facereid_dw.dw_conv3x3_cuda
    cuda = assignment_cuda.cascade_solve_cuda
    k4.launches = k5.launches = 0
    cuda.launches = cuda.batched_launches = 0
    rows = drive(torch, pipeline, steps,
                 lambda: np.array([k4.launches, k5.launches,
                                   cuda.batched_launches]), force_at=3)
    k4_launches, k5_launches = k4.launches, k5.launches
    if cuda.launches:
        raise AssertionError("the lowered 8-stream path launched K1")
    table = []
    for r in rows:
        want = (expected_launches(r, ran=lambda b: b[0] is None or b[0] > 0),
                expected_launches(r, n_dw,
                                  ran=lambda b: b[1] is None or b[1] > 0),
                expected_launches(r))
        table.append(dict(runs=r["runs"], k4=int(r["launches"][0]),
                          k5=int(r["launches"][1]),
                          k2=int(r["launches"][2]),
                          tracks=sum(len(t) for t in r["tracks"])))
        if tuple(r["launches"]) != want:
            raise AssertionError(
                f"lowered: a step launched K4, K5, K2 {tuple(r['launches'])} "
                f"times, expected {want} (K4 once and K5 {n_dw} times per "
                f"step run with crops, K2 once per step run): {r['runs']}")
    log(f"lowered: per step {json.dumps(table)}")
    if min(t["k4"] for t in table) < 1 or min(t["k5"] for t in table) < 1:
        raise AssertionError("a lowered step ran without K4 or K5")
    if max(t["tracks"] for t in table) < 1:
        raise AssertionError("no live tracks on the lowered path")

    # The last step's frames once more through the eager step with call
    # counters on the encoders, then the encoders' inputs again with K4 and
    # K5 replaced by their plain versions on the card; the features of both
    # runs compared, and K4's own output on the body input (random weights
    # can make every body feature alike, which would hide a stem fault).
    body_calls, face_calls = CallCounter(body), CallCounter(face)
    d = cfgs[0].max_dets
    fs_mod.frame_step_batched(
        lowered_bundle, empty_stores(cfgs[0], STREAMS, dev),
        torch.from_numpy(steps[-1]).to(dev), *cfgs, reid_bucket=d,
        face_bucket=d)
    if body_calls.calls != 1 or face_calls.calls != 1:
        raise AssertionError("an encoder did not run once in a step")
    body_in, face_in = body_calls.last_input, face_calls.last_input
    stem_in = body_in.to(torch.bfloat16).contiguous()
    folded = body.ResNeSt50_0.folded_stem_stage1()
    with torch.no_grad():
        body_k, face_k = body(body_in), face(face_in)
        stem_k = fastreid_fused.stem_stage1_cuda(stem_in, folded)
        with mock.patch.object(fastreid_fused, "stem_stage1_cuda",
                               fastreid_fused.stem_stage1_plain), \
                mock.patch.object(facereid_dw, "dw_conv3x3_cuda",
                                  facereid_dw.dw_conv3x3_plain):
            body_p, face_p = body(body_in), face(face_in)
        stem_p = fastreid_fused.stem_stage1_plain(stem_in, folded)
    torch.cuda.synchronize()
    face_err = float((face_k - face_p).abs().max())
    body_rel = float((body_k - body_p).norm() / body_p.norm())
    stem_rel, stem_worst, _ = rel_err(torch, stem_k, stem_p)
    spread = float((body_k - body_k.mean(0)).norm() / body_k.norm())
    log(f"lowered: last step's features re-run with the plain K4 and K5: "
        f"face ({face_in.shape[0]} crops) max abs difference {face_err:.3g}"
        f" ({'equal' if torch.equal(face_k, face_p) else 'not equal'}), "
        f"body ({body_in.shape[0]} crops) relative L2 {body_rel:.3e}; K4's "
        f"output on those crops vs plain: relative L2 {stem_rel:.3e}, max "
        f"{stem_worst:.3e} of scale; body features' spread across crops "
        f"(|f - mean| / |f|) {spread:.3e}")
    if face_err > 1e-6:
        raise AssertionError("face features differ from the plain K5 run")
    if body_rel > 1e-2:
        raise AssertionError("body features differ from the plain K4 run")
    if stem_rel > 1e-2 or stem_worst > 0.05:
        raise AssertionError("K4 differs from plain on the path's crops")

    ms = steady_ms(rows)
    median = statistics.median(ms)
    fps = STREAMS * len(ms) / (sum(ms) / 1000.0)
    log(f"timing: lowered BatchedBoTSORTPipeline.update ({STREAMS} streams, "
        f"graphed) median {median:.3f} ms over {len(ms)} steady steps (all: "
        f"{[round(r['ms'], 3) for r in rows]}), {fps:.2f} frames/s; "
        f"unlowered graphed in this call: median {unlowered[0]:.3f} ms, "
        f"{unlowered[1]:.2f} frames/s; {card}")
    return k4_launches, k5_launches


# The CUDA kernels of one K4 call, in launch order.
K4_KERNELS = ["stem0", "stem1", "stem2", "maxpool"] + [
    f"block{b}.{part}" for b in range(3)
    for part in ("in", "split", "attention", "out")]


def k4_layer_bytes(n, h, w, sw, width):
    """Bytes a layer-by-layer K4 has to move through device memory: every
    layer's input read once and its output written once (block 0 reads the
    pooled stem for its first 1x1 and again for its shortcut; blocks 1 and 2
    read their input as the residual too), and the weights."""
    s1, s2 = n * (h // 2) * (w // 2), n * (h // 4) * (w // 4)
    x, stem, stem2 = n * h * w * 3, s1 * sw, s1 * 2 * sw
    pooled, t, y, out = s2 * 2 * sw, s2 * width, s2 * 2 * width, s2 * 4 * width
    written = stem + stem + stem2 + pooled + 3 * (t + y + out)
    read = (x + stem + stem + stem2            # the stem and the pool
            + (pooled + t + y + pooled)        # block 0
            + 2 * (out + t + y + out))         # blocks 1 and 2
    return 2 * (written + read)


def k4_split(torch, fastreid_fused, k4, x, folded, card):
    """One K4 call under torch.profiler: device time of each of its CUDA
    kernels, and each convolution's achieved TFLOP/s."""
    from torch.profiler import ProfilerActivity, profile

    n, h, w, _ = x.shape
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # A torch.profiler run can lose the events of its first
            # milliseconds: the last call is the one read, and a run that
            # lost some of its events is made again.
            for _ in range(3):
                k4(x, folded)
                torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "kernel" in e.name]
        events.sort(key=lambda e: e.time_range.start)
        events = events[-len(K4_KERNELS):]
        if len(events) == len(K4_KERNELS):
            break
    if len(events) != len(K4_KERNELS):
        raise AssertionError(
            f"K4 ran {len(events)} CUDA kernels under the profiler, expected "
            f"{len(K4_KERNELS)}: {[e.name[:40] for e in events]}")
    flops = {}
    for sp in fastreid_fused.conv_specs(folded.stem_width, folded.width):
        name = "block0.out" if sp.name == "block0.shortcut" else sp.name
        pixels = n * (h >> sp.level) * (w >> sp.level)
        flops[name] = flops.get(name, 0) + (
            2 * pixels * sp.cout * (sp.cin // sp.groups) * sp.ksize ** 2)
    plans = {p.name: p for p in fastreid_fused.conv_plan(
        n, h, w, folded.stem_width, folded.width)}
    total = 0.0
    for label, ev in zip(K4_KERNELS, events):
        us = getattr(ev, "device_time", None)
        if us is None:
            us = ev.cuda_time
        total += us
        found = re.search(r"\w+_kernel(<[^>]*>)?", ev.name)
        short = found.group(0) if found else ev.name[:40]
        line = f"timing: K4 split N={n}: {label:16s} {us:8.1f} us  {short}"
        if label in flops:
            plan = plans[label]
            line += (f"  {flops[label] / us / 1e6:.1f} TFLOP/s, path "
                     f"{plan.path}, tile {plan.m_tile}x{plan.n_tile}, grid "
                     f"{plan.grid}, {plan.smem} B shared")
        log(line)
    if total <= 0.0:
        raise AssertionError("torch.profiler gave K4's kernels no device "
                             "time")
    log(f"timing: K4 split N={n}: {len(events)} kernels, {total / 1e3:.4f} "
        f"ms of device time in all; {card}")


def phase_encoder_timing(torch, F, fastreid_fused, facereid_dw, k4_model,
                         face_inputs, card):
    """CUDA-event times of K4 and K5 against their plain versions, with
    the bounds; returns {name: (ms, plain ms, bound ms, bound by, library
    ms)}."""
    out = {}
    folded = k4_model.folded_stem_stage1()
    rng = np.random.default_rng(46)
    k4 = fastreid_fused.stem_stage1_cuda
    for n in K4_TIMING_N:
        x = torch.from_numpy(rng.normal(0, 1, (n, 256, 128, 3)).astype(
            np.float32)).to(k4_model._ConvBN_0.Conv_0.weight.device,
                            torch.bfloat16)
        with torch.no_grad():
            ms = event_ms(torch, lambda: k4(x, folded), 20)
            plain = event_ms(torch, lambda: fastreid_fused.stem_stage1_plain(
                x, folded), 3)
            unfused = event_ms(torch, lambda: unfused_segment(
                torch, F, k4_model, x), 10)
            dev_ms = graph_ms(torch, lambda: k4(x, folded), 5, 4)
            dev_unfused = graph_ms(torch, lambda: unfused_segment(
                torch, F, k4_model, x), 5, 4)
        # Convolution FLOPs at each conv's output size: the stem's at
        # H/2 x W/2, stage 1's at H/4 x W/4.
        stage1 = [c for b in folded.blocks for c in
                  (b.conv_in, b.conv_split, b.conv_out, b.shortcut)
                  if c is not None]
        flops = sum(2 * n * hw * fc.weight.numel()
                    for convs, hw in ((folded.stem, 128 * 64),
                                      (stage1, 64 * 32)) for fc in convs)
        weights = sum(t.numel() * t.element_size()
                      for t in fastreid_fused._kernel_tensors(folded)
                      if t is not None)
        nbytes = (x.numel() * 2 + n * 4 * folded.width * 64 * 32 * 2
                  + weights)
        b_ms, b_by = bound(nbytes, flops, BF16_TC_FLOPS)
        sw, width = folded.stem_width, folded.width
        layer_bytes = k4_layer_bytes(n, 256, 128, sw, width) + weights
        scratch = fastreid_fused.stem_stage1_scratch_bytes(n, 256, 128, sw,
                                                           width)
        log(f"timing: K4 N={n} 256x128: kernel {ms:.4f} ms "
            f"({len(K4_KERNELS)} CUDA kernels per call), plain PyTorch on "
            f"the card {plain:.3f} ms, the unfused modules (cuDNN, context "
            f"only) {unfused:.4f} ms; replayed from a CUDA graph: kernel "
            f"{dev_ms:.4f} ms, unfused {dev_unfused:.4f} ms; eager minus "
            f"graph: kernel {ms - dev_ms:.4f} ms; bound {b_ms:.4f} ms by "
            f"{b_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); the "
            f"layers' own bytes {layer_bytes / 1e6:.1f} MB: at least "
            f"{layer_bytes / HBM_BYTES_S * 1e3:.4f} ms layer by layer; "
            f"scratch {scratch} B; {card}")
        out[f"K4@{n}"] = (ms, plain, b_ms, b_by, None)
        if n == K4_TIMING_N[-1]:
            with torch.no_grad():
                k4_split(torch, fastreid_fused, k4, x, folded, card)

    totals = [0.0] * 5
    all_bytes = all_flops = 0
    for x, taps in face_inputs:
        n, c, h, w = x.shape
        weight = taps.t().reshape(c, 1, 3, 3).to(x.dtype).contiguous()
        ms = event_ms(torch, lambda: facereid_dw.dw_conv3x3_cuda(x, taps),
                      50)
        plain = event_ms(torch, lambda: facereid_dw.dw_conv3x3_plain(
            x, taps), 5)
        lib = event_ms(torch, lambda: F.conv2d(x, weight, padding=1,
                                               groups=c), 50)
        dev_ms = graph_ms(torch, lambda: facereid_dw.dw_conv3x3_cuda(
            x, taps))
        dev_lib = graph_ms(torch, lambda: F.conv2d(x, weight, padding=1,
                                                   groups=c))
        # Input and output once each, the taps once; nine multiplies and
        # nine adds per output in float32.
        nbytes = 2 * x.numel() * x.element_size() + taps.numel() * 4
        b_ms, b_by = bound(nbytes, 18 * x.numel(), F32_FLOPS)
        all_bytes += nbytes
        all_flops += 18 * x.numel()
        plan = facereid_dw.dw_plan(x.shape, x.element_size())
        log(f"timing: K5 N={n} {h}x{w}x{c}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, F.conv2d(groups=C) {lib:.4f} ms; from a CUDA "
            f"graph: kernel {dev_ms:.4f} ms ({nbytes / dev_ms / 1e9:.3f} "
            f"TB/s), F.conv2d {dev_lib:.4f} ms; eager minus graph: kernel "
            f"{ms - dev_ms:.4f} ms, F.conv2d {lib - dev_lib:.4f} ms; bound "
            f"{b_ms:.4f} ms by {b_by}; plan {tuple(plan)}")
        for i, v in enumerate((ms, plain, lib, dev_ms, dev_lib)):
            totals[i] += v
    b_ms, b_by = bound(all_bytes, all_flops, F32_FLOPS)
    log(f"timing: K5 all 13 layers at N={N_FACES}: kernel {totals[0]:.4f} "
        f"ms, plain {totals[1]:.4f} ms, F.conv2d(groups=C) {totals[2]:.4f} "
        f"ms; from CUDA graphs: kernel {totals[3]:.4f} ms, F.conv2d "
        f"{totals[4]:.4f} ms; eager minus graph: kernel "
        f"{totals[0] - totals[3]:.4f} ms, F.conv2d "
        f"{totals[2] - totals[4]:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({all_bytes / 1e6:.2f} MB, {all_flops / 1e9:.3f} GFLOP); {card}")
    out["K5"] = (totals[0], totals[1], b_ms, b_by, totals[2])
    return out


def pops_per_solve(torch, assignment, plain, args):
    """Dijkstra pops of one plain solve on CPU copies of args (the count
    depends only on the data): the kernels' sequential steps."""
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    before = assignment.jv_solve_plain.pops
    plain(*cpu)
    return assignment.jv_solve_plain.pops - before


def phase_timing(torch, assignment, assignment_cuda, k1_inputs, k2_batches,
                 k3_inputs, card):
    """CUDA-event times of each solver kernel and its plain version on the
    card, at the main paths' shapes, with the pops each solve takes;
    returns {kernel: (ms, plain ms, bound ms, bound by, library ms)}."""
    cuda = assignment_cuda.cascade_solve_cuda
    jv = assignment_cuda.jv_solve_cuda
    k2_args = [b[1] for b in k2_batches[:3]]
    rows = {
        "K1": ([lambda a=a: cuda(*a) for a in k1_inputs],
               [lambda a=a: assignment.cascade_solve_plain(*a)
                for a in k1_inputs]),
        "K2": ([lambda a=a: cuda(*a) for a in k2_args],
               [lambda a=a: assignment.cascade_solve_plain(*a)
                for a in k2_args]),
        "K3": ([lambda a=a: jv(*a) for a in k3_inputs],
               [lambda a=a: assignment.jv_solve_plain(*a)
                for a in k3_inputs]),
    }
    shapes = {"K1": f"N={N_TRACKS} D={N_DETS}",
              "K2": f"{STREAMS} streams, N={N_TRACKS} D={N_DETS}",
              "K3": f"S={N_TRACKS + N_DETS}"}
    # Pops per solve: a K2 batch waits for its slowest stream, so its
    # critical path is the largest stream's count.
    cascade_pops = lambda a: pops_per_solve(  # noqa: E731
        torch, assignment, assignment.cascade_solve_plain, a)
    pops = {
        "K1": [cascade_pops(a) for a in k1_inputs],
        "K2": [max(cascade_pops((c[s:s + 1], m[s:s + 1], b[s:s + 1], lim))
                   for s in range(STREAMS)) for c, m, b, lim in k2_args],
        "K3": [pops_per_solve(torch, assignment, assignment.jv_solve_plain,
                              a) for a in k3_inputs],
    }
    # Bytes: every input read once, every output written once. The
    # operations a solve needs depend on its data; at least one look at
    # each cost entry per pass, far below the bytes' time on this card.
    n, d, s = N_TRACKS, N_DETS, N_TRACKS + N_DETS
    k1_bytes = 4 * (3 * n * d + 3 * (n + d) + 1) + 4 * 3 * (n + d)
    work = {"K1": (k1_bytes, 3 * n * d),
            "K2": (STREAMS * k1_bytes, STREAMS * 3 * n * d),
            "K3": (4 * (s * s + 2 * s + 1) + 4 * s, s * s)}
    out = {}
    for name, (kernel, plain) in rows.items():
        k_ms = statistics.median(event_ms(torch, f, 50) for f in kernel)
        p_ms = statistics.median(event_ms(torch, f, 1) for f in plain)
        b_ms, b_by = bound(*work[name], F32_FLOPS)
        med_pops = statistics.median(pops[name])
        log(f"timing: {name} {shapes[name]}: kernel {k_ms:.4f} ms, plain "
            f"PyTorch on the card {p_ms:.3f} ms (medians over "
            f"{len(kernel)} inputs), bound {b_ms:.6f} ms by {b_by}; pops "
            f"per solve{' (slowest stream)' if name == 'K2' else ''} "
            f"{pops[name]} (median {med_pops}), {1e6 * k_ms / med_pops:.1f}"
            f" ns per pop; {card}")
        # No single PyTorch call solves an assignment problem.
        out[name] = (k_ms, p_ms, b_ms, b_by, None)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from botsort_tpu_torch.models import (bn_act, facereid_dw, fastreid,
                                          fastreid_fused)
    from botsort_tpu_torch.models.common import cast_compute
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

    seconds = {}
    t0 = time.perf_counter()

    def done(phase):
        nonlocal t0
        seconds[phase] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    kernels.load_all()
    for name, (secs, out) in sorted(kernels.BUILD_INFO.items()):
        log(f"build: {name} in {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")
    done("build")
    k1_inputs, k1_err = phase_k1(torch, assignment, assignment_cuda, dev)
    done("K1")
    k3_inputs, k3_err = phase_k3(torch, assignment, assignment_cuda, dev)
    done("K3")
    k2_batches, k2_err = phase_k2(torch, assignment, assignment_cuda, dev)
    done("K2")
    k3_launches, oracle_err = phase_oracle(torch, assignment,
                                           assignment_cuda, k2_batches)
    done("oracle")
    phase_small(torch, assets, dev)
    done("small")
    bundle = assets.build_bundle(mini=False, seed=0, device=dev,
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (bundle.detector, bundle.body_encoder,
                                       bundle.face_encoder)
                   for p in m.parameters())
    log(f"bundle: full width, bfloat16, {n_params} parameters")
    done("bundle")
    k1_launches, main_pipe, main_frame, main_cfgs = phase_main(
        torch, bundle, assignment, assignment_cuda, card)
    done("main")
    (k2_launches, k6_launches, unlowered, multi_pipe, multi_frames,
     multi_cfgs) = phase_multi(torch, bundle, assignment, assignment_cuda,
                               bn_act, card)
    done("multi")
    phase_nosync(torch, bundle, main_pipe, main_frame, main_cfgs, multi_pipe,
                 multi_frames)
    done("nosync")
    phase_async(torch, multi_pipe, multi_frames)
    done("async")
    k6_err, k6_times = phase_k6(torch, F, bn_act, bundle, multi_pipe,
                                multi_frames, multi_cfgs, card)
    done("K6")
    del main_pipe, multi_pipe  # their graphs and the graphs' memory pools
    torch.cuda.empty_cache()
    k2_temporal = phase_temporal(torch, bundle, assignment_cuda, card,
                                 unlowered)
    done("temporal")
    phase_checkpoint(torch, assets, bundle)
    done("checkpoint")
    face_inputs, k5_err = phase_k5(torch, facereid_dw, dev)
    done("K5")
    k4_model, k4_err = phase_k4(torch, F, assets, fastreid, fastreid_fused,
                                cast_compute, dev)
    done("K4")
    k4_launches, k5_launches = phase_lowered(
        torch, bundle, assignment_cuda, fastreid_fused, facereid_dw, card,
        unlowered, assets.FULL)
    done("lowered")
    times = phase_timing(torch, assignment, assignment_cuda, k1_inputs,
                         k2_batches, k3_inputs, card)
    times.update(phase_encoder_timing(torch, F, fastreid_fused, facereid_dw,
                                      k4_model, face_inputs, card))
    times["K6"] = k6_times
    done("timings")
    phase_export(torch, bundle, assignment_cuda, bn_act, card)
    done("export")
    phase_serve(torch, bundle, card)
    done("serve")
    phase_store(torch, bundle)
    done("store")
    phase_oproute(torch, bundle, assignment_cuda, bn_act,
                  (assignment, bn_act, facereid_dw, fastreid_fused), card)
    done("oproute")
    log(f"temporal: K2 launches on the temporal path {k2_temporal}")
    log(f"phases (s): {json.dumps(seconds)}, total "
        f"{sum(seconds.values()):.1f}")
    log(card)

    def entry(name, source, replaces, launches, err, key):
        ms, plain_ms, bound_ms, bound_by, library_ms = times[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    print(json.dumps({"kernels": [
        entry("cascade_lap", CASCADE_SOURCE, K1_REPLACES, k1_launches,
              k1_err, "K1"),
        entry("cascade_lap_batched", CASCADE_SOURCE, K2_REPLACES,
              k2_launches, max(k2_err, oracle_err), "K2"),
        entry("jv_lap", JV_SOURCE, K3_REPLACES, k3_launches, k3_err, "K3"),
        entry("stem_stage1", K4_SOURCE, K4_REPLACES, k4_launches, k4_err,
              "K4@128"),
        entry("dw_conv3x3", K5_SOURCE, K5_REPLACES, k5_launches, k5_err,
              "K5"),
        entry("bn_act", K6_SOURCE, K6_REPLACES, k6_launches, k6_err, "K6"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
