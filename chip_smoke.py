#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (botsort_tpu_torch) on one GPU.

Drives the port's paths on the card and fails loudly if any phase fails:

  1. device   a CUDA card is required (no CPU fallback); prints its name
              and power limit; TF32 is switched off.
  2. build    builds every CUDA kernel from csrc/ (ten libraries), one
              nvcc per source, all at once; prints registers and spills.
  3. K1       the cascade solver kernel against its plain PyTorch version
              on the card: equal matchings on random, odd-shaped,
              degenerate and tie-heavy instances (k1_instances), among
              them tie_instances: 60 on a 0.1 grid and 16 with entries
              exactly at L/2, on which the plain version equals the TPU
              kernel (tests/test_torch_cascade_ties.py).
  4. K3       the square JV kernel against its plain version: random,
              odd-shaped, all-parked and tie-heavy problems, S up to 114
              (k3_problems).
  5. K2       eight 8-stream batches at N=64, D=50 (one stream without
              live rows) and three tie-heavy ones (k2_batches_of), each
              one launch: equal to the plain version and to eight
              one-stream K1 launches.
  6. oracle   K1's and K2's matchings equal three chained solve_masked
              calls (K3) per stream on the random batches; on the
              tie-heavy ones, where three solves may pick another optimum,
              K2's objectives equal K3's on the problems K2 solved.
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
              share. K7 must launch once a step run and once a non-zero
              bucket, K8 once a step run (the NMS fixpoint runs to its end:
              one NMS program, no re-run; every step of every phase that
              drives a facade must report it converged), K10 once a step
              run (the hierarchy's claims). Then the crops'
              cost: the graphed point again at
              PipelineConfig(compute_dtype="float32", crop_int8=False)
              beside the default (int8 crops), both medians, and K7's
              share of a graphed frame's device time (torch.profiler).
  9. multi    the same for BatchedBoTSORTPipeline at 8 streams, full width,
              over 8 steps of 8 seeded 1080p frames at the moderate-16
              point, with K2 once per step run, K8 and K10 once per step
              run; counts K6's and K7's launches; the crops' cost as in
              main.
      nosync  one loaded full-width frame_step, its replay from the graph
              and an 8-stream update_async under
              torch.cuda.set_sync_debug_mode("error"): nothing between the
              upload and the readback may wait for the card.
      async   update_async makes no torch.cuda.synchronize and no readback
              (counted with mock.patch); result() makes one readback.
      K6      the batch norm + activation kernel against its plain version
              on every norm shape of an 8-stream step (recorded from the
              three networks, every input channels-last) and of the
              one-frame detector, and on odd shapes in float32 and bfloat16
              with the four activations: its channels-innermost path bit
              for bit (SiLU within one unit in the last place) and equal to
              its NCHW path on the contiguous copy; both paths timed over
              each step's norms against the plain version and the eager
              chain it replaced, beside its bound. The multi phase checks
              that every K6 launch of its replayed steps is channels-last.
      K8      the NMS fixpoint kernel against its plain version, bit for
              bit, on the candidates the loaded one-stream and the
              8-stream steps give it (recorded from their frames) and on a
              suppression chain of length P = 512, through the wrapper and
              launched directly (``k8_sweep``) at block sizes 256, 512 and
              1024 and at cluster sizes 2-16; the cluster size
              (ops/nms.py::launch_shape) and block size each input
              launches with; the iterations each needs; CUDA-event, graph
              and plain times beside the bound, the graph time per block
              size and per cluster size, and the
              16-iteration PyTorch chain it replaced (its time and device
              kernels a call), in this call; the empty-node floor (a CUDA
              graph of 100 one-element kernels, ms a node), printed again
              beside K9's time after the switch phase.
      K7      the crop-resize kernel against its plain version in its
              three modes (float32, bfloat16, int8) at the main paths'
              shapes: 1080p to 480x640 at B = 1 and 8, 50 body crops at
              256x128 and 50 face crops at 128x128 a frame at B = 1 and 8,
              with edge-clamped, one-pixel and degenerate boxes: bit for
              bit; CUDA-event and graph times in each mode, the plain
              version's, and one PyTorch call's (F.interpolate,
              F.grid_sample) at one frame, beside the bound.
      K9      the graph-conditional kernel against its plain version
              (branch_flags_plain) on a program of tiny branches, at the
              values around each bound of the two steps' switches.
      switch  host_bucket_dispatch=False replayed from one CUDA graph a
              shape whose encoder batches are conditional nodes behind K9,
              at the loaded one-stream point (det_score_threshold giving
              0, at most 16 and more than 16 live bodies; where random
              weights' scores, many saturated at 1.0, leave no threshold
              for at most 16, pre_nms_top_k = 16 instead: few_bodies)
              and the 8-stream point (0 and up to 16): each step bit-equal
              to the static-bucket graph at the buckets its branches
              encode, one capture a facade, K9 twice a replay, K7 once a
              step and once a branch taken, K8 and K10 once a step;
              graphed medians and device ms
              a step per regime; a replay and an 8-stream update_async
              under the sync debug mode.
      temporal TemporalBatchedBoTSORTPipeline at full width, B = 8, T = 2,
              moderate-16, seeded per-stream affines, replayed from CUDA
              graphs: the first groups equal T chained frame_step_batched
              calls at equal buckets (their perception taken from the same
              batch of B*T frames); K2 launches T times per step run, K10
              once (all B*T frames' problems in one launch).
      K10     the hierarchy's claims kernel against its plain version
              (greedy_scan_plain) on the card, bit for bit, on the inputs
              the loaded one-stream, the 8-stream and the temporal steps
              give it (recorded from their frames) and on adversarial ties
              (duplicate and grid-snapped boxes, invalid bases and
              targets, all-invalid problems); CUDA-event, graph and plain
              times beside the bound and the empty-node floor, and the
              unrolled loop it replaced from a graph with its kernels a
              call. Then the graphed loaded one-stream and 8-stream
              facades with K10 and with the plain loop patched in (the
              only place that patches it): every FrameResult field and
              the final stores bit-equal, K10 silent in the patched runs,
              and, profiled in the order plain, K10, K10, plain, device
              kernels and device ms a step and the steady medians.
      checkpoint save_bundle of the full-width bundle to a temporary
              directory and build_bundle(weights_dir=...) back: no warning
              on stderr, the three networks' outputs bit-equal; a directory
              without files gives the three warnings.
      onnx    the release files' route with no JAX: full-width ONNX wire
              files (runtime/onnx_lite.py's writer) of the seeded float32
              networks, norms and biases perturbed, in the release layouts
              (the detector with its decode/NMS tail and an
              Identity-wrapped weight, the encoders with their
              post_feature_only tail), each imported through
              cli/import_onnx.py: every tensor bit-equal to its source;
              build_bundle(weights_dir=...) loads them with no warning; the
              one-stream graphed pipeline at the loaded point over the main
              phase's frames equals the source networks' on every
              FrameResult field and the final store (K1, K6, K7, K8
              launching). A fully fused face file (every norm folded into
              its conv) imports with identity norms, its features within
              FUSED_FACE_RTOL (relative L2, float32) of the source's.
              Prints each file's bytes and import seconds.
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
              crops, K5 13 times per step run with face crops, K2 and K10
              once per step run; the last step's encoder inputs re-run with K4 and
              K5 replaced by their plain versions on the card give the same
              features (face: equal, body: relative L2 <= 1e-2).
      coherent pops per solve of the cascade against three chained
              solves, and K1 / K2 times (CUDA events and graph replay), in
              two regimes at N=64, D=50: the loaded one-stream path's own
              cascade inputs (random weights) and seeded coherent scenes
              (coherent_instance: no pop at all); K1 / K2 equal the plain
              version on both.
 13. timings  frame and step times, stage tables, and each kernel against
              its plain version (and a PyTorch call for the same function,
              where there is one) at the main paths' shapes, beside the
              least time the card could take for the same work; the
              solvers' pops per solve and time per pop, K4's and K5's
              eager time minus their CUDA-graph time (the wrappers' host
              cost), and K4's time split by CUDA kernel (torch.profiler)
              with each convolution's achieved TFLOP/s, its scratch bytes
              and the least time its layer-by-layer bytes allow.
 14. export   the program of one bucket pair exported with torch.export
              (runtime/exported.py), saved, loaded and replayed from CUDA
              graphs: load_pipeline at the loaded one-stream point (K1)
              and load_batched_pipeline at 8 streams, moderate-16 (K2);
              over 8 frames every FrameResult field and the final stores
              equal the live facade's, the graphs call the kernels as
              torch.ops.botsort_tpu_torch ops (K8's and K10's among them),
              and K1/K2, K6, K7, K8 and K10 count on replay. Prints export
              and load
              seconds, bytes and live against loaded replay medians.
 15. serve    cli/serve.py's server on a localhost thread with a numpy
              decoder, cold and after warm_up captured the program of
              every bucket pair at 1080p: the JSON of 4 frames equals a
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
 18. train    train/reid_trainer.py's make_trainer on the full-width
              FastReIDSBS (bfloat16 convolutions, float32 masters) at
              256x128, 64 crops of 16 identities, a warm-up step and 6
              timed steps on (cuda:0,): the losses, ms a step, K6 and K6b
              launches a step (one each per norm), peak memory.
 19. K6b      the batch norm + activation backward kernel against its
              plain version on every norm shape of a training step and on
              odd shapes in float32 and bfloat16 with the four activations:
              grad_x bit for bit (SiLU within two units in the last place),
              the per-channel sums within 1e-5 relative, two calls
              bit-equal; timed over one step's norms against the plain
              version and ATen's activation backward +
              native_batch_norm_backward, beside its bound.
 20. int8     the loaded one-stream point with the body encoder quantized
              (models/quantize.py, scope mid, calibrated on 4 of the
              frames) beside the bfloat16 point, both replayed from CUDA
              graphs: frame medians, the body encoder at one frame's 50
              crops int8 against bfloat16, the cosine of their embeddings
              (> 0.97); K1 and K6 launch on the int8 path.
 21. mesh     MeshBatchedBoTSORTPipeline with 16 streams over (cuda:0,
              cuda:0), moderate-16: every FrameResult field and track list
              of slice 0 equals BatchedBoTSORTPipeline's over the first 8
              at every step; K2 and K6 launch on the mesh path.
 22. envelope the 8-stream moderate-16 aggregate frames/s, replayed from
              CUDA graphs, at body ReID 256x128 and 384x128: the numbers
              runtime/envelope.py quotes.

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import gc
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
K7_SOURCE = "botsort_tpu_torch/csrc/crop_resize.cu"
# K7 replaces no TPU kernel either: on the TPU XLA lowers the crop's
# one-hot contractions to the matrix unit, botsort_tpu/ops/crop.py:60
# (crop_and_resize, float32 / bfloat16) and :124 (crop_and_resize_int8, the
# default path's).
K7_REPLACES = "botsort_tpu/ops/crop.py:124"
# K7's checks: (label, frames, boxes a frame, output) at the main paths'
# shapes, from 1080p frames.
K7_CASES = (("detector input", 1, 1, (480, 640)),
            ("detector input", STREAMS, 1, (480, 640)),
            ("body crops", 1, 50, (256, 128)),
            ("face crops", 1, 50, (128, 128)),
            ("body crops", STREAMS, 50, (256, 128)),
            ("face crops", STREAMS, 50, (128, 128)))
K7_KERNEL = "crop_resize_kernel"
K8_SOURCE = "botsort_tpu_torch/csrc/nms_fixpoint.cu"
# K8 replaces no TPU kernel: the JAX package's suppression fixpoint is a
# lax.while_loop inside the jitted step (botsort_tpu/ops/nms.py:88-103).
K8_REPLACES = "botsort_tpu/ops/nms.py:101"
K9_SOURCE = "botsort_tpu_torch/csrc/graph_cond.cu"
# K9 replaces no TPU kernel: it is the predicate of the encoders'
# lax.switch (botsort_tpu/pipeline/frame_step.py:165, and :723 batched).
K9_REPLACES = "botsort_tpu/pipeline/frame_step.py:165"
K9_KERNEL = "set_conditionals_kernel"
K10_SOURCE = "botsort_tpu_torch/csrc/hierarchy_scan.cu"
# K10 replaces no TPU kernel: the JAX hierarchy's claims are a lax.scan
# inside the jitted step (botsort_tpu/ops/hierarchy.py:122-130).
K10_REPLACES = "botsort_tpu/ops/hierarchy.py:130"
# The crops' numerics before the port read PipelineConfig.compute_dtype and
# crop_int8 (the main and multi phases time both in one call).
FLOAT32_CROPS = {"compute_dtype": "float32", "crop_int8": False}
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
# The onnx phase: (importer model name, release file name, the release
# graph's tail) per network, and the trace sizes of the JAX package's
# full-scale import tests (tests/test_import_fullscale.py::TRACE_HW).
ONNX_NETWORKS = (("yolox", "detector", "post"),
                 ("fastreid", "body_encoder", "feature"),
                 ("facereid", "face_encoder", "feature"))
ONNX_TRACE_HW = {"yolox": (96, 128), "fastreid": (64, 32),
                 "facereid": (128, 128)}
# The fully fused face file against its source, float32 on the card with
# TF32 off: the largest relative L2 error of a face's features.
FUSED_FACE_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def draw_masks(rng, n, d):
    """The five masks of tests/test_cascade_solve.py::random_instance:
    pool, tracked, unconf [n] and high, low [d]."""
    pool = rng.uniform(0, 1, n) < 0.6
    tracked = pool & (rng.uniform(0, 1, n) < 0.7)
    unconf = (~pool) & (rng.uniform(0, 1, n) < 0.4)
    high = rng.uniform(0, 1, d) < 0.6
    low = (~high) & (rng.uniform(0, 1, d) < 0.5)
    return pool, tracked, unconf, high, low


def cascade_instance(rng, n, d, empty_rows=False, empty_cols=False,
                     quantum=None):
    """The solver tests' generator: three cost matrices and five masks."""
    costs = [rng.uniform(0, 1, (n, d)).astype(np.float32) for _ in range(3)]
    if quantum:
        costs = [(np.round(c / quantum) * quantum).astype(np.float32)
                 for c in costs]
    pool, tracked, unconf, high, low = draw_masks(rng, n, d)
    if empty_rows:
        pool[:] = tracked[:] = unconf[:] = False
    if empty_cols:
        high[:] = low[:] = False
    return (*costs, pool, tracked, unconf, high, low)


def grid_instance(rng, n, d):
    """Costs on a 0.1 grid (exact ties everywhere), rounded in float64,
    then the five masks."""
    costs = [(np.round(rng.uniform(0, 1, (n, d)) / 0.1) * 0.1).astype(
        np.float32) for _ in range(3)]
    return (*costs, *draw_masks(rng, n, d))


def half_instance(rng, n, d):
    """Each pass's costs are k * L / 4 in float32, k in 0..5, L the pass's
    limit: about one entry in six lies exactly at the dummy price L / 2,
    where the escape fast path's inclusive >= decides."""
    costs = [np.float32(limit) / np.float32(4) * rng.integers(
        0, 6, (n, d)).astype(np.float32) for limit in LIMITS]
    return (*costs, *draw_masks(rng, n, d))


def tie_instances():
    """The tie-heavy instances K1 and K2 are held to, as (label, numpy
    instance): 60 on a 0.1 grid at N, D in 2..11 (default_rng(0); on 5 of
    them the TPU kernel's matching differs from three chained solves),
    then half-exact ones, 8 at 12 x 9 and 8 at N_TRACKS x N_DETS."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(60):
        n, d = rng.integers(2, 12), rng.integers(2, 12)
        out.append((f"grid {k}", grid_instance(rng, n, d)))
    rng = np.random.default_rng(1)
    for n, d in [(12, 9)] * 8 + [(N_TRACKS, N_DETS)] * 8:
        out.append((f"half {len(out) - 60}", half_instance(rng, n, d)))
    return out


def coherent_instance(rng, n, d):
    """A coherent scene, the costs trained encoders give: each detection
    within 0.2 of exactly one track, every other cost >= 0.6, in all
    three passes (one pairing); every track in the pool, none unconfirmed,
    70% of them tracked; 80% of the detections high. Every live column's
    track is live, so the column reduction and the resolve leave no row
    for the Dijkstra pops (needs n >= d)."""
    rows, cols = rng.permutation(n)[:d], np.arange(d)
    costs = []
    for _ in range(3):
        c = rng.uniform(0.6, 1.0, (n, d))
        c[rows, cols] = rng.uniform(0.0, 0.2, d)
        costs.append(c.astype(np.float32))
    pool = np.ones(n, bool)
    tracked = rng.uniform(0, 1, n) < 0.7
    high = rng.uniform(0, 1, d) < 0.8
    return (*costs, pool, tracked, np.zeros(n, bool), high, ~high)


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
    insts = [(n, d, kw, cascade_instance(rng, n, d, **kw))
             for n, d, kw in cases]
    insts += [(inst[0].shape + (dict(ties=label), inst))
              for label, inst in tie_instances()]
    for n, d, kw, inst in insts:
        inst = [torch.from_numpy(a).to(dev) for a in inst]
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


def k2_batches_of(rng):
    """phase_k2's batches in order, as (numpy instances, whether they are
    tie-heavy): eight of random costs at N_TRACKS x N_DETS (stream k % 8 of
    batch k without live rows), then three of ties: the half-exact
    instances of tie_instances (12 x 9 and full width) and one on a 0.1
    grid at full width."""
    out = [([cascade_instance(rng, N_TRACKS, N_DETS,
                              empty_rows=(s == k % STREAMS))
             for s in range(STREAMS)], False) for k in range(8)]
    half = [inst for label, inst in tie_instances()
            if label.startswith("half")]
    out += [(half[:STREAMS], True), (half[STREAMS:2 * STREAMS], True),
            ([grid_instance(rng, N_TRACKS, N_DETS)
              for _ in range(STREAMS)], True)]
    return out


def phase_k2(torch, assignment, assignment_cuda, dev):
    """8-stream batches, one launch each, against the plain version and
    against one-stream K1 launches; returns the batches' raw instances,
    prepared inputs, K2 outputs and tie flags, and the max index error."""
    batches, max_err = [], 0
    cuda = assignment_cuda.cascade_solve_cuda
    for k, (insts, ties) in enumerate(k2_batches_of(
            np.random.default_rng(77))):
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
        batches.append((tensors, (costs, masks, big, LIMITS), got, ties))
    log(f"K2: {len(batches)} batches of {STREAMS} streams "
        f"({sum(b[3] for b in batches)} tie-heavy), one launch each, equal "
        "to the plain version and to one-stream K1 launches")
    return batches, max_err


def objective(cost, rows, cols, cfr, limit):
    """A pass's extended cost in float64: the matched live pairs' costs
    plus L/2 for every live row and live column left unmatched."""
    cost, rows, cols, cfr = (t.cpu().numpy() for t in (cost, rows, cols,
                                                       cfr))
    matched = rows & (cfr >= 0)
    half = np.float64(np.float32(limit)) / 2
    n_matched = int(matched.sum())
    return (cost[matched, cfr[matched]].astype(np.float64).sum()
            + half * (rows.sum() - n_matched + cols.sum() - n_matched))


def phase_oracle(torch, assignment, assignment_cuda, batches):
    """K1's and K2's results against three chained solve_masked calls (K3
    on the card) per stream: equal matchings on the random batches; on the
    tie-heavy ones, where another optimum is as good, equal objectives
    (float64, 1e-5) on the problems K2 solved (passes 2 and 3 from K2's own
    pass 1). Returns K3's launch count on this path and the max index
    error."""
    jv = assignment_cuda.jv_solve_cuda
    jv.launches = 0
    max_err, worst_gap, n_ties = 0, 0.0, 0
    for k, (tensors, prepared, k2_out, ties) in enumerate(batches):
        for s in range(STREAMS):
            d1, iou, d3, pool, tracked, unconf, high, low = (
                t[s] for t in tensors)
            if ties:
                cfr, rfc = k2_out[0][s], k2_out[1][s]
                problems = ((d1, pool, high), (iou, tracked & (cfr[0] < 0),
                                               low),
                            (d3, unconf, high & (rfc[0] < 0)))
                for p, (cost, rows, cols) in enumerate(problems):
                    want = assignment.solve_masked(cost, rows, cols,
                                                   LIMITS[p])
                    gap = abs(objective(cost, rows, cols, cfr[p], LIMITS[p])
                              - objective(cost, rows, cols,
                                          want.col_for_row, LIMITS[p]))
                    if gap > 1e-5:
                        raise AssertionError(
                            f"K2's objective != K3's, batch {k} stream {s} "
                            f"pass {p + 1}: {gap}")
                    worst_gap = max(worst_gap, gap)
                n_ties += 1
                continue
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
        f"{STREAMS * len(batches) - n_ties} streams; on {n_ties} tie-heavy "
        f"streams K2's objectives equal K3's (largest gap {worst_gap:.3g}); "
        f"{launches} K3 launches")
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


class SolverRecorder:
    """Wraps assignment.solve_cascade_masked: keeps a device copy of every
    call's eight inputs (the cascade's costs and masks), without waiting
    for the card."""

    def __init__(self, assignment):
        self.real = assignment.solve_cascade_masked
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append([a.clone() for a in args[:8]])
        return self.real(*args, **kw)


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


def profiled_events(torch, fn, steps):
    """The torch.profiler events of ``steps`` calls of fn. One call more
    runs first and is not counted: a torch.profiler run can lose the events
    of its first milliseconds. The device synchronisation after that call
    marks where the counted events begin."""
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
    return [e for e in events if e.time_range.start >= syncs[0]]


def device_us(torch, e):
    """An event's device microseconds, or None for a host event."""
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return None
    us = getattr(e, "device_time", None)
    return e.cuda_time if us is None else us


def step_profile(torch, fn, steps=2):
    """``steps`` calls of fn under torch.profiler: (device kernels and
    copies per call, host launch calls per call, device ms per call)."""
    n_dev = n_host = 0
    dev_us = 0.0
    for e in profiled_events(torch, fn, steps):
        us = device_us(torch, e)
        if us is not None:
            dev_us += us
            n_dev += 1
        elif e.name in HOST_LAUNCH_CALLS:
            n_host += 1
    if n_dev == 0 or dev_us <= 0.0:
        raise AssertionError("torch.profiler saw no device work in a step")
    return n_dev / steps, n_host / steps, dev_us / 1e3 / steps


def kernel_share(torch, fn, needle, steps=2):
    """(device ms a call of the kernels whose name holds ``needle``, their
    count a call, device ms a call of everything) under torch.profiler."""
    mine = total = 0.0
    n = 0
    for e in profiled_events(torch, fn, steps):
        us = device_us(torch, e)
        if us is None:
            continue
        total += us
        if needle in e.name:
            mine += us
            n += 1
    if total <= 0.0:
        raise AssertionError("torch.profiler saw no device work in a step")
    return mine / 1e3 / steps, n / steps, total / 1e3 / steps


def crop_cost(torch, label, unit, graphed, make_float32, inputs, card,
              gmc=None):
    """The crops' end-to-end cost within one call: the graphed facade at
    the default PipelineConfig (K7 in int8 mode) again and a new one with
    ``compute_dtype="float32", crop_int8=False``, each over ``inputs``
    after the other, their steady medians, and K7's share of a graphed
    step's device time (torch.profiler) in each."""
    pipes = {"default": graphed, "float32": make_float32()}
    out = {}
    for name in ("float32", "default", "float32"):
        pipe = pipes[name]
        rows = drive(torch, pipe, inputs, lambda: 0, gmc=gmc)
        out.setdefault(name, []).extend(steady_ms(rows))
    shares = {}
    for name, pipe in pipes.items():
        fn = (lambda p=pipe: p.update(inputs[-1])) if gmc is None else (
            lambda p=pipe: p.update(inputs[-1], gmc[-1]))
        shares[name] = kernel_share(torch, fn, K7_KERNEL)
    med = {k: statistics.median(v) for k, v in out.items()}
    log(f"timing: crops, {label} graphed: median {med['default']:.3f} ms a "
        f"{unit} at the default PipelineConfig (int8 crops) against "
        f"{med['float32']:.3f} ms with float32 crops "
        f"({med['default'] - med['float32']:+.3f} ms) in this call "
        f"(runs float32, default, float32); K7 under torch.profiler: "
        + "; ".join(f"{k}: {v[0]:.4f} ms in {v[1]:.0f} launches of "
                    f"{v[2]:.3f} ms device time a {unit} (share "
                    f"{v[0] / v[2]:.4f})" for k, v in shares.items())
        + f"; {card}")
    return med, shares


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

    # The patch goes again by deleting it: a bound method of the pipeline
    # left in its own __dict__ is a reference cycle, which would leave the
    # pipeline and its CUDA graphs to the cyclic garbage collector, and a
    # graph destroyed while another is being captured invalidates that
    # capture.
    own = "_step" in vars(pipeline)
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
            if not np.all(pipeline.last_result.nms_converged):
                raise AssertionError(f"step {i + 1}: the NMS fixpoint did "
                                     "not converge")
            if check is not None:
                check(pipeline.last_result)
            rows.append(dict(ms=ms, runs=runs[n_runs:],
                             launches=launches_of() - before, tracks=tracks,
                             result=pipeline.last_result))
    finally:
        if own:
            pipeline._step = real_step
        else:
            del pipeline._step
    return rows


def expected_launches(row, per_run=1, ran=lambda run: True):
    """Launches a step's runs stand for: one per replay (or eager run), and
    the warm-up calls of a run that captured a new graph."""
    from botsort_tpu_torch.pipeline.graphed import WARMUP_CALLS

    return per_run * sum(1 + WARMUP_CALLS * new
                         for rb, fb, new in row["runs"] if ran((rb, fb)))


def k7_expected(rows):
    """K7 launches the steps of ``rows`` stand for: a step run crops the
    detector input, and the body and face crops of a non-zero bucket."""
    return sum(expected_launches(dict(runs=[run]), 1 + (run[0] > 0)
                                 + (run[1] > 0))
               for r in rows for run in r["runs"])


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
    over the same frames, then its crops' cost (``crop_cost``); returns
    K1's, K7's, K8's and K10's launches in the replayed run, the nosync /
    async material and the eager run's cascade inputs."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.ops import crop, hierarchy, nms
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
    solver_rec = SolverRecorder(assignment)
    check = lambda res: check_finite(res, nms_cfg)  # noqa: E731
    rows = {}
    with mock.patch.object(fs_mod, "tracker_update_batched", recorder), \
            mock.patch.object(assignment, "solve_cascade_masked",
                              solver_rec):
        rows["eager"] = drive(torch, pipes["eager"], frames,
                              lambda: cuda.launches, force_at=4, check=check)
    recorder.replay_plain(torch, assignment, assignment_cuda, cascade)
    log("main: last eager frame's tracks with the plain solver equal K1's")
    k7, k8 = crop.crop_resize_cuda, nms.nms_fixpoint_cuda
    k10 = hierarchy.greedy_scan_cuda
    cuda.launches = cuda.batched_launches = k7.launches = k8.launches = 0
    k10.launches = 0
    rows["graphed"] = drive(torch, pipes["graphed"], frames,
                            lambda: cuda.launches, force_at=4, check=check)
    main_launches, k7_launches = cuda.launches, k7.launches
    k8_launches, k10_launches = k8.launches, k10.launches
    if k7_launches != k7_expected(rows["graphed"]):
        raise AssertionError(f"main: K7 launched {k7_launches} times, not "
                             "once a step run and once a non-zero bucket")
    for name, n in (("K8", k8_launches), ("K10", k10_launches)):
        if n != sum(expected_launches(r) for r in rows["graphed"]):
            raise AssertionError(f"main: {name} launched {n} times, not "
                                 "once a step run")
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
    staged = pipes["graphed"]._staging["frame"].dtype
    if staged != torch.uint8:
        raise AssertionError(f"main: the staged frames are {staged}")
    log(f"main: K7 launches in the replayed run {k7_launches} (a step run's "
        f"detector input, body and face crops; frames staged as {staged}, "
        f"so {crop.crop_mode(cfgs[2], staged)} mode); K8 launches "
        f"{k8_launches} (one NMS program a bucket pair, "
        f"{len(cache.keys())} captured, no NMS re-run), K10 launches "
        f"{k10_launches}")
    crop_cost(torch, "loaded one-stream", "frame", pipes["graphed"],
              lambda: host.BoTSORTPipeline(bundle, *cfgs[:2],
                                       PipelineConfig(**FLOAT32_CROPS)),
              frames, card)
    return (main_launches, k7_launches, k8_launches, k10_launches,
            pipes["graphed"], frames[-1], cfgs, solver_rec.calls)


def phase_multi(torch, bundle, assignment, assignment_cuda, bn_act, card):
    """BatchedBoTSORTPipeline, 8 streams, moderate-16, eager and replayed
    over the same frames; returns K2's and K6's launches in the replayed
    run, the replayed medians and the pipeline; then the crops' cost
    (``crop_cost``)."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.ops import crop, hierarchy, nms
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
    k7, k8 = crop.crop_resize_cuda, nms.nms_fixpoint_cuda
    k10 = hierarchy.greedy_scan_cuda
    cuda.launches = cuda.batched_launches = k6.launches = k7.launches = 0
    k6.launches_channels_last = k8.launches = k10.launches = 0
    rows["graphed"] = drive(torch, pipes["graphed"], steps,
                            lambda: cuda.batched_launches, force_at=4,
                            check=check)
    k2_launches, k6_launches = cuda.batched_launches, k6.launches
    if k6.launches_channels_last != k6_launches:
        raise AssertionError(
            f"multi: {k6.launches_channels_last} of K6's {k6_launches} "
            "launches on the channels-innermost path")
    k7_launches, k8_launches = k7.launches, k8.launches
    k10_launches = k10.launches
    for name, n in (("K8", k8_launches), ("K10", k10_launches)):
        if n != sum(expected_launches(r) for r in rows["graphed"]):
            raise AssertionError(f"multi: {name} launched {n} times, not "
                                 "once a step run")
    if k7_launches != k7_expected(rows["graphed"]):
        raise AssertionError(f"multi: K7 launched {k7_launches} times, not "
                             "once a step run and once a non-zero bucket")
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
        f"the replayed run {k6_launches}, all channels-last; live tracks "
        f"per stream "
        f"{n_tracks[-1]}")
    if max(max(n) for n in n_tracks) < 1:
        raise AssertionError("no live tracks on any stream")
    if k6_launches < n_runs:
        raise AssertionError("the networks did not run K6")
    point = report_point(
        torch, f"BatchedBoTSORTPipeline.update ({STREAMS} streams, "
        "moderate-16)", "step", pipes, rows, STREAMS, card, steps[-1])
    log(f"multi: K7 launches in the replayed run {k7_launches}, K8 "
        f"{k8_launches} (one launch for the {STREAMS} x 4 NMS problems of a "
        f"step run), K10 {k10_launches} (one for the {3 * STREAMS} "
        f"hierarchy problems)")
    crop_cost(torch, f"{STREAMS} streams moderate-16", "step",
              pipes["graphed"],
              lambda: host.BatchedBoTSORTPipeline(
                  bundle, STREAMS, *cfgs[:2], PipelineConfig(**FLOAT32_CROPS)),
              steps, card)
    return (k2_launches, k6_launches, k7_launches, k8_launches,
            k10_launches, point["graphed"], pipes["graphed"], steps[-1],
            cfgs)


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
    log(f"nosync: a loaded full-width frame_step at buckets {buckets} "
        f"({int(a.det_valid[0].sum())} bodies), its replay from the graph "
        f"and an {STREAMS}-stream update_async ran under "
        "set_sync_debug_mode('error'): no wait between upload and readback")


def k8_inputs(torch, nms, bundle, frames_dev, cfgs):
    """(top_boxes [G, 4, P, 4], top_valid [G, 4, P]): what K8 gets in a
    step on ``frames_dev`` [G, H, W, 3], from the detector and
    ops/nms.py's candidate selection."""
    from botsort_tpu_torch.ops.crop import _crop

    _, nms_cfg, pipe_cfg = cfgs
    h, w = frames_dev.shape[1:3]
    full = torch.tensor([0.0, 0.0, float(w), float(h)],
                        device=frames_dev.device).expand(
                            frames_dev.shape[0], 1, 4)
    with torch.no_grad():
        boxes, scores = bundle.detector(_crop(
            frames_dev, full, pipe_cfg.detector_input_hw, pipe_cfg)[:, 0])
        scores = scores.transpose(-1, -2)
        top_boxes, _, top_valid, _ = nms.top_candidates(
            boxes, scores, torch.ones_like(scores, dtype=torch.bool),
            nms_cfg.score_threshold, nms_cfg.pre_nms_top_k)
    return top_boxes.contiguous(), top_valid.contiguous()


def fixpoint_iterations(torch, iou_matrix, top_boxes, top_valid, thr):
    """Iterations of the suppression fixpoint until nothing changes (the
    last one confirms it), over all problems at once, as the JAX loop
    counts them."""
    p = top_valid.shape[-1]
    iou = iou_matrix(top_boxes, top_boxes)
    rank = torch.arange(p, device=top_valid.device)
    dom = ((iou > thr) & (rank[:, None] < rank[None, :])
           & top_valid[..., :, None] & top_valid[..., None, :])
    keep, n = top_valid, 0
    while n < p:
        new = top_valid & ~(dom & keep[..., :, None]).any(dim=-2)
        n += 1
        if torch.equal(new, keep):
            break
        keep = new
    return n


def old_nms_chain(torch, iou_matrix, top_boxes, top_valid, thr, iters=16):
    """The fixed 16-iteration PyTorch chain K8 replaced (the port's
    ops/nms.py before K8): the [..., P, P] IoU and dominance matrices,
    then ``iters`` masked reductions, each about four kernels."""
    p = top_valid.shape[-1]
    iou = iou_matrix(top_boxes, top_boxes)
    rank = torch.arange(p, device=top_valid.device)
    dom = ((iou > thr) & (rank[:, None] < rank[None, :])
           & top_valid[..., :, None] & top_valid[..., None, :])
    keep = top_valid
    for _ in range(iters):
        keep = top_valid & ~(dom & keep[..., :, None]).any(dim=-2)
    return keep


def k8_chain(torch, p, dev):
    """A suppression chain of length p in each of 4 classes of one frame:
    box i overlaps box i + 1 above 0.8 IoU and box i + 2 below it, ranks
    descending, so the fixpoint settles one box an iteration."""
    x = torch.arange(p, dtype=torch.float32, device=dev) * 2.2
    one = torch.stack([x, torch.full_like(x, 20.0), x + 36.0,
                       torch.full_like(x, 76.0)], dim=-1)
    return (one.expand(1, 4, p, 4).contiguous(),
            torch.ones((1, 4, p), dtype=torch.bool, device=dev))


def empty_node_floor(torch, dev, nodes=100, replays=20):
    """The least time a kernel node of a CUDA graph takes: a graph of
    ``nodes`` one-element PyTorch kernels (``add_`` on one float), replayed;
    device ms a node."""
    x = torch.zeros(1, device=dev)
    return graph_ms(torch, lambda: x.add_(1.0), calls=nodes,
                    replays=replays)


# The block sizes the K8 library holds; ops/nms.py launches THREADS.
K8_BLOCK_THREADS = (256, 512, 1024)


def k8_direct(torch, nms, boxes, valid, thr, cluster, threads):
    """K8's library launched directly, not counted, at a cluster size and
    block size of the caller's: a function that launches it into a fresh
    keep tensor and returns it."""
    lib = nms._lib()
    problems, p = valid.shape[0] * valid.shape[1], valid.shape[-1]

    def run():
        keep = torch.empty_like(valid)
        n_scratch = lib.nms_fixpoint_scratch_bytes(problems, p)
        scratch = torch.empty(n_scratch, dtype=torch.uint8,
                              device=valid.device) if n_scratch else None
        rc = lib.nms_fixpoint_launch(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(), problems, p,
            float(np.float32(thr)), cluster, threads,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K8 at cluster size {cluster}, {threads} "
                               f"threads: CUDA error {rc}")
        return keep

    return run


def k8_sweep(torch, nms, boxes, valid, thr, want, shapes):
    """Graph ms of K8 at each (cluster size, block size) of ``shapes``,
    each launch first checked bit-equal to ``want``."""
    out = []
    for c, n in shapes:
        run = k8_direct(torch, nms, boxes, valid, thr, c, n)
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K8 != plain at cluster size {c}, {n} "
                                 "threads")
        out.append(graph_ms(torch, run))
    return out


def phase_k8(torch, nms, iou_matrix, bundle, main_frame, multi_frames,
             cfgs, card):
    """K8 against nms_fixpoint_plain on the card, bit for bit, at the
    loaded one-stream and the 8-stream steps' candidates and on a chain of
    length P; the cluster size and block size each input launches with;
    iterations; CUDA-event, graph and plain times, the graph time per
    block size (at the launched cluster size) and per cluster size (at
    nms.THREADS threads), each of those launches bit-equal too, the old
    16-iteration chain's time and device kernels in this call, the bound,
    and the empty-node floor. Returns
    (max element difference, (ms, plain ms, bound ms, bound by, library
    ms)) at the loaded one-stream step's candidates, and the floor (ms a
    graph node)."""
    _, nms_cfg, _ = cfgs
    thr = nms_cfg.iou_threshold
    dev = bundle.device
    cases = (("loaded one stream",) + k8_inputs(
                 torch, nms, bundle, torch.from_numpy(main_frame)[None].to(
                     dev), cfgs),
             (f"{STREAMS} streams",) + k8_inputs(
                 torch, nms, bundle, torch.from_numpy(multi_frames).to(dev),
                 cfgs),
             (f"chain of {nms_cfg.pre_nms_top_k}",) + k8_chain(
                 torch, nms_cfg.pre_nms_top_k, dev))
    floor = empty_node_floor(torch, dev)
    log(f"timing: empty-node floor {floor:.4f} ms a kernel node (a CUDA "
        f"graph of 100 one-element add_ kernels, replayed); {card}")
    max_err, first = 0, None
    for label, boxes, valid in cases:
        want = nms.nms_fixpoint_plain(boxes, valid, thr)
        got = nms.nms_fixpoint_cuda(boxes, valid, thr)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        if err:
            raise AssertionError(f"K8 != plain on {label}: {err} of "
                                 f"{got.numel()} differ")
        problems, p = valid.shape[0] * valid.shape[1], valid.shape[-1]
        cluster = nms.launch_shape(problems, p, dev)
        resident = nms.max_active_clusters(cluster, p, dev)
        iters = fixpoint_iterations(torch, iou_matrix, boxes, valid, thr)
        run = lambda b=boxes, v=valid: nms.nms_fixpoint_cuda(  # noqa: E731
            b, v, thr)
        old = lambda b=boxes, v=valid: old_nms_chain(  # noqa: E731
            torch, iou_matrix, b, v, thr)
        ms, ms_graph = event_ms(torch, run, 50), graph_ms(torch, run)
        plain = event_ms(torch, lambda b=boxes, v=valid:
                         nms.nms_fixpoint_plain(b, v, thr), 3)
        old_ms, old_graph = event_ms(torch, old, 10), graph_ms(torch, old)
        old_kernels = step_profile(torch, old)[0]
        n_valid = valid.reshape(problems, p).sum(-1).double()
        pairs = float((n_valid * (n_valid - 1) / 2).sum())
        # Each box's 16 B and valid byte read once, each keep byte written
        # once; about 12 float32 operations an IoU of two valid boxes.
        nbytes = problems * p * 18
        b_ms, b_by = bound(nbytes, 12 * pairs, F32_FLOPS)
        log(f"timing: K8 {label}: [{valid.shape[0]}, {valid.shape[1]}, "
            f"{p}], {int(n_valid.sum())} valid candidates, {iters} "
            f"iterations to the fixpoint; {problems} clusters of {cluster} "
            f"blocks of {nms.THREADS} threads ({resident} fit at once); "
            f"kernel {ms:.4f} ms eager, "
            f"{ms_graph:.4f} ms graph; plain {plain:.4f} ms; the "
            f"16-iteration chain it replaced {old_ms:.4f} ms eager, "
            f"{old_graph:.4f} ms graph, {old_kernels:.0f} device kernels a "
            f"call; bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {pairs:.0f} "
            f"IoU pairs); library: none (no PyTorch call suppresses); "
            f"empty-node floor {floor:.4f} ms; {card}")
        log(f"timing: K8 {label}: graph ms per block size at cluster size "
            f"{cluster}, bit-equal at each: " + ", ".join(
                f"{n} threads {t:.4f}" for n, t in zip(
                    K8_BLOCK_THREADS, k8_sweep(
                        torch, nms, boxes, valid, thr, want,
                        [(cluster, n) for n in K8_BLOCK_THREADS]))))
        sizes = (2, 3, 4, 6, 8, 12, 16)
        log(f"timing: K8 {label}: graph ms per cluster size at "
            f"{nms.THREADS} threads (clusters that fit at once), bit-equal "
            "at each: " + ", ".join(
                f"{c} {t:.4f} ({nms.max_active_clusters(c, p, dev)})"
                for c, t in zip(sizes, k8_sweep(
                    torch, nms, boxes, valid, thr, want,
                    [(c, nms.THREADS) for c in sizes]))))
        if first is None:
            first = (ms, plain, b_ms, b_by, None)
        max_err = max(max_err, err)
    log(f"K8: equal to the plain version bit for bit on all "
        f"{len(cases)} inputs at every block size and cluster size")
    max_err = max(max_err, k8_large(torch, nms, iou_matrix, bundle,
                                    main_frame, cfgs, card))
    return max_err, first, floor


# K8 above the candidates whose dominance words fit the leader's shared
# memory: every anchor of the 480x640 detector input, and a chain.
K8_LARGE_TOP_K = 6300
K8_LARGE_CHAIN = 2048


def k8_large(torch, nms, iou_matrix, bundle, main_frame, cfgs, card):
    """K8 with its dominance words in the scratch buffer (P above
    nms.SMEM_CANDIDATES) against nms_fixpoint_plain, bit for bit: the
    loaded one-stream frame's candidates at pre_nms_top_k = 6,300 and a
    chain of 2,048 in each of 4 classes; iterations, cluster size, scratch
    bytes, CUDA-event, graph and plain times and the bound. Returns the
    largest element difference (0)."""
    import dataclasses

    trk, nms_cfg, pipe_cfg = cfgs
    thr = nms_cfg.iou_threshold
    dev = bundle.device
    wide = (trk, dataclasses.replace(nms_cfg, pre_nms_top_k=K8_LARGE_TOP_K),
            pipe_cfg)
    cases = ((f"loaded one stream at pre_nms_top_k={K8_LARGE_TOP_K}",)
             + k8_inputs(torch, nms, bundle,
                         torch.from_numpy(main_frame)[None].to(dev), wide),
             (f"chain of {K8_LARGE_CHAIN}",)
             + k8_chain(torch, K8_LARGE_CHAIN, dev))
    for label, boxes, valid in cases:
        problems, p = valid.shape[0] * valid.shape[1], valid.shape[-1]
        if p <= nms.SMEM_CANDIDATES:
            raise AssertionError(f"K8 {label}: {p} candidates, not above "
                                 f"{nms.SMEM_CANDIDATES}")
        want = nms.nms_fixpoint_plain(boxes, valid, thr)
        got = nms.nms_fixpoint_cuda(boxes, valid, thr)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        if err:
            raise AssertionError(f"K8 != plain on {label}: {err} of "
                                 f"{got.numel()} differ")
        cluster = nms.launch_shape(problems, p, dev)
        scratch = nms._lib().nms_fixpoint_scratch_bytes(problems, p)
        iters = fixpoint_iterations(torch, iou_matrix, boxes, valid, thr)
        run = lambda b=boxes, v=valid: nms.nms_fixpoint_cuda(  # noqa: E731
            b, v, thr)
        ms = event_ms(torch, run, 10)
        ms_graph = graph_ms(torch, run, calls=5, replays=4)
        plain = event_ms(torch, lambda b=boxes, v=valid:
                         nms.nms_fixpoint_plain(b, v, thr), 1)
        n_valid = valid.reshape(problems, p).sum(-1).double()
        pairs = float((n_valid * (n_valid - 1) / 2).sum())
        nbytes = problems * p * 18
        b_ms, b_by = bound(nbytes, 12 * pairs, F32_FLOPS)
        log(f"timing: K8 {label}: [{valid.shape[0]}, {valid.shape[1]}, "
            f"{p}], {int(n_valid.sum())} valid candidates, {iters} "
            f"iterations to the fixpoint; {problems} clusters of {cluster} "
            f"blocks of {nms.THREADS} threads, dominance words in a "
            f"{scratch} B scratch buffer; kernel {ms:.4f} ms eager, "
            f"{ms_graph:.4f} ms graph; plain {plain:.4f} ms; bound "
            f"{b_ms:.6f} ms by {b_by} ({nbytes} B, {pairs:.0f} IoU pairs); "
            f"library: none; {card}")
    log(f"K8: equal to the plain version bit for bit above "
        f"{nms.SMEM_CANDIDATES} candidates on all {len(cases)} inputs")
    return 0


def phase_k9(torch, switch, dev):
    """K9 against branch_flags_plain on the card: a ConditionalProgram of
    tiny segments (the value copied in, one flag raised by each branch's
    body) with the one-stream step's branches ((0, 16], (16, max]) and the
    8-stream step's ((0, max]); for values around each bound, the flags
    the taken bodies raise equal the plain version's. Returns the number
    of differing flags (0) and the plain version's ms."""
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream(dev)

    def segment(fn):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            fn()
        return graph

    src = torch.zeros((), dtype=torch.int32, device=dev)
    value = torch.zeros((), dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    Branch, top = switch.Branch, switch.INT32_MAX
    sets = ([Branch(0, 16, 16, None), Branch(16, top, 64, None)],
            [Branch(0, top, 16, None)])
    values = (0, 1, 15, 16, 17, 50, 64, top)
    err, checked = 0, 0
    for branches in sets:
        pre = segment(lambda: (value.copy_(src), flags.zero_()))
        bodies = [segment(lambda k=k: flags[k].fill_(1))
                  for k in range(len(branches))]
        post = segment(lambda: flags.add_(0))
        program = switch.ConditionalProgram(
            [("segment", pre), ("switch", value, branches, bodies),
             ("segment", post)], dev)
        for v in values:
            src.fill_(v)
            switch.launch_conditional(program)
            want = switch.branch_flags_plain(src, branches).to(torch.int32)
            torch.cuda.synchronize()
            err += int((flags[:len(branches)] != want).sum())
            checked += 1
        del program
    if err:
        raise AssertionError(f"K9 != plain: {err} flags differ")
    plain = event_ms(torch, lambda: switch.branch_flags_plain(
        src, sets[0]), 100)
    rt, drv = switch.cuda_versions()
    log(f"K9: the flags of {checked} launches (values {list(values)}) "
        f"equal branch_flags_plain's; IF conditional nodes, CUDA runtime "
        f"{rt}, driver {drv}; plain {plain:.4f} ms")
    return err, plain


def switch_widths(values, d, r):
    """The slots each switch's taken branch encodes (0, r or the padded
    width), from the switches' values."""
    dp = -(-d // r) * r
    return [0 if v == 0 else (r if (v <= r and dp > r) else dp)
            for v in values]


def few_bodies(torch, bundle, frames, base, nms_cfg, pipe_cfg, d, r):
    """(NMS configuration, det_score_threshold) at which every frame has
    at most ``r`` live bodies and one has some: a score threshold where the
    body scores allow one (more than r / 2 live), else the loaded
    threshold with ``pre_nms_top_k = r``, which leaves at most r
    candidates a class (random weights saturate many scores at exactly
    1.0, which no score threshold separates). The det width, and so the
    switch's branches, stay those of ``base``."""
    import dataclasses

    from botsort_tpu_torch.ops import crop
    from botsort_tpu_torch.pipeline import frame_step as fs_mod

    dev = bundle.device
    dets_in = []
    for f in frames:
        batch = torch.from_numpy(f.reshape((-1,) + f.shape[-3:])).to(dev)
        full = torch.tensor([0.0, 0.0, FRAME_HW[1], FRAME_HW[0]],
                            device=dev).expand(batch.shape[0], 1, 4)
        with torch.no_grad():
            dets_in.append(bundle.detector(crop._crop(
                batch, full, pipe_cfg.detector_input_hw, pipe_cfg)[:, 0]))

    def scores_of(ncfg):
        out = []
        for cand in dets_in:
            dets, _, valid = fs_mod.postprocess_detections_batched(
                *cand, FRAME_HW, base, ncfg, pipe_cfg)
            out += [row[v].tolist() for row, v in zip(
                dets.scores[:, 0, :d].cpu(), valid[:, 0, :d].cpu())]
        return out

    scores = scores_of(nms_cfg)
    # Score thresholds from the highest down: the first that leaves at
    # most r live bodies in every frame and more than r / 2 in one.
    for t in sorted({x for sc in scores for x in sc}, reverse=True):
        live = [sum(x > t for x in sc) for sc in scores]
        if max(live) > r:
            break
        if max(live) > r // 2:
            return nms_cfg, float(t)
    few = dataclasses.replace(nms_cfg, pre_nms_top_k=r)
    if 0 < max(len(sc) for sc in scores_of(few)) <= r:
        return few, base.det_score_threshold
    raise AssertionError(f"switch: no setting gives 1 to {r} live bodies")


def phase_switch(torch, bundle, card, k9_plain_ms):
    """host_bucket_dispatch=False, replayed from CUDA graphs with the
    encoder batches as conditional nodes: at the loaded one-stream point
    with 0, at most 16 (``few_bodies``) and more than 16 live bodies, and
    at the 8-stream moderate-16 point with 0 and up to 16.
    Each step bit-equal (FrameResult and stores) to the static-bucket
    graph at the buckets its branches encode; one capture a facade; K9
    twice a replay, K7 once a step and once a branch taken, K8 and K10
    once a step. Prints the live counts, graphed medians and device ms a step per
    regime, K9's device time, and a replay (8 streams: update_async) under
    the sync debug mode. Returns (K9 launches, K9's (ms, plain ms, bound
    ms, bound by, library ms))."""
    import dataclasses

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.ops import crop, hierarchy, nms
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.pipeline import host, switch

    k7, k8 = crop.crop_resize_cuda, nms.nms_fixpoint_cuda
    k10 = hierarchy.greedy_scan_cuda
    k9 = switch.launch_conditional
    nms_cfg = NMSConfig()
    sw_pipe = PipelineConfig(host_bucket_dispatch=False)
    st_pipe = PipelineConfig()
    r = sw_pipe.max_reid_batch
    dev = bundle.device
    k9.launches = 0
    k9_runs = []
    points = (("loaded one stream", 0, loaded_cfg(TrackerConfig), 10),
              (f"{STREAMS} streams moderate-16", STREAMS,
               loaded_cfg(TrackerConfig, max_dets=16), 11))
    for label, streams, base, seed in points:
        rng = np.random.default_rng(seed)
        shape = ((streams,) if streams else ()) + FRAME_HW + (3,)
        frames = [rng.integers(0, 255, shape, dtype=np.uint8)
                  for _ in range(4)]
        d = min(base.max_dets, nms_cfg.max_boxes_per_class)
        dp = -(-d // r) * r
        regimes = [("none", nms_cfg, 1.0)]
        if dp > r:
            regimes.append(("at most 16",) + few_bodies(
                torch, bundle, frames, base, nms_cfg, st_pipe, d, r))
        regimes.append(("loaded", nms_cfg, base.det_score_threshold))
        for name, ncfg, thr in regimes:
            trk = dataclasses.replace(base, det_score_threshold=thr)
            if streams:
                sw = host.BatchedBoTSORTPipeline(bundle, streams, trk,
                                                 ncfg, sw_pipe)
                st = host.BatchedBoTSORTPipeline(bundle, streams, trk,
                                                 ncfg, st_pipe)
            else:
                sw = host.BoTSORTPipeline(bundle, trk, ncfg, sw_pipe)
                st = host.BoTSORTPipeline(bundle, trk, ncfg, st_pipe)
            n_switch = len(switch.bucket_branches(None, dp, r))
            rows = []
            for i, f in enumerate(frames):
                pre = sw.stores if streams else sw.store
                before = (k9.launches, k7.launches, k8.launches,
                          k10.launches)
                t0 = time.perf_counter()
                sw.update(f)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                ran = (k9.launches - before[0], k7.launches - before[1],
                       k8.launches - before[2], k10.launches - before[3])
                res = sw.last_result
                if not np.all(res.nms_converged):
                    raise AssertionError("switch: NMS did not converge")
                values = fs_mod.switch_values(res, trk, ncfg, sw_pipe)
                widths = switch_widths(values, d, r)
                # K7: a step's detector crop and a crop a branch taken;
                # the first step's warm-up ran every branch once more.
                k7_want = 1 + sum(w > 0 for w in widths) + (
                    (1 + 2 * n_switch) if i == 0 else 0)
                if ran != (2, k7_want, 1 + (i == 0), 1 + (i == 0)):
                    raise AssertionError(f"switch ({label}, {name}): step "
                                         f"{i + 1} launched (K9, K7, K8, "
                                         f"K10) "
                                         f"{ran}, widths {widths}")
                new, packed = st._step(pre, st._upload("frame", f), *widths)
                want = packed.to_host()
                same_results(torch, host, [dict(result=want)],
                             [dict(result=res)], new,
                             sw.stores if streams else sw.store,
                             f"switch ({label}, {name}): step {i + 1} != "
                             f"the static graph at buckets {widths}")
                live = np.asarray(res.det_valid)[..., 0, :d].sum(-1)
                rows.append((ms, values, widths, live.tolist()))
            cache = sw._graphs
            if cache.captures != 1 or cache.keys()[0][5:7] != (None, None):
                raise AssertionError(f"switch ({label}, {name}): "
                                     f"{cache.captures} captures")
            k9_runs.append(k9.launches)
            step = (lambda p=sw, x=frames[-1]: p.update(x))
            n_dev, _, dev_ms = step_profile(torch, step)
            k9_ms, k9_n, _ = kernel_share(torch, step, K9_KERNEL)
            med = statistics.median(r_[0] for r_ in rows[1:])
            log(f"switch ({label}, {name}): det_score_threshold {thr!r}, "
                f"pre_nms_top_k {ncfg.pre_nms_top_k}, "
                f"live bodies {[r_[3] for r_ in rows]}, switch values "
                f"(bodies, faces + 1) {[r_[1] for r_ in rows]}, branch "
                f"widths {[r_[2] for r_ in rows]}; every step bit-equal "
                f"to the static-bucket graph at those buckets; 1 capture")
            log(f"timing: switch ({label}, {name}): graphed median "
                f"{med:.3f} ms a step over steps 2-{len(frames)} "
                f"({[round(r_[0], 3) for r_ in rows]}), {dev_ms:.3f} ms of "
                f"device time and {n_dev:.0f} device kernels a step under "
                f"torch.profiler, K9 {k9_ms * 1e3:.2f} us in {k9_n:.0f} "
                f"launches a step; {card}")
            if name == "loaded":
                if not streams:
                    k9_point = (k9_ms / max(k9_n, 1), k9_n)
                frame_dev = torch.from_numpy(frames[-1]).to(dev)
                store = sw.stores if streams else sw.store
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    if streams:
                        handle = sw.update_async(frames[-1])
                    else:
                        packed = sw._step(store, frame_dev, None, None)[1]
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                if streams:
                    handle.result()
                else:
                    packed.to_host()
                log(f"switch ({label}): a replay"
                    f"{' (update_async)' if streams else ''} ran under "
                    "set_sync_debug_mode('error')")
            del sw, st, cache
            gc.collect()  # before the next facade's captures (``drive``)
            torch.cuda.empty_cache()
    launches = k9.launches
    # K9 reads one int32 and sets one handle a branch.
    b_ms, b_by = bound(4 + 8 * 2, 2 * 2, F32_FLOPS)
    return launches, (k9_point[0], k9_plain_ms, b_ms, b_by, None)


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
    run, K10 once. Returns K2's, K7's and K10's launches and the first
    group's frames [B, T, H, W, 3]."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.ops import crop, hierarchy
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
    cuda, k7 = assignment_cuda.cascade_solve_cuda, crop.crop_resize_cuda
    k10 = hierarchy.greedy_scan_cuda
    cuda.launches = cuda.batched_launches = k7.launches = k10.launches = 0

    def check(res):
        if res.det_boxes.shape[:2] != (STREAMS, t_batch):
            raise AssertionError(f"temporal det_boxes {res.det_boxes.shape}")
        for x in (res.det_boxes, res.tracks.tlbr, res.tracks.score):
            if not np.isfinite(x).all():
                raise AssertionError("temporal: non-finite output")

    rows = drive(torch, pipe, groups, lambda: cuda.batched_launches,
                 force_at=3, gmc=gmc, check=check)
    k2_temporal, k7_temporal = cuda.batched_launches, k7.launches
    k10_temporal = k10.launches
    if k7_temporal != k7_expected(rows):
        raise AssertionError(f"temporal: K7 launched {k7_temporal} times, "
                             "not once a step run and once a non-zero "
                             "bucket")
    if k10_temporal != sum(expected_launches(r) for r in rows):
        raise AssertionError(f"temporal: K10 launched {k10_temporal} "
                             "times, not once a step run")
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
                bundle, frames.flatten(0, 1), *cfgs, rb, fb)
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
        f"runs {[r['runs'] for r in rows]}, K10 {k10_temporal} in all; live "
        f"tracks of the last group {n_tracks}")
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
    return k2_temporal, k7_temporal, k10_temporal, groups[0]


class ScanRecorder:
    """Wraps ops/hierarchy.py's greedy_scan: keeps a device copy of every
    call's four inputs (what K10 gets), without waiting for the card."""

    def __init__(self, hierarchy):
        self.real = hierarchy.greedy_scan
        self.calls = []

    def __call__(self, *args):
        self.calls.append([a.clone() for a in args])
        return self.real(*args)


def k10_inputs(torch, hierarchy, bundle, frames_dev, cfgs):
    """(iou, dist, used0, round_active): what K10 gets in a step on
    ``frames_dev`` [G, H, W, 3], recorded from the step's perception run
    eagerly at buckets (0, 0) (the hierarchy runs before the encoders)."""
    from botsort_tpu_torch.pipeline import frame_step as fs_mod

    rec = ScanRecorder(hierarchy)
    with torch.no_grad(), mock.patch.object(hierarchy, "greedy_scan", rec):
        fs_mod._perception_batched(bundle, frames_dev, *cfgs, 0, 0)
    if len(rec.calls) != 1:
        raise AssertionError(f"a step called the hierarchy scan "
                             f"{len(rec.calls)} times")
    return rec.calls[0]


def k10_ties(torch, hierarchy, dev, n=50, targets=None, rounds=2):
    """Adversarial inputs for K10, made by ops/hierarchy.py::scan_inputs:
    3 x STREAMS problems of n bases x ``targets`` (n) targets with rounds
    (1, 1, ``rounds``), a quarter each of duplicated boxes (every box
    twice: IoU and distance ties, the lowest index wins), boxes on an
    8-pixel grid with sides 16, 24 or 32 (exact ties everywhere), 60%
    invalid bases and targets, and no valid box at all."""
    t = n if targets is None else targets
    rng = np.random.default_rng(15)
    problems = []
    for i in range(3 * STREAMS):
        kind = i % 4
        if kind == 1:
            tl = rng.integers(0, 12, (n + t, 2)) * 8.0
            boxes = np.concatenate(
                [tl, tl + rng.choice([16.0, 24.0, 32.0], (n + t, 2))], -1)
        else:
            tl = rng.uniform(0, 300, (n, 2))
            base = np.concatenate([tl, tl + rng.uniform(20, 80, (n, 2))], -1)
            boxes = np.concatenate([base, base[rng.integers(0, n, t)]
                                    + rng.uniform(-10, 10, (t, 4))])
        if kind == 0:
            boxes[1::2] = boxes[0::2][:len(boxes) // 2]
        valid = rng.uniform(0, 1, n + t) < (0.4 if kind == 2 else 0.9)
        if kind == 3:
            valid[:] = False
        b = torch.from_numpy(boxes.astype(np.float32)).to(dev)
        v = torch.from_numpy(valid).to(dev)
        problems.append((b[:n], v[:n], b[n:], v[n:],
                         rounds if i % 3 == 2 else 1))
    return hierarchy.scan_inputs(problems)


# K10 past the warp-a-problem form (a block a problem) and past one word
# of rounds: (label, bases, targets, rounds) of k10_ties' adversarial
# problems (R = 33 with few bases, each overlapping some 50 targets).
K10_LARGE = (("ties T = 1025", 50, 1025, 2), ("ties T = 2048", 50, 2048, 2),
             ("ties R = 33", 4, 200, 33))


def k10_large(torch, hierarchy, dev, card):
    """K10 against greedy_scan_plain, bit for bit, on k10_ties' problems
    with 1,025 and 2,048 targets (a block a problem, keys and used bits in
    the scratch buffer) and with 33 rounds; CUDA-event, graph and plain
    times and the bound. Returns the largest index difference (0)."""
    k10 = hierarchy.greedy_scan_cuda
    max_err = 0
    for label, bases, targets, rounds in K10_LARGE:
        args = k10_ties(torch, hierarchy, dev, n=bases, targets=targets,
                        rounds=rounds)
        want = hierarchy.greedy_scan_plain(*args)
        got = k10(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, index_err(torch, got, want,
                                         f"K10 != plain on {label}"))
        p, b, t = args[0].shape
        r = args[3].shape[1]
        scratch = hierarchy._lib().hierarchy_scan_scratch_bytes(p, t)
        run = lambda a=args: k10(*a)  # noqa: E731
        ms, ms_graph = event_ms(torch, run, 20), graph_ms(torch, run)
        plain_ms = event_ms(torch, lambda a=args:
                            hierarchy.greedy_scan_plain(*a), 1)
        nbytes = p * b * t * 8 + p * t + p * r + b * p * r * 4
        b_ms, b_by = bound(nbytes, 4 * b * r * p * t, F32_FLOPS)
        late = int((want[:, :, 32:] >= 0).sum()) if r > 32 else 0
        form = "a block" if t > hierarchy.WARP_TARGETS else "a warp"
        log(f"timing: K10 {label}: [{p}, {b}, {t}], {r} rounds, "
            f"{int((want >= 0).sum())} claims of {b * p * r} ({late} past "
            f"round 32), {form} a problem, scratch {scratch} B; kernel "
            f"{ms:.4f} ms eager, "
            f"{ms_graph:.4f} ms graph; plain {plain_ms:.4f} ms eager; bound "
            f"{b_ms:.6f} ms by {b_by} ({nbytes} B); library: none; {card}")
        if r > 32 and not late:
            raise AssertionError(f"K10 {label}: no claim past round 32")
    log(f"K10: equal to the plain version bit for bit on all "
        f"{len(K10_LARGE)} inputs past 1,024 targets or 32 rounds")
    return max_err


def phase_k10(torch, bundle, main_frame, multi_frames, temporal_frames,
              main_cfgs, multi_cfgs, card, floor):
    """K10 against greedy_scan_plain on the card, bit for bit, on the
    inputs of the loaded one-stream, the 8-stream and the temporal steps
    and on adversarial ties; CUDA-event, graph and plain times, the
    unrolled loop it replaced from a graph with its device kernels a call,
    the bound and the floor. Then the graphed loaded one-stream and
    8-stream facades with K10 and with the plain loop patched in (the only
    place that patches it) over the same frames: bit-equal, K10 silent in
    the patched runs; device kernels and device ms a step profiled in the
    order plain, K10, K10, plain, and the steady medians. Returns (max
    index difference, (ms, plain ms, bound ms, bound by, library ms)) at
    the loaded one-stream step's inputs."""
    import contextlib

    from botsort_tpu_torch.ops import hierarchy
    from botsort_tpu_torch.pipeline import host

    dev = bundle.device
    k10 = hierarchy.greedy_scan_cuda
    on_card = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    cases = (
        ("loaded one stream", k10_inputs(torch, hierarchy, bundle,
                                         on_card(main_frame)[None],
                                         main_cfgs)),
        (f"{STREAMS} streams", k10_inputs(torch, hierarchy, bundle,
                                          on_card(multi_frames),
                                          multi_cfgs)),
        (f"temporal {STREAMS} x {temporal_frames.shape[1]}", k10_inputs(
            torch, hierarchy, bundle,
            on_card(temporal_frames).flatten(0, 1), multi_cfgs)),
        ("adversarial ties", k10_ties(torch, hierarchy, dev)))
    max_err, first = 0, None
    for label, args in cases:
        want = hierarchy.greedy_scan_plain(*args)
        got = k10(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, index_err(torch, got, want,
                                         f"K10 != plain on {label}"))
        p, b, t = args[0].shape
        r = args[3].shape[1]
        run = lambda a=args: k10(*a)  # noqa: E731
        plain = lambda a=args: hierarchy.greedy_scan_plain(*a)  # noqa: E731
        ms, ms_graph = event_ms(torch, run, 100), graph_ms(torch, run)
        plain_ms = event_ms(torch, plain, 3)
        plain_graph = graph_ms(torch, plain, calls=2, replays=5)
        plain_kernels = step_profile(torch, plain)[0]
        # iou and dist read once, used0 and round_active once, picks written
        # once; per claim and target a select, a max, a candidate test and
        # an argmin comparison.
        nbytes = p * b * t * 8 + p * t + p * r + b * p * r * 4
        b_ms, b_by = bound(nbytes, 4 * b * r * p * t, F32_FLOPS)
        # Each frame's problems claim faces, heads and hands, in turn.
        targets = (~args[2]).reshape(-1, 3, t).sum((0, 2)).tolist()
        log(f"timing: K10 {label}: [{p}, {b}, {t}], {r} rounds, valid "
            f"targets (faces, heads, hands) {targets}, "
            f"{int((want >= 0).sum())} claims of {b * p * r}; kernel "
            f"{ms:.4f} ms eager, {ms_graph:.4f} ms graph; plain "
            f"{plain_ms:.4f} ms eager (the loop it replaced), "
            f"{plain_graph:.4f} ms graph in {plain_kernels:.0f} device "
            f"kernels a call; bound {b_ms:.6f} ms by {b_by} ({nbytes} B); "
            f"library: none (no PyTorch call claims greedily); empty-node "
            f"floor {floor:.4f} ms; {card}")
        if first is None:
            first = (ms, plain_ms, b_ms, b_by, None)
    log(f"K10: equal to the plain version bit for bit on all {len(cases)} "
        "inputs")
    max_err = max(max_err, k10_large(torch, hierarchy, dev, card))

    def plain_on_card(*args):
        return hierarchy.greedy_scan_plain(*args)

    def patched(mode):
        return (mock.patch.object(hierarchy, "greedy_scan", plain_on_card)
                if mode == "plain" else contextlib.nullcontext())

    points = (("loaded one stream", 0, main_cfgs, 20),
              (f"{STREAMS} streams moderate-16", STREAMS, multi_cfgs, 21))
    for label, streams, cfgs, seed in points:
        rng = np.random.default_rng(seed)
        shape = ((streams,) if streams else ()) + FRAME_HW + (3,)
        frames = [rng.integers(0, 255, shape, dtype=np.uint8)
                  for _ in range(6)]
        pipes, rows = {}, {}
        for mode in ("K10", "plain"):
            pipes[mode] = (host.BatchedBoTSORTPipeline(bundle, streams, *cfgs)
                           if streams else host.BoTSORTPipeline(bundle, *cfgs))
            with patched(mode):
                rows[mode] = drive(torch, pipes[mode], frames,
                                   lambda: k10.launches)
            n = sum(r["launches"] for r in rows[mode])
            want = 0 if mode == "plain" else sum(
                expected_launches(r) for r in rows[mode])
            if n != want:
                raise AssertionError(f"K10 ({label}, {mode}): K10 launched "
                                     f"{n} times, not {want}")
        stores = {m: (p.stores if streams else p.store)
                  for m, p in pipes.items()}
        same_results(torch, host, rows["K10"], rows["plain"], stores["K10"],
                     stores["plain"],
                     f"K10 ({label}): the step with K10 != with the plain "
                     "loop")
        prof = {"K10": [], "plain": []}
        for mode in ("plain", "K10", "K10", "plain"):
            with patched(mode):
                prof[mode].append(step_profile(
                    torch, lambda p=pipes[mode]: p.update(frames[-1])))
        line = []
        for mode in ("K10", "plain"):
            n_dev = statistics.mean(x[0] for x in prof[mode])
            dev_ms = statistics.mean(x[2] for x in prof[mode])
            med = statistics.median(steady_ms(rows[mode]))
            line.append(f"{mode}: median {med:.3f} ms a step, "
                        f"{n_dev:.0f} device kernels and copies, "
                        f"{dev_ms:.3f} ms of device time a step "
                        f"(profiles {[round(x[2], 3) for x in prof[mode]]})")
        log(f"K10 ({label}): graphed with K10 equals graphed with the "
            f"plain loop on every FrameResult field of {len(frames)} steps "
            f"and the final stores")
        log(f"timing: K10 end to end, {label} graphed (profiled plain, "
            f"K10, K10, plain): " + "; ".join(line) + f"; {card}")
        del pipes, rows, stores
        gc.collect()  # before the next point's captures (``drive``)
        torch.cuda.empty_cache()
    return max_err, first


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


def release_layers(torch, imp, model, sample):
    """[(kind, arrays)] a release graph of ``model`` carries, in call order
    (runtime/import_onnx.py::execution_order): OIHW conv kernels with their
    biases, BatchNormalization quads, Gemm (out, in) with transB=1. Kind by
    kind, the layers tests/test_import_mapping.py::synth_onnx_layers makes
    of a Flax tree; here from the network's float32 state."""
    state = {k: v.detach().to("cpu", torch.float32).numpy()
             for k, v in model.state_dict().items()}
    layers = []
    for kind, p in imp.model_entries(model,
                                     imp.execution_order(model, sample)):
        if kind == "bn":
            layers.append(("bn", {"scale": state[p + ".weight"],
                                  "bias": state[p + ".bias"],
                                  "mean": state[p + ".running_mean"],
                                  "var": state[p + ".running_var"],
                                  "name": p}))
        elif kind == "conv":
            layers.append(("conv", {"kernel": state[p + ".weight"],
                                    "bias": state.get(p + ".bias"),
                                    "name": p}))
        else:
            layers.append(("gemm", {"kernel": state[p + ".weight"],
                                    "bias": state.get(p + ".bias"),
                                    "transB": 1, "name": p}))
    return layers


def fold_norms(layers, eps):
    """The layers of a fused export (tests/test_import_adversarial.py::
    _fold_bn_layers): every norm that follows a conv not yet folded into,
    at its width, is folded into it (kernel scaled, bias made); the other
    norms stay BatchNormalization nodes."""
    out, last, claimed = [], None, set()
    for kind, arrs in layers:
        if kind == "conv":
            out.append((kind, dict(arrs)))
            last = len(out) - 1
        elif kind == "bn" and last is not None and last not in claimed \
                and out[last][1]["kernel"].shape[0] == arrs["scale"].shape[0]:
            claimed.add(last)
            conv = out[last][1]
            inv = arrs["scale"] / np.sqrt(arrs["var"] + eps)
            conv["kernel"] = (conv["kernel"] * inv[:, None, None, None]
                              ).astype(np.float32)
            old_b = conv["bias"] if conv["bias"] is not None else 0.0
            conv["bias"] = (arrs["bias"] + (old_b - arrs["mean"]) * inv
                            ).astype(np.float32)
        else:
            out.append((kind, arrs))
    return out


def encode_release(lite, layers, tail, wrap_conv=None):
    """Wire bytes of ``layers`` in a release graph's shape, the JAX
    package's import tests' bytes: an activation after every conv, conv
    ``wrap_conv``'s weight behind an Identity node, and the releases' tail
    after the last layer: ``"post"``, the detector's decode and NMS nodes
    with their constants (tests/test_import_adversarial.py::
    _encode_with_tail), or ``"feature"``, the encoders'
    ``post_feature_only`` L2 normalisation and similarity matmul
    (tests/test_import_fullscale.py::_feature_tail)."""
    act = "Sigmoid" if tail == "post" else "Relu"
    nodes, inits, value, conv_i = [], [], "x", 0
    for idx, (kind, arrs) in enumerate(layers):
        out = f"t{idx}"
        if kind == "bn":
            names = [f"{part}{idx}" for part in ("scale", "bias", "mean",
                                                  "var")]
            inits += [lite.encode_tensor(n, arrs[part]) for n, part in zip(
                names, ("scale", "bias", "mean", "var"))]
            nodes.append(lite.encode_node("BatchNormalization",
                                          [value] + names, [out],
                                          name=f"bn_{idx}"))
            value = out
            continue
        wname = f"w{idx}"
        inits.append(lite.encode_tensor(wname, arrs["kernel"]))
        if kind == "conv" and conv_i == wrap_conv:
            nodes.append(lite.encode_node("Identity", [wname],
                                          [wname + "_id"],
                                          name=f"wrap_{idx}"))
            wname += "_id"
        inputs = [value, wname]
        if arrs.get("bias") is not None:
            inits.append(lite.encode_tensor(f"b{idx}", arrs["bias"]))
            inputs.append(f"b{idx}")
        if kind == "conv":
            nodes.append(lite.encode_node("Conv", inputs, [out],
                                          name=f"conv_{idx}"))
            conv_i += 1
            nodes.append(lite.encode_node(act, [out], [out + "_act"],
                                          name=f"act_{idx}"))
            out += "_act"
        else:
            nodes.append(lite.encode_node(
                "Gemm", inputs, [out], name=f"gemm_{idx}",
                int_attrs={"transB": int(arrs.get("transB") or 0)}))
        value = out
    if tail == "post":
        for nm, arr in (
                ("grid", np.arange(24, dtype=np.float32).reshape(1, 24)),
                ("strides_c", np.full((1, 24), 8.0, np.float32)),
                ("starts", np.asarray([0], np.int64)),
                ("ends", np.asarray([4], np.int64)),
                ("maxout", np.asarray([20], np.int64))):
            inits.append(lite.encode_tensor(nm, arr))
        ops = [("Add", [value, "grid"], ["dec_xy"]),
               ("Exp", [value], ["dec_exp"]),
               ("Mul", ["dec_exp", "strides_c"], ["dec_wh"]),
               ("Slice", ["dec_xy", "starts", "ends"], ["dec_xy4"]),
               ("Concat", ["dec_xy4", "dec_wh"], ["dec_boxes"]),
               ("NonMaxSuppression", ["dec_boxes", "dec_xy", "maxout"],
                ["nms_idx"]),
               ("Gather", ["dec_boxes", "nms_idx"], ["final"])]
    else:
        ops = [("ReduceL2", [value], ["feat_norm"]),
               ("Clip", ["feat_norm"], ["feat_norm_c"]),
               ("Div", [value, "feat_norm_c"], ["features"]),
               ("Transpose", ["features"], ["features_t"]),
               ("MatMul", ["target_features", "features_t"],
                ["similarities"])]
    for op, ins, outs in ops:
        nodes.append(lite.encode_node(op, ins, outs, name=f"tail_{op}"))
    return lite.encode_model(nodes, inits)


def perturb_weights_(torch, assets, model, rng):
    """``assets.perturb_norms_`` and every conv bias drawn from ``rng``:
    no two norms or biases of one width hold the same values, so a swap
    in the import shows."""
    assets.perturb_norms_(model, rng)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.from_numpy(rng.normal(
                    0.0, 0.1, tuple(m.bias.shape)).astype(np.float32)))
    return model


def phase_onnx(torch, assets, bundle, assignment_cuda, bn_act, card):
    """The release files' route into the port, on the card machine with no
    JAX: full-width wire files of seeded float32 networks (norms and
    biases perturbed) in the release layouts, each imported through
    cli/import_onnx.py bit for bit, then build_bundle(weights_dir=...)
    with no warning, and the loaded one-stream graphed pipeline bit-equal
    to the source networks' over the main phase's frames (K1, K6, K7 and
    K8 launching); a fully fused face file's features within
    FUSED_FACE_RTOL of its source's."""
    import contextlib
    import copy
    import io
    import shutil
    import tempfile

    from botsort_tpu_torch.cli import import_onnx as cli
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.models.common import cast_compute
    from botsort_tpu_torch.ops import crop, nms
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.pipeline.frame_step import ModelBundle
    from botsort_tpu_torch.runtime import import_onnx as imp
    from botsort_tpu_torch.runtime import onnx_lite

    dev = bundle.device
    dtype = next(bundle.detector.parameters()).dtype  # the conv weights'
    files = {"detector": assets.DEFAULT_DETECTOR,
             "body_encoder": assets.DEFAULT_BODY_REID,
             "face_encoder": assets.DEFAULT_FACE_REID}
    tmp = tempfile.mkdtemp(prefix="botsort_onnx_")
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            src = assets.build_bundle(weights_dir=os.path.join(tmp, "none"),
                                      seed=0, device="cpu",
                                      dtype=torch.float32)
        rng = np.random.default_rng(14)
        stats = []
        for name, field, tail in ONNX_NETWORKS:
            model = perturb_weights_(torch, assets, getattr(src, field), rng)
            sample = torch.zeros((1,) + ONNX_TRACE_HW[name] + (3,))
            path = os.path.join(tmp, files[field])
            with open(path, "wb") as f:
                f.write(encode_release(
                    onnx_lite, release_layers(torch, imp, model, sample),
                    tail, wrap_conv=1 if tail == "post" else None))
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["--model", name, "--onnx", path,
                               "--weights_dir", tmp, "--input-hw",
                               *map(str, ONNX_TRACE_HW[name])])
            secs = time.perf_counter() - t0
            if rc != 0 or err.getvalue():
                raise AssertionError(f"onnx: {name} import gave rc {rc}, "
                                     f"{err.getvalue()!r}")
            got = torch.load(assets.checkpoint_path(tmp, files[field]),
                             weights_only=True)
            want = model.state_dict()
            if set(got) != set(want) or not all(
                    got[k].dtype == torch.float32 and torch.equal(got[k],
                                                                 want[k])
                    for k in want):
                raise AssertionError(f"onnx: {name}'s checkpoint differs "
                                     "from its source")
            stats.append((name, os.path.getsize(path), secs, len(want)))
            log(f"onnx: {name}: {os.path.getsize(path)} bytes of ONNX, "
                f"imported in {secs:.3f} s ({out.getvalue().strip()}), "
                f"{len(want)} tensors bit-equal to the source; {card}")

        # A fully fused face file (every norm folded into its conv).
        face = src.face_encoder
        sample = torch.zeros((1,) + ONNX_TRACE_HW["facereid"] + (3,))
        plain = release_layers(torch, imp, face, sample)
        fused = fold_norms(plain, imp.BN_EPS["facereid"])
        n_norms = sum(1 for k, _ in plain if k == "bn")
        fused_path = os.path.join(tmp, "face_fused.onnx")
        with open(fused_path, "wb") as f:
            f.write(encode_release(onnx_lite, fused, "feature"))
        fused_pt = os.path.join(tmp, "face_fused.pt")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = cli.main(["--model", "facereid", "--onnx", fused_path,
                           "--out", fused_pt, "--input-hw",
                           *map(str, ONNX_TRACE_HW["facereid"])])
        fused_secs = time.perf_counter() - t0
        report = err.getvalue().strip()
        if rc != 0 or any(k == "bn" for k, _ in fused) or not \
                report.startswith("fused Conv+BN export detected: "
                                  f"synthesized {n_norms} identity"):
            raise AssertionError(f"onnx: fused face import: rc {rc}, "
                                 f"{report!r}")
        fused_state = torch.load(fused_pt, weights_only=True)
        for kind, arrs in fused:
            key = arrs["name"] + ".weight"
            if not torch.equal(fused_state[key],
                               torch.from_numpy(arrs["kernel"])):
                raise AssertionError(f"onnx: fused face {key} differs")

        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            loaded = assets.build_bundle(weights_dir=tmp, seed=5, device=dev,
                                         dtype=dtype)
        if err.getvalue():
            raise AssertionError(f"onnx: build_bundle said {err.getvalue()!r}")
        ref = ModelBundle(*(cast_compute(copy.deepcopy(getattr(src, f)),
                                         dtype).to(dev).eval()
                            for _, f, _ in ONNX_NETWORKS))
        for _, field, _ in ONNX_NETWORKS:
            a = getattr(ref, field).state_dict()
            b = getattr(loaded, field).state_dict()
            if not all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                       for k in a):
                raise AssertionError(f"onnx: the loaded {field} differs "
                                     "from its source cast to the card")

        fused_face = imp.build_model("facereid")[0]
        fused_face.load_state_dict(fused_state)
        fused_face.to(dev)
        src_face = copy.deepcopy(face).to(dev)
        faces = torch.from_numpy(np.random.default_rng(15).uniform(
            0, 255, (N_FACES, 128, 128, 3)).astype(np.float32)).to(dev)
        with torch.no_grad():
            want, got = src_face(faces), fused_face(faces)
        rel = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
        if not torch.isfinite(got).all() or not rel <= FUSED_FACE_RTOL:
            raise AssertionError(f"onnx: the fused face's features are {rel} "
                                 f"relative L2 from the source's")
        del fused_face, src_face
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    cfgs = (loaded_cfg(TrackerConfig), NMSConfig(), PipelineConfig())
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, FRAME_HW + (3,), dtype=np.uint8)
              for _ in range(8)]
    check = lambda res: check_finite(res, cfgs[1])  # noqa: E731
    pipes, rows, launched = {}, {}, {}
    counters = (assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda,
                crop.crop_resize_cuda, nms.nms_fixpoint_cuda)
    for which, b in (("source", ref), ("loaded", loaded)):
        pipes[which] = host.BoTSORTPipeline(b, *cfgs)
        before = [c.launches for c in counters]
        rows[which] = drive(torch, pipes[which], frames, lambda: 0,
                            force_at=4, check=check)
        launched[which] = [c.launches - n for c, n in zip(counters, before)]
        if min(launched[which]) < 1:
            raise AssertionError(f"onnx: the {which} run launched K1, K6, "
                                 f"K7, K8 {launched[which]} times")
    same_results(torch, host, rows["source"], rows["loaded"],
                 pipes["source"].store, pipes["loaded"].store,
                 "onnx: loaded != source")
    dets = [int(r["result"].det_valid.sum()) for r in rows["loaded"]]
    if max(dets) < 1:
        raise AssertionError("onnx: no detection on any frame")
    log(f"onnx: the imported bundle's graphed one-stream run equals the "
        f"source's on every FrameResult field of {len(frames)} frames and "
        f"on the final store (detections per frame {dets}, K1/K6/K7/K8 "
        f"launches {launched['loaded']}); fused face file: {report.split(';')[0]}, "
        f"imported in {fused_secs:.3f} s, features {rel:.3e} relative L2 "
        f"from the source's (limit {FUSED_FACE_RTOL}); {card}")
    log("timing: onnx import " + json.dumps(
        {n: {"bytes": nb, "seconds": round(s, 3), "tensors": nt}
         for n, nb, s, nt in stats}) + f"; {card}")


def phase_export(torch, bundle, assignment_cuda, bn_act, card):
    """The program of one bucket pair exported (runtime/exported.py),
    saved, loaded and replayed from CUDA graphs: load_pipeline at the
    loaded one-stream point (K1) and load_batched_pipeline at 8 streams,
    moderate-16 (K2). Over 8 seeded frames every FrameResult field and the
    final stores equal the live facade's, replayed from graphs at the same
    bucket set; K1/K2, K6, K7, K8 and K10 are counted on replay, K6, K7, K8
    and K10 as often as in the live run."""
    import shutil
    import tempfile

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.ops import crop, hierarchy, nms
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.runtime import exported

    cuda, k6 = assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda
    k7, k8 = crop.crop_resize_cuda, nms.nms_fixpoint_cuda
    k10 = hierarchy.greedy_scan_cuda
    tmp = tempfile.mkdtemp(prefix="botsort_export_")
    points = (("one stream, loaded", 0, loaded_cfg(TrackerConfig), 0),
              (f"{STREAMS} streams, moderate-16", STREAMS,
               loaded_cfg(TrackerConfig, max_dets=16), 1))
    try:
        for label, streams, tracker_cfg, seed in points:
            cfgs = (tracker_cfg, NMSConfig(), PipelineConfig())
            d = min(tracker_cfg.max_dets, cfgs[1].max_boxes_per_class)
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
            programs.program(streams, FRAME_HW, d, d)
            load_s = time.perf_counter() - t0
            ops = sorted({str(n.target) for n in programs.exported_program(
                streams, FRAME_HW, d, d).graph.nodes
                if "botsort_tpu_torch" in str(n.target)})
            want_ops = ["botsort_tpu_torch.bn_act.default",
                        "botsort_tpu_torch.cascade_solve.default",
                        "botsort_tpu_torch.crop_resize.default",
                        "botsort_tpu_torch.hierarchy_scan.default",
                        "botsort_tpu_torch.nms_fixpoint.default"]
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
            rows, k6_runs, k7_runs, k8_runs, k10_runs = {}, {}, {}, {}, {}
            for mode, pipe in (("live", live), ("loaded", loaded)):
                cuda.launches = cuda.batched_launches = k6.launches = 0
                k7.launches = k8.launches = k10.launches = 0
                rows[mode] = drive(torch, pipe, frames, launches_of)
                k6_runs[mode], k7_runs[mode] = k6.launches, k7.launches
                k8_runs[mode], k10_runs[mode] = k8.launches, k10.launches
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
            if k7_runs["loaded"] != k7_runs["live"] or k7_runs["loaded"] != \
                    k7_expected(rows["loaded"]):
                raise AssertionError(f"export ({label}): K7 {k7_runs}")
            for name, runs in (("K8", k8_runs), ("K10", k10_runs)):
                if runs["loaded"] != runs["live"] or runs["loaded"] != \
                        sum(expected_launches(r) for r in rows["loaded"]):
                    raise AssertionError(f"export ({label}): {name} {runs}")
            nbytes = [e["bytes"] for e in entries]
            secs = [round(e["export_seconds"], 3) for e in entries]
            med = {m: statistics.median(steady_ms(rows[m])) for m in rows}
            log(f"export ({label}): {len(entries)} program (buckets "
                f"({d},{d}); the NMS fixpoint runs to its end inside it) in "
                f"{export_s:.3f} s (each {secs} s), {nbytes} bytes, loaded "
                f"in {load_s:.3f} s; the graph calls {ops}; over "
                f"{len(frames)} frames replayed from graphs every "
                f"FrameResult field and the final stores equal the live "
                f"facade's; solver launches {kernel_launches} over runs "
                f"{[r['runs'] for r in rows['loaded']]}, K6 launches "
                f"{k6_runs['loaded']} (live {k6_runs['live']}), K7 launches "
                f"{k7_runs['loaded']} (live {k7_runs['live']}), K8 launches "
                f"{k8_runs['loaded']} (live {k8_runs['live']}), K10 launches "
                f"{k10_runs['loaded']} (live {k10_runs['live']})")
            log(f"timing: export ({label}): replayed median live "
                f"{med['live']:.3f} ms, loaded {med['loaded']:.3f} ms a "
                f"step in this call; {card}")
            del live, loaded, programs
            gc.collect()  # before the next point's captures (``drive``)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_serve(torch, bundle, card):
    """cli/serve.py's server on a localhost thread with a numpy decoder,
    its connections sharing one graph cache: cold, and after warm_up has
    captured the program of every bucket pair at 1080p (--warmup_hw). The
    JSON of 4 frames equals a pipeline driven directly; prints the first
    request's latency both ways, each pair's capture time and the card's
    reserved memory afterwards."""
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
        f"tracks); warm_up captured {len(warmed)} steps (one program a "
        f"bucket pair, {len({k for k, _ in warmed})} pairs), {caps_warm} "
        f"graphs in all (cold server: {caps_cold})")
    log(f"timing: serve: first request {ms_cold[0]:.3f} ms cold, "
        f"{ms_warm[0]:.3f} ms after warm_up; later requests "
        f"{[round(x, 3) for x in ms_warm[1:]]} ms; capture seconds per "
        f"(reid bucket, face bucket) "
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
    equal across the runs, K7's, K8's and K10's too; prints each run's
    median and the two routes' (the dispatcher's host cost on the eager
    step)."""
    import contextlib

    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.ops import crop, hierarchy, nms
    from botsort_tpu_torch.pipeline import host

    cuda, k6 = assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda
    k7, k8 = crop.crop_resize_cuda, nms.nms_fixpoint_cuda
    k10 = hierarchy.greedy_scan_cuda
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
            k7.launches = k8.launches = k10.launches = 0
            rows = drive(torch, pipe, frames, lambda: cuda.launches)
        runs.append((route, rows, pipe.store,
                     (cuda.launches, cuda.batched_launches, k6.launches,
                      k7.launches, k8.launches, k10.launches)))
    _, rows0, store0, launches0 = runs[0]
    for route, rows, store, launches in runs[1:]:
        same_results(torch, host, rows0, rows, store0, store,
                     f"oproute: the {route} route's run differs")
        if launches != launches0:
            raise AssertionError(f"oproute: launches (K1, K2, K6, K7, K8, "
                                 f"K10) {launches} against {launches0}")
    if launches0[0] < len(frames) or launches0[1] or launches0[2] < 1 or \
            min(launches0[3:]) < len(frames):
        raise AssertionError(f"oproute: launches (K1, K2, K6, K7, K8, K10) "
                             f"{launches0}")
    med = {}
    for route, rows, _, _ in runs:
        med.setdefault(route, []).extend(steady_ms(rows))
    each = [(route, round(statistics.median(steady_ms(rows)), 3))
            for route, rows, _, _ in runs]
    d, o = (statistics.median(med[r]) for r in ("direct", "op"))
    calls = (launches0[0] + sum(launches0[2:])) / len(frames)
    log(f"oproute: {len(frames)} eager frames at the loaded one-stream "
        f"point, kernels called directly and through torch.ops."
        f"botsort_tpu_torch, runs in the order direct, op, op, direct: "
        f"every FrameResult field, the final stores and the launches equal "
        f"(K1, K2, K6, K7, K8, K10 per run: {launches0})")
    log(f"timing: oproute: eager one-stream step median {d:.3f} ms direct, "
        f"{o:.3f} ms through the custom ops ({o - d:+.3f} ms, "
        f"{1e3 * (o - d) / calls:+.1f} us a kernel call over {calls:.1f} "
        f"calls a frame); each run's median {each}, spread of the direct "
        f"runs' steady frames {min(med['direct']):.3f}-"
        f"{max(med['direct']):.3f} ms; {card}")


class NormRecorder:
    """Records (shape, dtype, activation) of every BatchNorm call of some
    networks (a bundle's three by default)."""

    def __init__(self, bundle, BatchNorm, nets=None):
        self.calls = {}
        # Calls whose input had its channels innermost (channels-last).
        self.channels_last = 0
        nets = nets or (bundle.detector, bundle.body_encoder,
                        bundle.face_encoder)
        self.handles = [m.register_forward_pre_hook(self) for net in nets
                        for m in net.modules() if isinstance(m, BatchNorm)]

    def __call__(self, module, args):
        act = args[1] if len(args) > 1 else "none"
        key = (tuple(args[0].shape), args[0].dtype, act)
        self.calls[key] = self.calls.get(key, 0) + 1
        self.channels_last += int(args[0].movedim(1, -1).is_contiguous())

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


def phase_k6(torch, F, bn_act, bundle, points, card):
    """K6 on every norm shape of the steps ``points`` names ((label, frames
    [B, H, W, 3], cfgs, networks or None for all three), recorded from the
    networks at full buckets) and on odd shapes, in float32 and bfloat16
    with the four activations: its channels-innermost path (the layout the
    networks run on the card) against bn_act_plain and bit-equal to its
    NCHW path on the contiguous copy. Then both paths' times over each
    step's norms against the plain version, the eager chain K6 replaced and
    its bound. Returns (max abs error, (ms, plain ms, bound ms, bound by,
    library ms)) of the channels-last path over the first step."""
    from botsort_tpu_torch.models.common import BatchNorm
    from botsort_tpu_torch.pipeline import frame_step as fs_mod
    from botsort_tpu_torch.track.state import empty_stores

    dev = bundle.device
    recorded = []
    for label, frames, cfgs, nets in points:
        recorder = NormRecorder(bundle, BatchNorm, nets)
        try:
            d = cfgs[0].max_dets
            fs_mod.frame_step_batched(
                bundle, empty_stores(cfgs[0], frames.shape[0], dev),
                torch.from_numpy(frames).to(dev), *cfgs, reid_bucket=d,
                face_bucket=d)
        finally:
            recorder.remove()
        if recorder.channels_last != sum(recorder.calls.values()):
            raise AssertionError(
                f"K6 ({label}): {recorder.channels_last} of "
                f"{sum(recorder.calls.values())} norm inputs channels-last")
        recorded.append((label, recorder.calls))
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(66)
    channels_last = torch.channels_last

    def draw(shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, device=dev, generator=gen)
        return lo + (hi - lo) * torch.rand(shape, device=dev, generator=gen)

    def inputs(shape, dtype):
        c = shape[1]
        x = (2.0 * draw(shape)).to(dtype)
        if x.dim() == 4:
            x = x.to(memory_format=channels_last)
        mean, bias = 0.5 * draw((c,)), 0.5 * draw((c,))
        var, weight = draw((c,), 0.3, 1.8), draw((c,), 0.3, 1.8)
        return x, mean, var, weight, bias, torch.rsqrt(var + 1e-3) * weight

    odd = [(3, 7, 5, 3), (2, 1280, 15, 20), (5, 33), (1, 1, 1, 1),
           (2, 6, 9, 13), (3, 20, 5, 7), (4, 24, 1, 1)]
    shapes = sorted({key for _, calls in recorded for key in calls}, key=str)
    n_path = len(shapes)
    shapes += [(shape, dtype, act) for shape in odd
               for dtype in (torch.float32, torch.bfloat16)
               for act in bn_act.ACTS]
    max_err, worst_ulp = 0.0, 0
    for shape, dtype, act in shapes:
        x, mean, _, _, bias, mul = inputs(shape, dtype)
        before = bn_act.bn_act_cuda.launches_channels_last
        got = bn_act.bn_act_cuda(x, mean, mul, bias, act)
        if bn_act.bn_act_cuda.launches_channels_last != before + 1:
            raise AssertionError(f"K6: {shape} did not take the "
                                 "channels-innermost path")
        nchw = bn_act.bn_act_cuda(x.contiguous(), mean, mul, bias, act)
        want = bn_act.bn_act_plain(x, mean, mul, bias, act)
        torch.cuda.synchronize()
        ulps = ulp_apart(torch, got, want)
        if ulps > (1 if act == "silu" else 0) or not torch.equal(got, nchw):
            raise AssertionError(f"K6 != plain or NCHW on {shape} {dtype} "
                                 f"{act}: {ulps} units in the last place")
        worst_ulp = max(worst_ulp, ulps)
        max_err = max(max_err, float((got.float() - want.float()).abs()
                                     .max()))
    log(f"K6: {len(shapes)} cases ({n_path} norm shapes of "
        f"{' and '.join(label for label, _ in recorded)}, {len(odd)} odd "
        "shapes x 2 dtypes x 4 activations) on the channels-innermost path "
        "bit-equal to the NCHW path; none / ReLU / ReLU6 bit for bit to the "
        f"plain version, SiLU within {worst_ulp} unit in the last place")
    first = None
    for label, calls in recorded:
        t = {k: 0.0 for k in ("cl", "cl_graph", "nchw", "nchw_graph",
                              "plain", "lib")}
        nbytes = flops = n_calls = 0
        for (shape, dtype, act), count in sorted(calls.items(), key=str):
            x, mean, var, weight, bias, mul = inputs(shape, dtype)
            xc = x.contiguous()
            reps = 20 if x.numel() < 2 ** 24 else 5
            for key, src in (("cl", x), ("nchw", xc)):
                t[key] += count * event_ms(torch, lambda: bn_act.bn_act_cuda(
                    src, mean, mul, bias, act), reps)
                t[key + "_graph"] += count * graph_ms(
                    torch, lambda: bn_act.bn_act_cuda(src, mean, mul, bias,
                                                      act), 10, 5)
            t["plain"] += count * event_ms(torch, lambda: bn_act.bn_act_plain(
                x, mean, mul, bias, act), reps)
            t["lib"] += count * event_ms(torch, lambda: eager_chain(
                torch, F, x, mean, var, weight, bias, 1e-3, act), reps)
            # One read and one write of the activation and the three
            # per-channel vectors; subtract, multiply, add and at most
            # four more operations for the activation per element.
            nbytes += count * (2 * x.numel() * x.element_size()
                               + 3 * shape[1] * 4)
            flops += count * 7 * x.numel()
            n_calls += count
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        top = sorted(((n * int(np.prod(shape)), shape, str(dtype)[6:], act,
                       n) for (shape, dtype, act), n in calls.items()),
                     reverse=True)[:4]
        log(f"timing: K6 over the {n_calls} norms of {label} ({len(calls)} "
            f"shapes; the largest by elements x calls: "
            f"{[x[1:] for x in top]}): channels-last kernel {t['cl']:.4f} "
            f"ms eager, {t['cl_graph']:.4f} ms from CUDA graphs "
            f"({nbytes / t['cl_graph'] / 1e9:.3f} TB/s); NCHW kernel on the "
            f"contiguous copies {t['nchw']:.4f} ms eager, "
            f"{t['nchw_graph']:.4f} ms from graphs "
            f"({nbytes / t['nchw_graph'] / 1e9:.3f} TB/s); plain "
            f"{t['plain']:.4f} ms, the eager chain K6 replaced "
            f"{t['lib']:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e6:.2f} MB); {card}")
        if first is None:
            first = (t["cl"], t["plain"], b_ms, b_by, t["lib"])
    return max_err, first


def k7_boxes(torch, rng, b, n, hw, dev):
    """[b, n, 4] boxes on 1080p frames: at n == 1 the full frame (the
    detector input); else full-frame, edge-clamped, one pixel wide and
    high, degenerate, and random ones of person-like sizes."""
    h, w = hw
    if n == 1:
        return torch.tensor([0.0, 0.0, float(w), float(h)],
                            device=dev).expand(b, 1, 4).contiguous()
    fixed = [[0, 0, w, h], [w - 37, 5, w, 290], [3, h - 140, 70, h],
             [w - 60, h - 90, w, h], [5, 7, 6, 160], [9, 3, 280, 4],
             [0, 0, 0, 0], [40, 50, 40.5, 190], [w - 1, h - 1, w, h]]
    out = []
    for _ in range(b):
        rows = list(fixed)
        while len(rows) < n:
            bw, bh = rng.integers(8, w // 4), rng.integers(16, h // 2)
            x1, y1 = rng.integers(0, w - bw), rng.integers(0, h - bh)
            rows.append([x1, y1, x1 + bw, y1 + bh])
        out.append(rows[:n])
    return torch.tensor(out, dtype=torch.float32, device=dev)


def k7_library(torch, F, crop, frames, boxes, out_hw):
    """One PyTorch call that computes a bilinear crop-resize of the same
    frames and boxes (K7's yardstick; nothing in the port calls it):
    F.interpolate for the full-frame resize, F.grid_sample over the boxes'
    sample grids for the crops, on float32 NCHW frames."""
    b, n = boxes.shape[:2]
    x = frames.permute(0, 3, 1, 2).float().contiguous()
    if n == 1:
        return lambda: F.interpolate(x, size=out_hw, mode="bilinear",
                                     align_corners=False, antialias=False)
    h, w = frames.shape[1:3]
    y0, x0, _, _, wy, wx, _ = crop._sample_grid((h, w), boxes, out_hw)
    gy = (2.0 * (y0 + wy) + 1.0) / h - 1.0              # [b, n, oh]
    gx = (2.0 * (x0 + wx) + 1.0) / w - 1.0              # [b, n, ow]
    grid = torch.stack(torch.broadcast_tensors(
        gx[..., None, :], gy[..., :, None]), -1).flatten(0, 1)
    xs = x.repeat_interleave(n, dim=0)
    return lambda: F.grid_sample(xs, grid, mode="bilinear",
                                 padding_mode="border", align_corners=False)


def phase_k7(torch, F, crop, dev, card):
    """K7 against crop_resize_plain on the card in its three modes at the
    main paths' shapes (K7_CASES): bit for bit, with edge-clamped, one
    pixel and degenerate boxes; then its time (CUDA events and a CUDA
    graph) in each mode, the plain version's and one PyTorch call's
    (``k7_library``) in int8 mode, beside its bound. Returns (max abs
    error, (ms, plain ms, bound ms, bound by, library ms)) of the three
    crops of one loaded one-stream frame in int8 mode (the default's)."""
    rng = np.random.default_rng(77)
    gen = torch.Generator(device=dev).manual_seed(77)
    frames8 = torch.randint(0, 256, (STREAMS,) + FRAME_HW + (3,),
                            generator=gen, device=dev, dtype=torch.uint8)
    max_err = 0.0
    one = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0, flops=0)
    for label, b, n, out_hw in K7_CASES:
        frames = frames8[:b]
        boxes = k7_boxes(torch, rng, b, n, FRAME_HW, dev)
        times = {}
        for mode in crop.MODES:
            got = crop.crop_resize_cuda(frames, boxes, out_hw, mode)
            want = crop.crop_resize_plain(frames, boxes, out_hw, mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K7 != plain, {label} B={b} N={n} {mode}: "
                    f"{int((got != want).sum())} elements differ")
            max_err = max(max_err, float((got - want).abs().max()))
            del got, want
            run = lambda m=mode: crop.crop_resize_cuda(  # noqa: E731
                frames, boxes, out_hw, m)
            times[mode] = (event_ms(torch, run, 10),
                           graph_ms(torch, run, 10, 5))
        plain = event_ms(torch, lambda: crop.crop_resize_plain(
            frames, boxes, out_hw, "int8"), 3)
        # The yardstick at one frame only: grid_sample needs the frame once
        # per box (10 GB at 8 frames of 50 boxes).
        lib = event_ms(torch, k7_library(torch, F, crop, frames, boxes,
                                         out_hw), 10) if b == 1 else None
        torch.cuda.empty_cache()
        pixels = b * n * out_hw[0] * out_hw[1]
        # One read of the frames and the boxes, one write of the float32
        # output; about 60 operations an output pixel (its grid and three
        # channels).
        nbytes = frames.numel() + 16 * b * n + 12 * pixels
        flops = 60 * pixels
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        log(f"timing: K7 {label}, B={b} N={n} -> {out_hw[0]}x{out_hw[1]}: "
            + ", ".join(f"{m} {t[0]:.4f} ms eager, {t[1]:.4f} ms graph"
                        for m, t in times.items())
            + f"; plain (int8) {plain:.4f} ms; library "
            f"{'not measured' if lib is None else f'{lib:.4f} ms'}; bound "
            f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB: int8 graph "
            f"{nbytes / times['int8'][1] / 1e9:.3f} TB/s); {card}")
        if b == 1:
            one["ms"] += times["int8"][0]
            one["plain"] += plain
            one["lib"] += lib
            one["bytes"] += nbytes
            one["flops"] += flops
    log(f"K7: {len(K7_CASES)} shapes x {len(crop.MODES)} modes equal to the "
        f"plain version bit for bit (max abs error {max_err})")
    b_ms, b_by = bound(one["bytes"], one["flops"], F32_FLOPS)
    log(f"timing: K7 over the three crops of one loaded one-stream frame "
        f"(int8): kernel {one['ms']:.4f} ms, plain {one['plain']:.4f} ms, "
        f"library {one['lib']:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
        f"{card}")
    return max_err, (one["ms"], one["plain"], b_ms, b_by, one["lib"])


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
    from botsort_tpu_torch.ops import hierarchy
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
    cuda, k10 = assignment_cuda.cascade_solve_cuda, hierarchy.greedy_scan_cuda
    k4.launches = k5.launches = k10.launches = 0
    cuda.launches = cuda.batched_launches = 0
    rows = drive(torch, pipeline, steps,
                 lambda: np.array([k4.launches, k5.launches,
                                   cuda.batched_launches, k10.launches]),
                 force_at=3)
    k4_launches, k5_launches = k4.launches, k5.launches
    if cuda.launches:
        raise AssertionError("the lowered 8-stream path launched K1")
    table = []
    for r in rows:
        want = (expected_launches(r, ran=lambda b: b[0] is None or b[0] > 0),
                expected_launches(r, n_dw,
                                  ran=lambda b: b[1] is None or b[1] > 0),
                expected_launches(r), expected_launches(r))
        table.append(dict(runs=r["runs"], k4=int(r["launches"][0]),
                          k5=int(r["launches"][1]),
                          k2=int(r["launches"][2]),
                          k10=int(r["launches"][3]),
                          tracks=sum(len(t) for t in r["tracks"])))
        if tuple(r["launches"]) != want:
            raise AssertionError(
                f"lowered: a step launched K4, K5, K2, K10 "
                f"{tuple(r['launches'])} times, expected {want} (K4 once and "
                f"K5 {n_dw} times per step run with crops, K2 and K10 once "
                f"per step run): {r['runs']}")
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


def three_solves(assignment, d1, iou, d3, pool, tracked, unconf, high, low):
    """The cascade as three chained solve_masked calls."""
    res1 = assignment.solve_masked(d1, pool, high, LIMITS[0])
    assignment.solve_masked(iou, tracked & (res1.col_for_row < 0), low,
                            LIMITS[1])
    assignment.solve_masked(d3, unconf, high & (res1.row_for_col < 0),
                            LIMITS[2])


def phase_coherent(torch, assignment, assignment_cuda, main_cascades, dev,
                   card):
    """Pops per solve and K1 / K2 times in two regimes at N_TRACKS x
    N_DETS: the cascade inputs of the loaded one-stream path's last eager
    frames (random weights: near-rank-1 appearance costs) and seeded
    coherent instances (coherent_instance). Pops of the cascade's plain
    walk against three chained solve_masked calls (K3's plain version) on
    the same inputs, on CPU copies; K1 and K2 (the eight instances as one
    batch) equal the plain version; CUDA-event and graph-replay times."""
    cuda = assignment_cuda.cascade_solve_cuda
    rng = np.random.default_rng(5)
    pipeline = [[a[0].cpu() for a in call] for call in main_cascades
                if tuple(call[0].shape[-2:]) == (N_TRACKS, N_DETS)]
    if len(pipeline) < STREAMS:
        raise AssertionError(f"coherent: {len(pipeline)} recorded cascades")
    regimes = {
        "pipeline, random weights": pipeline[-STREAMS:],
        "coherent": [[torch.from_numpy(a) for a in coherent_instance(
            rng, N_TRACKS, N_DETS)] for _ in range(STREAMS)],
    }
    cascade_pops = lambda args: pops_per_solve(  # noqa: E731
        torch, assignment, assignment.cascade_solve_plain, args)
    for regime, insts in regimes.items():
        k1_args = []
        for inst in insts:
            costs, masks, big = assignment.prepare_cascade(
                *[a.to(dev) for a in inst], LIMITS)
            k1_args.append((costs[None], masks[None], big[None], LIMITS))
        k2_args = assignment.prepare_cascade(
            *[torch.stack(x).to(dev) for x in zip(*insts)], LIMITS) + (
            LIMITS,)
        for args in k1_args + [k2_args]:
            got = cuda(*args)
            want = assignment.cascade_solve_plain(
                *[a.cpu() if torch.is_tensor(a) else a for a in args])
            for g, w in zip(got, want):
                index_err(torch, g.cpu(), w, f"coherent: {regime}: kernel "
                          "!= plain")
        pops = [cascade_pops(a) for a in k1_args]
        chain = [pops_per_solve(torch, assignment,
                                lambda *a: three_solves(assignment, *a),
                                inst) for inst in insts]
        if regime == "coherent" and max(pops):
            raise AssertionError(f"coherent: the cascade popped {pops}")
        k1_ms = statistics.median(event_ms(torch, lambda a=a: cuda(*a), 50)
                                  for a in k1_args)
        k1_graph = statistics.median(graph_ms(torch, lambda a=a: cuda(*a))
                                     for a in k1_args)
        k2_ms = event_ms(torch, lambda: cuda(*k2_args), 50)
        k2_graph = graph_ms(torch, lambda: cuda(*k2_args))
        log(f"coherent: {regime}: pops per solve {pops} (median "
            f"{statistics.median(pops)}), three chained solves {chain} "
            f"(median {statistics.median(chain)}); K1 {k1_ms:.4f} ms "
            f"(events), {k1_graph:.4f} ms (graph replay), medians over "
            f"{len(k1_args)} inputs; K2 at B = {STREAMS} (the same "
            f"inputs) {k2_ms:.4f} ms (events), {k2_graph:.4f} ms (graph "
            f"replay), slowest stream {max(pops)} pops against "
            f"{max(chain)}; {card}")


TRAIN_BATCH, TRAIN_IDS, TRAIN_STEPS = 64, 16, 6
K6B_SOURCE = "botsort_tpu_torch/csrc/bn_act_backward.cu"
# K6b replaces no TPU kernel: the JAX trainer differentiates the Flax
# BatchNorm and activation of botsort_tpu/models/common.py:62 with jax.grad.
K6B_REPLACES = "autodiff of botsort_tpu/models/common.py:62"


def phase_train(torch, bn_act, assets, cast_compute, dev, card):
    """make_trainer on the full-width FastReIDSBS (bfloat16 convolutions,
    float32 masters) at 256x128, TRAIN_BATCH crops of TRAIN_IDS identities,
    TRAIN_STEPS steps on (cuda:0,): losses, ms a step, K6 and K6b launches a
    step, peak memory. Returns (K6b launches, the norm calls of one step:
    {(shape, dtype, act): count})."""
    from botsort_tpu_torch.models.common import BatchNorm
    from botsort_tpu_torch.models.fastreid import FastReIDSBS
    from botsort_tpu_torch.train import reid_trainer

    model = FastReIDSBS()
    assets.seeded_init_(model, np.random.default_rng(8))
    cast_compute(model, torch.bfloat16).to(dev)
    init_fn, train_step = reid_trainer.make_trainer(model, (dev,))
    state = init_fn()
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.normal(size=(
        TRAIN_BATCH, 256, 128, 3)).astype(np.float32)).to(dev)
    labels = torch.arange(TRAIN_BATCH, device=dev) // (
        TRAIN_BATCH // TRAIN_IDS)
    recorder = NormRecorder(None, BatchNorm, nets=(model,))
    try:
        state, _ = train_step(state, images, labels)   # warm-up, recorded
    finally:
        recorder.remove()
    torch.cuda.synchronize()
    k6, k6b = bn_act.bn_act_cuda, bn_act.bn_act_backward_cuda
    torch.cuda.reset_peak_memory_stats()
    k6.launches = k6b.launches = 0
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = train_step(state, images, labels)
        losses.append(float(loss))
        ms.append(1000.0 * (time.perf_counter() - t0))
    launches = (k6.launches, k6b.launches)
    peak = torch.cuda.max_memory_allocated()
    n_norms = sum(recorder.calls.values())
    if launches[0] != TRAIN_STEPS * n_norms or \
            launches[1] != TRAIN_STEPS * n_norms:
        raise AssertionError(f"train: K6 / K6b launches {launches} over "
                             f"{TRAIN_STEPS} steps of {n_norms} norms")
    if not all(np.isfinite(losses)) or state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"train: losses {losses}, step {state.step}")
    log(f"train: make_trainer on FastReIDSBS (SBS-S50, bfloat16 convs, "
        f"float32 masters, {len(state.params)} leaves) at 256x128, batch "
        f"{TRAIN_BATCH} ({TRAIN_IDS} identities x "
        f"{TRAIN_BATCH // TRAIN_IDS}), {TRAIN_STEPS} steps on (cuda:0,): "
        f"losses {losses}; K6 {launches[0] // TRAIN_STEPS} and K6b "
        f"{launches[1] // TRAIN_STEPS} launches a step")
    log(f"timing: train step median {statistics.median(ms):.3f} ms (all "
        f"{[round(m, 3) for m in ms]}; host clock, each step ends in the "
        f"loss's readback), peak allocated {peak} bytes; {card}")
    return launches[1], recorder.calls


def aten_backward(torch, grad, x, mean, var, weight, eps, act):
    """ATen's backward of the same norm and activation (K6b's yardstick;
    nothing in the port calls this): the activation's backward, then
    native_batch_norm_backward in eval mode."""
    y = None
    if act != "none":
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = ((x.float() - mean.view(shape)) * (torch.rsqrt(var + eps)
             * weight).view(shape)).to(x.dtype)
    if act == "silu":
        grad = torch.ops.aten.silu_backward(grad, y)
    elif act == "relu":
        grad = torch.ops.aten.threshold_backward(grad, y, 0)
    elif act == "relu6":
        grad = torch.ops.aten.hardtanh_backward(grad, y, 0.0, 6.0)
    return torch.ops.aten.native_batch_norm_backward(
        grad, x, weight, mean, var, mean, torch.rsqrt(var + eps), False, eps,
        [True, True, True])


def phase_k6b(torch, bn_act, calls, dev, card):
    """K6b against bn_act_backward_plain on the card on every norm shape of
    one training step, and on odd shapes in float32 and bfloat16 with the
    four activations: grad_x bit for bit (SiLU within two units in the last
    place), the sums within 1e-5 relative, two calls bit-equal; then its
    time over one step's norms against the plain version and ATen's
    backward, beside its bound. Returns (max abs error, (ms, plain ms,
    bound ms, bound by, library ms))."""
    gen = torch.Generator(device=dev).manual_seed(67)

    def draw(shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, device=dev, generator=gen)
        return lo + (hi - lo) * torch.rand(shape, device=dev, generator=gen)

    cases = [(shape, dtype, act, n) for (shape, dtype, act), n in
             sorted(calls.items(), key=str)]
    n_path = len(cases)
    cases += [(shape, dtype, act, 0) for shape in
              ((3, 7, 5, 3), (2, 1280, 15, 20), (5, 33), (1, 1, 1, 1))
              for dtype in (torch.float32, torch.bfloat16)
              for act in bn_act.ACTS]
    max_err, worst_ulp, worst_rel = 0.0, 0, 0.0
    totals = dict(ms=0.0, graph=0.0, plain=0.0, lib=0.0, bytes=0, flops=0,
                  calls=0)
    for shape, dtype, act, count in cases:
        c = shape[1]
        x = (2.0 * draw(shape)).to(dtype)
        grad = draw(shape).to(dtype)
        mean, bias = 0.5 * draw((c,)), 0.5 * draw((c,))
        var, weight = draw((c,), 0.3, 1.8), draw((c,), 0.3, 1.8)
        mul = torch.rsqrt(var + 1e-5) * weight
        got = bn_act.bn_act_backward_cuda(grad, x, mean, mul, bias, act)
        again = bn_act.bn_act_backward_cuda(grad, x, mean, mul, bias, act)
        want = bn_act.bn_act_backward_plain(grad, x, mean, mul, bias, act)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K6b: two calls differ on {shape} {act}")
        ulps = ulp_apart(torch, got[0], want[0])
        if ulps > (2 if act == "silu" else 0):
            raise AssertionError(f"K6b != plain on {shape} {dtype} {act}: "
                                 f"grad_x {ulps} units in the last place")
        for g, w in zip(got[1:], want[1:]):
            rel = float(((g - w).abs() / (w.abs() + 1e-30)).max())
            if not torch.all((g - w).abs() <= 1e-5 * w.abs() + 1e-7):
                raise AssertionError(f"K6b sums != plain on {shape} {dtype} "
                                     f"{act}: relative {rel}")
            worst_rel = max(worst_rel, rel)
        worst_ulp = max(worst_ulp, ulps)
        max_err = max(max_err, float((got[0].float() - want[0].float())
                                     .abs().max()))
        if count:
            reps = 20 if x.numel() < 2 ** 24 else 5
            run = lambda: bn_act.bn_act_backward_cuda(  # noqa: E731
                grad, x, mean, mul, bias, act)
            totals["ms"] += count * event_ms(torch, run, reps)
            totals["graph"] += count * graph_ms(torch, run, 10, 5)
            totals["plain"] += count * event_ms(
                torch, lambda: bn_act.bn_act_backward_plain(
                    grad, x, mean, mul, bias, act), reps)
            totals["lib"] += count * event_ms(
                torch, lambda: aten_backward(torch, grad, x, mean, var,
                                             weight, 1e-5, act), reps)
            slices = bn_act.bn_act_backward_plan(
                shape[0], c, x.numel() // (shape[0] * c),
                x.element_size())[1]
            # grad_out and x read, grad_x written; the [C] vectors read and
            # the two sums written; the float64 partials written and read.
            totals["bytes"] += count * (3 * x.numel() * x.element_size()
                                        + 5 * c * 4 + 2 * 2 * 8 * c * slices)
            totals["flops"] += count * 12 * x.numel()
            totals["calls"] += count
    b_ms, b_by = bound(totals["bytes"], totals["flops"], F32_FLOPS)
    log(f"K6b: {len(cases)} cases equal to the plain version ({n_path} norm "
        f"shapes of a training step, odd shapes x 2 dtypes x 4 "
        f"activations): grad_x bit for bit but SiLU within {worst_ulp} "
        f"units in the last place, sums within {worst_rel:.3g} relative, two "
        f"calls bit-equal")
    log(f"timing: K6b over the {totals['calls']} norms of one training step "
        f"({n_path} shapes): kernel {totals['ms']:.4f} ms eager, "
        f"{totals['graph']:.4f} ms from CUDA graphs "
        f"({totals['bytes'] / totals['graph'] / 1e9:.3f} TB/s), plain "
        f"{totals['plain']:.4f} ms, ATen's activation backward + "
        f"native_batch_norm_backward {totals['lib']:.4f} ms; bound "
        f"{b_ms:.4f} ms by {b_by} ({totals['bytes'] / 1e6:.2f} MB); {card}")
    return max_err, (totals["ms"], totals["plain"], b_ms, b_by,
                     totals["lib"])


def phase_int8(torch, bundle, assignment_cuda, bn_act, card):
    """The loaded one-stream point with quantize_bundle(which=("body",))
    beside the bfloat16 point, both replayed from CUDA graphs in this call:
    frame medians, the body encoder at 50 crops int8 against bfloat16, and
    the cosine of int8 to bfloat16 embeddings of one frame's crops (JAX's
    bar: > 0.97). K1 and K6 must launch on the int8 path."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.models import quantize
    from botsort_tpu_torch.models.fastreid import preprocess
    from botsort_tpu_torch.ops.crop import _crop
    from botsort_tpu_torch.pipeline import host

    nms_cfg, pipe_cfg = NMSConfig(), PipelineConfig()
    cfgs = (loaded_cfg(TrackerConfig), nms_cfg, pipe_cfg)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, FRAME_HW + (3,), dtype=np.uint8)
              for _ in range(8)]
    t0 = time.perf_counter()
    qbundle = quantize.quantize_bundle(bundle, np.stack(frames[:4]),
                                       which=("body",), pipe_cfg=pipe_cfg)
    torch.cuda.synchronize()
    n_q = sum(isinstance(m, quantize.Int8Conv2d)
              for m in qbundle.body_encoder.modules())
    log(f"int8: quantize_bundle (body, scope mid) in "
        f"{time.perf_counter() - t0:.2f} s: {n_q} int8 convolutions")
    cuda, k6 = assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda
    check = lambda res: check_finite(res, nms_cfg)  # noqa: E731
    rows, pipes = {}, {}
    for name, b in (("bf16", bundle), ("int8", qbundle)):
        pipes[name] = host.BoTSORTPipeline(b, *cfgs)
        cuda.launches = k6.launches = 0
        rows[name] = drive(torch, pipes[name], frames, lambda: cuda.launches,
                           check=check)
        if name == "int8" and (cuda.launches < len(frames)
                               or k6.launches < 1):
            raise AssertionError(f"int8: K1 {cuda.launches}, K6 "
                                 f"{k6.launches} launches")
        log(f"int8: {name} path K1 launches {cuda.launches}, K6 "
            f"{k6.launches} over {len(frames)} frames")
    med = {k: statistics.median(steady_ms(r)) for k, r in rows.items()}
    # One frame's body crops, both encoders.
    res = rows["int8"][-1]["result"]
    valid = np.flatnonzero(res.det_valid[0])[:N_FACES]
    tlbr = torch.from_numpy(res.det_boxes[0][valid]).to(bundle.device)[None]
    frame = torch.from_numpy(frames[-1]).to(bundle.device)[None]
    with torch.no_grad():
        crops = preprocess(_crop(
            frame, tlbr, pipe_cfg.body_reid_input_hw, pipe_cfg).flatten(0, 1))
        f_bf16 = bundle.body_encoder(crops).float()
        f_int8 = qbundle.body_encoder(crops).float()
        cos = (f_bf16 * f_int8).sum(-1)
        enc = {name: (event_ms(torch, lambda m=m: m(crops), 10),
                      graph_ms(torch, lambda m=m: m(crops), 3, 5))
               for name, m in (("bf16", bundle.body_encoder),
                               ("int8", qbundle.body_encoder))}
    if crops.shape[0] < 1 or float(cos.min()) <= 0.97:
        raise AssertionError(f"int8: cosine to bf16 {cos.tolist()}")
    log(f"int8: {crops.shape[0]} crops of the last frame: cosine of int8 to "
        f"bfloat16 embeddings min {float(cos.min()):.6f}, median "
        f"{float(cos.median()):.6f} (JAX's bar > 0.97)")
    log(f"timing: int8 loaded one-stream frame median {med['int8']:.3f} ms "
        f"against bfloat16 {med['bf16']:.3f} ms (graphed, this call); body "
        f"encoder at {crops.shape[0]} crops: int8 {enc['int8'][0]:.4f} ms "
        f"eager, {enc['int8'][1]:.4f} ms from a graph; bfloat16 "
        f"{enc['bf16'][0]:.4f} / {enc['bf16'][1]:.4f} ms; {card}")


def phase_mesh(torch, bundle, assignment_cuda, bn_act, card):
    """MeshBatchedBoTSORTPipeline over (cuda:0, cuda:0) at 2 x STREAMS
    streams, moderate-16, beside BatchedBoTSORTPipeline over the first
    STREAMS: every FrameResult field of slice 0 and its track lists
    bit-equal at every step; K2 and K6 launch on the mesh path."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import host

    cfgs = dict(tracker_cfg=loaded_cfg(TrackerConfig, max_dets=16),
                nms_cfg=NMSConfig(), pipe_cfg=PipelineConfig())
    n = 2 * STREAMS
    mesh = host.MeshBatchedBoTSORTPipeline(bundle, n, mesh=(bundle.device,)
                                           * 2, **cfgs)
    single = host.BatchedBoTSORTPipeline(bundle, STREAMS, **cfgs)
    rng = np.random.default_rng(12)
    steps = [rng.integers(0, 255, (n,) + FRAME_HW + (3,), dtype=np.uint8)
             for _ in range(6)]
    cuda, k6 = assignment_cuda.cascade_solve_cuda, bn_act.bn_act_cuda
    cuda.batched_launches = k6.launches = 0
    ms = []
    for i, frames in enumerate(steps):
        t0 = time.perf_counter()
        got = mesh.update(frames)
        torch.cuda.synchronize()
        ms.append(1000.0 * (time.perf_counter() - t0))
        launches = (cuda.batched_launches, k6.launches)
        want = single.update(frames[:STREAMS])
        cuda.batched_launches, k6.launches = launches
        a, b = mesh.last_result, single.last_result
        for name, x, y in [(f, x[:STREAMS], y) for f, x, y in zip(
                a._fields[:-1], a[:-1], b[:-1])] + [
                (f"tracks.{f}", x[:STREAMS], y) for f, x, y in zip(
                    a.tracks._fields, a.tracks, b.tracks)]:
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"mesh: step {i + 1} slice 0 {name} "
                                     "differs from the batched step")
        if [[t.track_id for t in s] for s in got[:STREAMS]] != \
                [[t.track_id for t in s] for s in want]:
            raise AssertionError(f"mesh: step {i + 1} track lists differ")
    k2_runs, k6_runs = launches
    if k2_runs < 2 * len(steps) or k6_runs < 1:
        raise AssertionError(f"mesh: K2 {k2_runs}, K6 {k6_runs} launches")
    steady = ms[2:]
    log(f"mesh: {n} streams over (cuda:0, cuda:0), {len(steps)} steps: "
        f"slice 0 equals BatchedBoTSORTPipeline over the first {STREAMS} "
        f"on every FrameResult field and track list; K2 launches {k2_runs}, "
        f"K6 {k6_runs}; live tracks per stream "
        f"{[len(t) for t in got]}")
    log(f"timing: mesh {n}-stream step median {statistics.median(steady):.3f}"
        f" ms ({n * len(steady) / (sum(steady) / 1000.0):.2f} frames/s "
        f"aggregate; all {[round(m, 3) for m in ms]}); {card}")


def phase_envelope(torch, bundle, card):
    """The aggregates runtime/envelope.py quotes: an 8-stream
    BatchedBoTSORTPipeline replayed from CUDA graphs on the moderate-16
    scene at body ReID 256x128 and 384x128; frames/s over the steady
    steps."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)
    from botsort_tpu_torch.pipeline import host

    rng = np.random.default_rng(13)
    steps = [rng.integers(0, 255, (STREAMS,) + FRAME_HW + (3,),
                          dtype=np.uint8) for _ in range(12)]
    out = {}
    for hw in ((256, 128), (384, 128)):
        pipe = host.BatchedBoTSORTPipeline(
            bundle, STREAMS, loaded_cfg(TrackerConfig, max_dets=16),
            NMSConfig(), PipelineConfig(body_reid_input_hw=hw))
        rows = drive(torch, pipe, steps, lambda: 0)
        ms = steady_ms(rows)
        out[hw] = STREAMS * len(ms) / (sum(ms) / 1000.0)
        log(f"timing: envelope {STREAMS} streams moderate-16 body ReID "
            f"{hw[0]}x{hw[1]}: {out[hw]:.2f} frames/s aggregate over "
            f"{len(ms)} steady steps (median {statistics.median(ms):.3f} "
            f"ms); {card}")
        del pipe
    if not out[(384, 128)] < out[(256, 128)]:
        log("envelope: 384x128 did not measure below 256x128 in this call")
    log(f"envelope: MEASURED_AGGREGATE_FPS = "
        f"{ {k: round(v, 2) for k, v in out.items()} }")



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
    from botsort_tpu_torch.ops import (assignment, assignment_cuda, crop,
                                       hierarchy, nms)
    from botsort_tpu_torch.ops.boxes import iou_matrix
    from botsort_tpu_torch.pipeline import switch
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
        # Collect cyclic garbage between phases, where no graph is being
        # captured (see ``drive``).
        gc.collect()
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
    (k1_launches, k7_launches, k8_launches, k10_launches, main_pipe,
     main_frame, main_cfgs, main_cascades) = phase_main(
         torch, bundle, assignment, assignment_cuda, card)
    done("main")
    (k2_launches, k6_launches, k7_multi, k8_multi, k10_multi, unlowered,
     multi_pipe, multi_frames, multi_cfgs) = phase_multi(
         torch, bundle, assignment, assignment_cuda, bn_act, card)
    done("multi")
    phase_nosync(torch, bundle, main_pipe, main_frame, main_cfgs, multi_pipe,
                 multi_frames)
    done("nosync")
    phase_async(torch, multi_pipe, multi_frames)
    done("async")
    k6_err, k6_times = phase_k6(
        torch, F, bn_act, bundle,
        [(f"one {STREAMS}-stream moderate-16 step", multi_frames,
          multi_cfgs, None),
         ("the one-frame detector", main_frame[None], main_cfgs,
          (bundle.detector,))], card)
    done("K6")
    k8_err, k8_times, floor = phase_k8(torch, nms, iou_matrix, bundle,
                                       main_frame, multi_frames, main_cfgs,
                                       card)
    done("K8")
    del main_pipe, multi_pipe  # their graphs and the graphs' memory pools
    torch.cuda.empty_cache()
    k7_err, k7_times = phase_k7(torch, F, crop, dev, card)
    done("K7")
    k9_err, k9_plain = phase_k9(torch, switch, dev)
    done("K9")
    k9_launches, k9_times = phase_switch(torch, bundle, card, k9_plain)
    log(f"timing: empty-node floor {floor:.4f} ms a graph node; K8 "
        f"{k8_times[0]:.4f} ms eager at the loaded one-stream candidates "
        f"(graph times in the K8 lines); K9 {k9_times[0]:.4f} ms a launch "
        f"inside a graphed step, {k9_times[0] / floor:.2f} x the floor; "
        f"{card}")
    done("switch")
    k2_temporal, k7_temporal, k10_temporal, temporal_frames = phase_temporal(
        torch, bundle, assignment_cuda, card, unlowered)
    done("temporal")
    k10_err, k10_times = phase_k10(torch, bundle, main_frame, multi_frames,
                                   temporal_frames, main_cfgs, multi_cfgs,
                                   card, floor)
    del temporal_frames
    torch.cuda.empty_cache()
    done("K10")
    phase_checkpoint(torch, assets, bundle)
    done("checkpoint")
    phase_onnx(torch, assets, bundle, assignment_cuda, bn_act, card)
    torch.cuda.empty_cache()
    done("onnx")
    face_inputs, k5_err = phase_k5(torch, facereid_dw, dev)
    done("K5")
    k4_model, k4_err = phase_k4(torch, F, assets, fastreid, fastreid_fused,
                                cast_compute, dev)
    done("K4")
    k4_launches, k5_launches = phase_lowered(
        torch, bundle, assignment_cuda, fastreid_fused, facereid_dw, card,
        unlowered, assets.FULL)
    done("lowered")
    phase_coherent(torch, assignment, assignment_cuda, main_cascades, dev,
                   card)
    done("coherent")
    times = phase_timing(torch, assignment, assignment_cuda, k1_inputs,
                         k2_batches, k3_inputs, card)
    times.update(phase_encoder_timing(torch, F, fastreid_fused, facereid_dw,
                                      k4_model, face_inputs, card))
    times["K6"] = k6_times
    times["K7"] = k7_times
    times["K8"] = k8_times
    times["K9"] = k9_times
    times["K10"] = k10_times
    done("timings")
    phase_export(torch, bundle, assignment_cuda, bn_act, card)
    done("export")
    phase_serve(torch, bundle, card)
    done("serve")
    phase_store(torch, bundle)
    done("store")
    phase_oproute(torch, bundle, assignment_cuda, bn_act,
                  (assignment, bn_act, crop, nms, hierarchy, facereid_dw,
                   fastreid_fused), card)
    done("oproute")
    torch.cuda.empty_cache()
    k6b_launches, train_norms = phase_train(torch, bn_act, assets,
                                            cast_compute, dev, card)
    done("train")
    k6b_err, times["K6b"] = phase_k6b(torch, bn_act, train_norms, dev, card)
    done("K6b")
    torch.cuda.empty_cache()
    phase_int8(torch, bundle, assignment_cuda, bn_act, card)
    done("int8")
    torch.cuda.empty_cache()
    phase_mesh(torch, bundle, assignment_cuda, bn_act, card)
    done("mesh")
    torch.cuda.empty_cache()
    phase_envelope(torch, bundle, card)
    done("envelope")
    log(f"temporal: K2 launches on the temporal path {k2_temporal}")
    log(f"K7: launches on the main path {k7_launches}, the {STREAMS}-stream "
        f"path {k7_multi}, the temporal path {k7_temporal}")
    log(f"K8: launches on the main path {k8_launches}, the {STREAMS}-stream "
        f"path {k8_multi}; K9: launches on the switch path {k9_launches}")
    log(f"K10: launches on the main path {k10_launches}, the "
        f"{STREAMS}-stream path {k10_multi}, the temporal path "
        f"{k10_temporal}")
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
        entry("bn_act_backward", K6B_SOURCE, K6B_REPLACES, k6b_launches,
              k6b_err, "K6b"),
        entry("crop_resize", K7_SOURCE, K7_REPLACES, k7_launches, k7_err,
              "K7"),
        entry("nms_fixpoint", K8_SOURCE, K8_REPLACES, k8_launches, k8_err,
              "K8"),
        entry("graph_cond", K9_SOURCE, K9_REPLACES, k9_launches, k9_err,
              "K9"),
        entry("hierarchy_scan", K10_SOURCE, K10_REPLACES, k10_launches,
              k10_err, "K10"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
