"""Host-side tracker facades (port of botsort_tpu/pipeline/host.py).

``BoTSORTPipeline.update(frame) -> List[STrackView]`` uploads one frame,
runs the frame step at a static ReID bucket picked from the previous
frame's live counts, re-runs the rare frame whose counts overflow that
bucket (or whose NMS fixpoint did not converge in its fixed iteration
count), reads the FrameResult back and assembles the host track list
with its box hierarchy. ``BatchedBoTSORTPipeline`` does the same for B
streams per step through ``frame_step_batched``, with one bucket sized by
the largest count across the streams, and
``TemporalBatchedBoTSORTPipeline`` for B streams x T consecutive frames
per step through ``frame_step_batched_temporal``.

Between a step's upload and its readback the host only enqueues work. The
upload goes through a pinned staging buffer without waiting; on a CUDA
device the step is a CUDA graph replayed from pipeline/graphed.py
(``graphs=False`` runs it eagerly, as every device other than CUDA does);
the FrameResult's fields are packed into one buffer on the device and
come back in one copy, the step's only synchronisation.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import types
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.pipeline.boxes import Body, Face, Hand, Head, make_box
from botsort_tpu_torch.pipeline.frame_step import (
    FrameResult,
    ModelBundle,
    _det_width,
    frame_step,
    frame_step_batched,
    frame_step_batched_temporal,
    reid_bucket_set,
    stream_result,
)
from botsort_tpu_torch.pipeline.graphed import GraphCache, step_key
from botsort_tpu_torch.track.cascade import TrackOutputs
from botsort_tpu_torch.track.state import (
    TrackStore,
    empty_store,
    empty_stores,
)
from botsort_tpu_torch.utils.consts import const
from botsort_tpu_torch.utils.profiling import StageTimers


def face_bucket_need(n_face: int, n_live: int) -> int:
    """Face bucket a frame needs: its attached faces plus one zero-crop
    slot (the encoder(0) source) whenever a faceless live body exists."""
    if n_live == 0:
        return 0
    return n_face + (1 if n_face < n_live else 0)


def _live_and_face_counts(res_host: FrameResult, d: int):
    """(live bodies, bodies with an attached face) among the first d body
    det slots of a host FrameResult."""
    valid = np.asarray(res_host.det_valid[0][:d])
    hb = np.asarray(res_host.head_for_body[:d])
    ffh = np.asarray(res_host.face_for_head)
    has_face = (hb >= 0) & (ffh[np.clip(hb, 0, None)] >= 0) & valid
    return int(valid.sum()), int(has_face.sum())


# The dtypes a FrameResult's fields have.
_NUMPY_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
                 torch.int64: np.int64, torch.bool: np.bool_}


def _result_tensors(result: FrameResult) -> List[torch.Tensor]:
    return [*result[:-1], *result.tracks]


def _result_from(fields) -> FrameResult:
    n = len(FrameResult._fields) - 1
    return FrameResult(*fields[:n], TrackOutputs(*fields[n:]))


class PackedResult(NamedTuple):
    """A FrameResult on the device as one buffer: ``packed`` [bytes] uint8
    holds the fields back to back (each starting on an 8-byte boundary),
    ``layout`` their (shape, dtype) in field order."""

    packed: torch.Tensor
    layout: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]

    def to_host(self) -> FrameResult:
        """The FrameResult as numpy arrays: one device-to-host copy, which
        is also the wait for the step that made it."""
        raw = self.packed.cpu().numpy()
        fields, off = [], 0
        for shape, dtype in self.layout:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            fields.append(raw[off:off + nbytes].view(_NUMPY_DTYPES[dtype])
                          .reshape(shape))
            off += -(-nbytes // 8) * 8
        return _result_from(fields)


def pack_result(result: FrameResult) -> PackedResult:
    """Pack a device FrameResult's fields into one uint8 buffer on the
    device (no synchronisation)."""
    tensors = _result_tensors(result)
    pad = const((0,) * 8, torch.uint8, tensors[0].device)
    pieces = []
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pieces.append(raw)
        if raw.numel() % 8:
            pieces.append(pad[:8 - raw.numel() % 8])
    layout = tuple((tuple(t.shape), t.dtype) for t in tensors)
    return PackedResult(torch.cat(pieces), layout)


def to_host(result: FrameResult) -> FrameResult:
    """The same FrameResult with numpy arrays in place of tensors, read
    back in one copy."""
    return pack_result(result).to_host()


def _check_dispatch(pipe_cfg: PipelineConfig):
    """The configurations the JAX package's facades refuse."""
    if pipe_cfg.disable_reid and not pipe_cfg.host_bucket_dispatch:
        raise ValueError(
            "disable_reid (IoU-only mode) requires "
            "host_bucket_dispatch=True — the in-program dynamic "
            "bucketing path would still run the encoders")


def _pick_bucket(buckets: List[int], n: int) -> int:
    """The smallest bucket that holds n crops (the largest if none)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _store_tensors(store: TrackStore) -> List[Optional[torch.Tensor]]:
    return [getattr(store, f.name) for f in dataclasses.fields(store)]


def _store_from(tensors) -> TrackStore:
    return TrackStore(*tensors)


@dataclasses.dataclass
class STrackView:
    """Host view of one live track."""

    track_id: int
    score: float
    tlbr: np.ndarray          # [4] float32
    body: Optional[Body]      # attached hierarchy for this frame

    @property
    def tlwh(self) -> np.ndarray:
        out = self.tlbr.copy()
        out[2:] -= out[:2]
        return out


class _Facade:
    """What the three facades share: the configuration, the upload, one
    step at a static bucket pair (eager or replayed from a CUDA graph),
    and the loop that re-runs a step whose buckets overflowed or whose NMS
    did not converge."""

    # The step kind, part of a captured step's key.
    kind = "step"

    def __init__(self, bundle: ModelBundle, tracker_cfg: TrackerConfig,
                 nms_cfg: NMSConfig, pipe_cfg: PipelineConfig, graphs: bool,
                 profile: bool, graph_cache: Optional[GraphCache] = None):
        _check_dispatch(pipe_cfg)
        self.bundle = bundle
        self.tracker_cfg = tracker_cfg
        self.nms_cfg = nms_cfg
        self.pipe_cfg = pipe_cfg
        self.device = bundle.device
        self.frame_id = 0
        # Stage times are host-clock times; with ``profile`` every stage
        # ends in a device synchronisation, so that it covers the device
        # work it enqueued. Without it no stage waits for the card.
        self.timers = StageTimers(
            cuda_sync=profile and self.device.type == "cuda")
        self._buckets = reid_bucket_set(tracker_cfg, nms_cfg, pipe_cfg)
        self._det_width = _det_width(tracker_cfg, nms_cfg)
        # Captured steps (CUDA devices only; None runs every step eagerly).
        # ``graph_cache`` shares one with other facades of the same bundle
        # and configuration (a server's connections).
        self._graphs: Optional[GraphCache] = graph_cache
        if graph_cache is None and graphs and self.device.type == "cuda":
            self._graphs = GraphCache(self.device)
        self._staging = {}
        # The host FrameResult of the latest step (numpy arrays).
        self.last_result: Optional[FrameResult] = None

    def _pick_bucket(self, n: int) -> int:
        return _pick_bucket(self._buckets, n)

    def _upload(self, name: str, array: np.ndarray) -> torch.Tensor:
        """``array`` on the device. On a CUDA device it goes through a
        pinned staging buffer kept per ``name`` and the copy is not waited
        for; the buffer is rewritten by the next upload of that name, after
        the step that read it has been read back."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(array)).to(
                self.device)
        stage = self._staging.get(name)
        if stage is None or stage[0].shape != array.shape or \
                stage[0].dtype != array.dtype:
            pinned = torch.empty(array.shape, dtype=torch.from_numpy(
                np.empty(0, array.dtype)).dtype, pin_memory=True)
            stage = (pinned.numpy(), pinned)
            self._staging[name] = stage
        np.copyto(stage[0], array)
        return stage[1].to(self.device, non_blocking=True)

    def _first_buckets(self, last_live: Optional[int], last_face: int):
        """(reid bucket, face bucket, whether they can overflow) for the
        next step, from the previous step's counts."""
        cfg = self.pipe_cfg
        if not cfg.host_bucket_dispatch:
            return None, None, False  # every det slot embedded: exact
        if cfg.disable_reid:
            return 0, 0, False  # IoU-only: zero features
        if last_live is None:
            return self._buckets[-1], self._buckets[-1], True
        return (self._pick_bucket(last_live),
                self._pick_bucket(face_bucket_need(last_face, last_live)),
                True)

    def _dispatch(self, stores, frames_dev, gmc, reid_bucket, face_bucket,
                  nms_iters) -> Tuple[TrackStore, FrameResult]:
        """One device step at a static bucket pair, eagerly: the override
        point for other ways of running a step. Must not write ``stores``
        and must not wait for the device."""
        raise NotImplementedError

    def _step(self, stores, frames_dev, reid_bucket, face_bucket, gmc=None,
              nms_iters=None) -> Tuple[TrackStore, PackedResult]:
        """One step, with its FrameResult packed on the device: through
        the graph cache where there is one, else eagerly."""
        layout = []

        def run(frames, gmc_t, *store_fields):
            new, result = self._dispatch(
                _store_from(store_fields), frames, gmc_t, reid_bucket,
                face_bucket, nms_iters)
            packed = pack_result(result)
            layout[:] = [packed.layout]
            return [packed.packed, *_store_tensors(new)]

        inputs = [frames_dev, gmc, *_store_tensors(stores)]
        if self._graphs is None:
            out = run(*inputs)
        else:
            key = step_key(self.kind, frames_dev.shape, reid_bucket,
                           face_bucket, gmc is not None, nms_iters)
            out = self._graphs.run(key, run, inputs)
            # A replay does not run the function: the key's first use
            # did, and left its layout.
            if layout:
                self._graphs.meta[key] = layout[0]
            else:
                layout.append(self._graphs.meta[key])
        return _store_from(out[1:]), PackedResult(out[0], layout[0])

    def save_session(self, path: str) -> None:
        """Write the tracking session: the stores (runtime/checkpoint.py),
        the frame count and the bucket hint, so that a facade resumed from
        it picks the buckets this one would pick next and goes on bit for
        bit (the encoders' batch size is part of the arithmetic). A GMC
        estimator's previous frame is not saved."""
        from botsort_tpu_torch.runtime.checkpoint import save_store

        stores, live, face = self._session()
        save_store(path, stores, frame_id=self.frame_id, last_live=live,
                   last_face=face)

    def load_session(self, path: str) -> bool:
        """Resume the session saved at ``path`` (``save_session``); False
        where there is none."""
        from botsort_tpu_torch.runtime.checkpoint import load_checkpoint

        saved = load_checkpoint(path, self.device)
        if saved is None:
            return False
        stores, host = saved
        self._resume(stores, host.get("last_live"), host.get("last_face", 0))
        self.frame_id = host.get("frame_id", 0)
        return True

    def _session(self):
        """(stores, bucket hint: the previous step's live and face
        counts)."""
        raise NotImplementedError

    def _resume(self, stores, last_live: Optional[int], last_face: int):
        raise NotImplementedError

    def _counts(self, res: FrameResult) -> Tuple[int, int]:
        """(largest live-body count, largest attached-face count) over the
        frames of a host FrameResult."""
        raise NotImplementedError

    def _settle(self, backup, frames_dev, gmc, step, buckets):
        """Read a step back and re-run it from ``backup``, the pre-step
        stores, until it is exact: with the full NMS iteration count if the
        fixed one did not converge, at larger buckets if the counts
        overflowed the picked ones. Returns (stores, host FrameResult,
        (live, face) counts or None)."""
        stores, packed = step
        bucket, fbucket, check = buckets
        nms_iters = None
        while True:
            res = packed.to_host()
            counts = None
            if not bool(np.all(res.nms_converged)) and nms_iters is None:
                nms_iters = self.nms_cfg.pre_nms_top_k
            else:
                if not check:
                    break
                counts = self._counts(res)
                need = face_bucket_need(counts[1], counts[0])
                if counts[0] <= bucket and need <= fbucket:
                    break
                bucket = self._pick_bucket(counts[0])
                fbucket = self._pick_bucket(need)
            stores, packed = self._step(backup, frames_dev, bucket, fbucket,
                                        gmc, nms_iters)
        return stores, res, counts


class BoTSORTPipeline(_Facade):
    """End-to-end tracker over one video stream on the bundle's device.

    graphs: replay the step from a CUDA graph (CUDA devices; False runs it
    eagerly). profile: synchronise at the end of every timed stage.
    graph_cache: a GraphCache shared with other facades of the same bundle
    and configuration.
    """

    kind = "frame"

    def __init__(self, bundle: ModelBundle,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig(),
                 graphs: bool = True, profile: bool = False,
                 graph_cache: Optional[GraphCache] = None):
        super().__init__(bundle, tracker_cfg, nms_cfg, pipe_cfg, graphs,
                         profile, graph_cache)
        self.store = empty_store(tracker_cfg, self.device)
        self.gmc = None
        if pipe_cfg.enable_gmc:
            from botsort_tpu_torch.io.gmc import GMCEstimator

            self.gmc = GMCEstimator()
        self._last_n_live: Optional[int] = None
        self._last_n_face = 0

    def reset(self):
        self.store = empty_store(self.tracker_cfg, self.device)
        self.frame_id = 0
        self._last_n_live = None
        self._last_n_face = 0
        self.last_result = None
        self.timers.reset()
        if self.gmc is not None:
            self.gmc.reset()

    def _dispatch(self, store, frame_dev, gmc_affine, reid_bucket,
                  face_bucket, nms_iters=None):
        return frame_step(
            self.bundle, store, frame_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, gmc_affine, reid_bucket=reid_bucket,
            face_bucket=face_bucket, nms_iters=nms_iters)

    def _counts(self, res: FrameResult):
        return _live_and_face_counts(res, self._det_width)

    def _session(self):
        return self.store, self._last_n_live, self._last_n_face

    def _resume(self, store, last_live, last_face):
        self.store, self._last_n_live, self._last_n_face = (
            store, last_live, last_face)

    def update(self, frame_bgr: np.ndarray) -> List[STrackView]:
        """One frame. frame_bgr: [H, W, 3] uint8 (OpenCV layout)."""
        self.frame_id += 1
        gmc_affine = None
        if self.gmc is not None:
            with self.timers.stage("gmc"):
                gmc_host = self.gmc.estimate(frame_bgr)
        with self.timers.stage("upload"):
            frame_dev = self._upload("frame", frame_bgr)
            if self.gmc is not None:
                gmc_affine = self._upload("gmc", gmc_host)
        with self.timers.stage("device_step"):
            buckets = self._first_buckets(self._last_n_live,
                                          self._last_n_face)
            # frame_step never writes its input store, so the pre-step
            # store is the re-run's backup as is.
            backup = self.store
            step = self._step(backup, frame_dev, buckets[0], buckets[1],
                              gmc_affine)
            self.store, res, counts = self._settle(
                backup, frame_dev, gmc_affine, step, buckets)
            if counts is not None:
                self._last_n_live, self._last_n_face = counts
        self.last_result = res
        with self.timers.stage("assemble"):
            return assemble_tracks(res, self.tracker_cfg, self.nms_cfg,
                                   self.pipe_cfg, warn_state=self)


class BatchedBoTSORTPipeline(_Facade):
    """B independent streams stepped together on the bundle's device.

    Every ``update`` takes one frame per stream (all of one resolution)
    and runs ``frame_step_batched``: perception batched over the streams,
    the B cascades one launch of kernel K2 on the card. The ReID bucket is
    shared, picked from the previous step's largest live count across the
    streams; a step that overflows it re-runs from the pre-step stores,
    which the step never writes. Camera motion comes in with the frames,
    as ``update``'s ``gmc_affines``: the per-frame estimator of
    ``PipelineConfig.enable_gmc`` belongs to ``BoTSORTPipeline``, and the
    batched facades refuse that option instead of ignoring it.

    graphs: replay the step from a CUDA graph (CUDA devices; False runs it
    eagerly). profile: synchronise at the end of every timed stage.
    graph_cache: a GraphCache shared with other facades of the same bundle
    and configuration.
    """

    kind = "batched"

    def __init__(self, bundle: ModelBundle, n_streams: int,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig(),
                 graphs: bool = True, profile: bool = False,
                 graph_cache: Optional[GraphCache] = None):
        super().__init__(bundle, tracker_cfg, nms_cfg, pipe_cfg, graphs,
                         profile, graph_cache)
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if pipe_cfg.enable_gmc:
            raise ValueError(
                "enable_gmc estimates the camera motion in BoTSORTPipeline "
                "only; give a batched pipeline its affines as "
                "update(frames, gmc_affines)")
        self.n_streams = n_streams
        self.stores = empty_stores(tracker_cfg, n_streams, self.device)
        self._last_max_live: Optional[int] = None
        self._last_max_face = 0
        # Per-stream once-only warning state.
        self._warn = [types.SimpleNamespace() for _ in range(n_streams)]

    def reset(self):
        self.stores = empty_stores(self.tracker_cfg, self.n_streams,
                                   self.device)
        self.frame_id = 0
        self._last_max_live = None
        self._last_max_face = 0
        self.last_result = None
        self.timers.reset()

    def _dispatch(self, stores, frames_dev, gmc_affines, reid_bucket,
                  face_bucket, nms_iters=None):
        return frame_step_batched(
            self.bundle, stores, frames_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, gmc_affines, reid_bucket=reid_bucket,
            face_bucket=face_bucket, nms_iters=nms_iters)

    def _frame_results(self, res: FrameResult):
        """(stream, host FrameResult of one frame) over a step's frames."""
        return [(s, stream_result(res, s)) for s in range(self.n_streams)]

    def _counts(self, res: FrameResult):
        counts = [_live_and_face_counts(r, self._det_width)
                  for _, r in self._frame_results(res)]
        return max(c[0] for c in counts), max(c[1] for c in counts)

    def _session(self):
        return self.stores, self._last_max_live, self._last_max_face

    def _resume(self, stores, last_live, last_face):
        self.stores, self._last_max_live, self._last_max_face = (
            stores, last_live, last_face)

    def _check_frames(self, frames: np.ndarray):
        if frames.shape[0] != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} frames, got {frames.shape[0]}")

    def update(self, frames_bgr, gmc_affines=None):
        """frames_bgr: [B, H, W, 3] uint8 (an array or a list of B frames,
        OpenCV layout); gmc_affines: optional [B, 2, 3] float32 camera
        motion per stream. Returns each stream's track list."""
        return self.update_async(frames_bgr, gmc_affines).result()

    def update_async(self, frames_bgr, gmc_affines=None) -> "PendingBatch":
        """Enqueue one step and return without waiting for the card or
        reading anything back: the card works on the step while the caller
        draws or encodes the previous one; ``result()`` reads back, re-runs
        a step that overflowed and assembles the track lists. Resolve each
        handle before the next ``update_async``: the overflow check may
        replace the stores, and the next upload reuses the staging
        buffer."""
        frames = frames_bgr if isinstance(frames_bgr, np.ndarray) \
            else np.stack(frames_bgr)
        self._check_frames(frames)
        self.frame_id += 1
        with self.timers.stage("upload"):
            frames_dev = self._upload("frames", frames)
            gmc = None if gmc_affines is None else self._upload(
                "gmc", np.asarray(gmc_affines, np.float32))
        buckets = self._first_buckets(self._last_max_live,
                                      self._last_max_face)
        backup = self.stores
        with self.timers.stage("device_step"):
            step = self._step(backup, frames_dev, buckets[0], buckets[1],
                              gmc)
        self.stores = step[0]
        return PendingBatch(self, frames_dev, gmc, step, backup, buckets)

    def _resolve(self, frames_dev, gmc, step, backup, buckets):
        with self.timers.stage("readback"):
            self.stores, res, counts = self._settle(backup, frames_dev, gmc,
                                                    step, buckets)
            if counts is not None:
                self._last_max_live, self._last_max_face = counts
        self.last_result = res
        with self.timers.stage("assemble"):
            return self._assemble(res)

    def _assemble(self, res: FrameResult) -> List[List[STrackView]]:
        return [assemble_tracks(r, self.tracker_cfg, self.nms_cfg,
                                self.pipe_cfg, warn_state=self._warn[s])
                for s, r in self._frame_results(res)]


class TemporalBatchedBoTSORTPipeline(BatchedBoTSORTPipeline):
    """B streams x T consecutive frames per step
    (``frame_step_batched_temporal``): perception over all B x T frames as
    one batch, T chained cascades. A stream waits T - 1 frames longer for
    its first result; the buckets are picked per group of T frames, from
    the previous group's largest counts.

    ``update`` / ``update_async`` take [B, T, H, W, 3] (or a list of B
    [T, H, W, 3] stacks) and optional affines [B, T, 2, 3], and resolve to
    ``out[t][s]``, stream s's tracks at group frame t: time-major, so a
    serving loop can emit frame t of every stream before it touches t + 1.
    """

    kind = "temporal"

    def __init__(self, bundle: ModelBundle, n_streams: int, t_batch: int = 2,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig(),
                 graphs: bool = True, profile: bool = False,
                 graph_cache: Optional[GraphCache] = None):
        super().__init__(bundle, n_streams, tracker_cfg, nms_cfg, pipe_cfg,
                         graphs, profile, graph_cache)
        if t_batch < 1:
            raise ValueError(f"t_batch must be >= 1, got {t_batch}")
        self.t_batch = t_batch

    def _dispatch(self, stores, frames_dev, gmc_affines, reid_bucket,
                  face_bucket, nms_iters=None):
        return frame_step_batched_temporal(
            self.bundle, stores, frames_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, gmc_affines, reid_bucket=reid_bucket,
            face_bucket=face_bucket, nms_iters=nms_iters)

    def _check_frames(self, frames: np.ndarray):
        if frames.shape[:2] != (self.n_streams, self.t_batch):
            raise ValueError(
                f"expected [B={self.n_streams}, T={self.t_batch}, H, W, 3] "
                f"frames, got {frames.shape}")

    def _frame_results(self, res: FrameResult):
        return [(s, stream_result(stream_result(res, s), t))
                for t in range(self.t_batch) for s in range(self.n_streams)]

    def _assemble(self, res: FrameResult) -> List[List[List[STrackView]]]:
        flat = super()._assemble(res)
        b = self.n_streams
        return [flat[t * b:(t + 1) * b] for t in range(self.t_batch)]


def bucket_pairs(buckets: List[int]) -> List[Tuple[int, int]]:
    """Every (reid bucket, face bucket) a facade can pick from ``buckets``:
    the face bucket never exceeds the body bucket."""
    return [(b, fb) for b in buckets for fb in buckets if fb <= b]


def warm_up(pipeline: BoTSORTPipeline, frame_hw: Tuple[int, int]
            ) -> List[Tuple[Tuple, float]]:
    """Run both NMS programs (the fixed count and the re-run's) of every
    bucket pair the facade can pick for frames of ``frame_hw`` once, from
    its current store, and wait for each: on a card with graphs that
    captures each step (a live frame, or its re-run, then replays it; an
    exported pipeline loads each program here); elsewhere it runs each
    step eagerly once. The facade's state is not changed. Returns
    ((reid bucket, face bucket, nms_iters), seconds) per step."""
    frame = pipeline._upload("warm_up",
                             np.zeros(tuple(frame_hw) + (3,), np.uint8))
    first = pipeline._first_buckets(None, 0)
    pairs = bucket_pairs(pipeline._buckets) if first[2] else [first[:2]]
    out = []
    for b, fb in pairs:
        for iters in (None, pipeline.nms_cfg.pre_nms_top_k):
            t0 = time.perf_counter()
            _, packed = pipeline._step(pipeline.store, frame, b, fb, None,
                                       iters)
            packed.to_host()
            out.append(((b, fb, iters), time.perf_counter() - t0))
    return out


class PendingBatch:
    """Handle for one batched step in flight."""

    def __init__(self, pipeline: BatchedBoTSORTPipeline, frames_dev, gmc,
                 step, backup, buckets):
        self._args = (frames_dev, gmc, step, backup, buckets)
        self._pipeline = pipeline
        self._out = None

    def result(self):
        """Read the step back (once) and return each stream's tracks (for
        a temporal step, ``out[t][s]``)."""
        if self._out is None:
            self._out = self._pipeline._resolve(*self._args)
            self._args = None
        return self._out


def assemble_tracks(res: FrameResult, tracker_cfg: TrackerConfig,
                    nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
                    warn_state: Any = None) -> List[STrackView]:
    """Track list + box hierarchy from one host FrameResult.

    warn_state: an object on which once-only warning flags are set.
    """
    tc = pipe_cfg.track_target_classes
    det_boxes, det_scores, det_valid = (res.det_boxes, res.det_scores,
                                        res.det_valid)
    n_bodies = int(np.asarray(det_valid[0]).sum())
    d = _det_width(tracker_cfg, nms_cfg)
    if warn_state is None:
        warn_state = assemble_tracks
    if n_bodies > d and not getattr(warn_state, "_warned_capacity", False):
        warn_state._warned_capacity = True
        print(f"WARNING: {n_bodies} bodies detected but "
              f"TrackerConfig.max_dets={tracker_cfg.max_dets}; only the "
              f"{d} highest-scoring reach the tracker (raise max_dets).",
              file=sys.stderr)
    dropped = int(np.asarray(res.tracks.dropped_new))
    if dropped > 0 and not getattr(warn_state, "_warned_slots", False):
        warn_state._warned_slots = True
        print(f"WARNING: {dropped} new track(s) dropped this frame — all "
              f"TrackerConfig.max_tracks={tracker_cfg.max_tracks} slots "
              "occupied (raise max_tracks).", file=sys.stderr)
    if bool(np.asarray(res.nms_clipped).any()) and \
            not getattr(warn_state, "_warned_nms_clip", False):
        warn_state._warned_nms_clip = True
        print("WARNING: NMS pre_nms_top_k saturated for at least one class "
              "this frame — suppression was approximate (raise "
              "NMSConfig.pre_nms_top_k).", file=sys.stderr)

    def opt_box(cls_ctor, classid, slot, trackid):
        if classid not in tc or slot < 0 or not det_valid[classid][slot]:
            return None
        return make_box(cls_ctor, classid, det_scores[classid][slot],
                        det_boxes[classid][slot], trackid=trackid)

    tracks: List[STrackView] = []
    t = res.tracks
    for k in range(len(t.valid)):
        if not t.valid[k]:
            continue
        tid = int(t.track_id[k])
        di = int(t.det_index[k])
        body = None
        if di >= 0 and 0 in tc:
            body = make_box(Body, 0, det_scores[0][di], det_boxes[0][di],
                            trackid=tid)
            hs = int(res.head_for_body[di])
            head = opt_box(Head, 1, hs, tid)
            if head is not None:
                head.face = opt_box(Face, 3, int(res.face_for_head[hs]), tid)
            body.head = head
            body.hand1 = opt_box(Hand, 2, int(res.hand1_for_body[di]), tid)
            body.hand2 = opt_box(Hand, 2, int(res.hand2_for_body[di]), tid)
        tracks.append(STrackView(track_id=tid, score=float(t.score[k]),
                                 tlbr=np.asarray(t.tlbr[k], np.float32),
                                 body=body))
    return tracks
