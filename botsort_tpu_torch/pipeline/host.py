"""Host-side tracker facades (port of botsort_tpu/pipeline/host.py).

``BoTSORTPipeline.update(frame) -> List[STrackView]`` uploads one frame,
runs the frame step at a static ReID bucket picked from the previous
frame's live counts, re-runs the rare frame whose counts overflow that
bucket, reads the FrameResult back and assembles the host track list with
its box hierarchy. With ``PipelineConfig.host_bucket_dispatch=False`` the
step picks its buckets on the device instead (one program for every load,
no re-run). ``BatchedBoTSORTPipeline`` does the same for B
streams per step through ``frame_step_batched``, with one bucket sized by
the largest count across the streams (``MeshBatchedBoTSORTPipeline``: the
streams split over several devices), and
``TemporalBatchedBoTSORTPipeline`` for B streams x T consecutive frames
per step through ``frame_step_batched_temporal``.

Between a step's upload and its readback the host only enqueues work. The
upload goes through a pinned staging buffer without waiting: a large one
is copied there in bands by a shared pool of worker threads, and each
band's H2D is enqueued as soon as it has landed (pipeline/upload.py); a
list of frames is copied into the buffer frame by frame, never stacked
first. On a CUDA device the step is a CUDA graph replayed from
pipeline/graphed.py
(``graphs=False`` runs it eagerly, as every device other than CUDA does);
the FrameResult's fields are packed into one buffer on the device and
come back in one copy, the step's only synchronisation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import types
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.pipeline import upload
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
    switch_values,
)
from botsort_tpu_torch.pipeline.graphed import GraphCache, step_key
from botsort_tpu_torch.track.cascade import TrackOutputs
from botsort_tpu_torch.track.state import (
    TrackStore,
    empty_store,
    empty_stores,
)
from botsort_tpu_torch.utils.consts import const
from botsort_tpu_torch.utils.profiling import (
    Marks,
    StageTimers,
    recording,
    stage_mark,
)


_NULL = contextlib.nullcontext()


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
    ``layout`` their (shape, dtype) in field order; ``on_host``, where
    given, is called with the host FrameResult (the graph cache counts a
    switch's branch launches from it). A traced facade's step also gives
    its stage ``marks`` and ``done``, an event recorded after the step's
    last work (None on a device other than CUDA)."""

    packed: torch.Tensor
    layout: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    on_host: Optional[Any] = None
    marks: Optional[Marks] = None
    done: Optional[Any] = None

    def runs(self) -> Tuple["PackedResult", ...]:
        return (self,)

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
        res = _result_from(fields)
        if self.on_host is not None:
            self.on_host(res)
        return res


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
    step at a static bucket pair or the in-program switch (eager or
    replayed from a CUDA graph), and the loop that re-runs a step whose
    buckets overflowed."""

    # The step kind, part of a captured step's key.
    kind = "step"

    def __init__(self, bundle: ModelBundle, tracker_cfg: TrackerConfig,
                 nms_cfg: NMSConfig, pipe_cfg: PipelineConfig, graphs: bool,
                 trace: bool, graph_cache: Optional[GraphCache] = None):
        _check_dispatch(pipe_cfg)
        self.bundle = bundle
        self.tracker_cfg = tracker_cfg
        self.nms_cfg = nms_cfg
        self.pipe_cfg = pipe_cfg
        self.device = bundle.device
        self.frame_id = 0
        # Stage times are host-clock times: no stage waits for the card.
        # ``trace`` also keeps the update's spans and the step's stage
        # device times (utils/profiling.py).
        self.timers = StageTimers(trace=trace)
        self._buckets = reid_bucket_set(tracker_cfg, nms_cfg, pipe_cfg)
        self._det_width = _det_width(tracker_cfg, nms_cfg)
        # Captured steps (CUDA devices only; None runs every step eagerly).
        # ``graph_cache`` shares one with other facades of the same bundle
        # and configuration (a server's connections).
        self._graphs: Optional[GraphCache] = graph_cache
        if graph_cache is None and graphs and self.device.type == "cuda":
            self._graphs = GraphCache(self.device)
        self._staging = {}
        self._reset_upload_counts()
        # The host FrameResult of the latest step (numpy arrays).
        self.last_result: Optional[FrameResult] = None

    def _pick_bucket(self, n: int) -> int:
        return _pick_bucket(self._buckets, n)

    def _reset_upload_counts(self):
        # Totals, for checks: uploads, those split into bands, and the
        # bands of those (each band one H2D on a CUDA device).
        self.uploads = 0
        self.uploads_split = 0
        self.upload_chunks = 0

    def _upload(self, name: str, array) -> torch.Tensor:
        """``array`` (an array, or a list of arrays that make up its
        leading axis: ``upload.as_batch``) on the device. On a CUDA device
        it goes through a pinned staging buffer kept per ``name`` and the
        copy is not waited for: from ``upload.SPLIT_BYTES`` on, a pool of
        worker threads copies it there in bands and each band's H2D is
        enqueued as soon as it has landed, into one device tensor; below,
        one copy and one H2D. The buffer is rewritten by the next upload of
        that name, after the step that read it has been read back. Every
        upload copies its bytes."""
        shape, dtype = upload.batch_shape(array)
        dtype = upload.torch_dtype(dtype)
        self.uploads += 1
        if self.device.type != "cuda":
            out = torch.empty(shape, dtype=dtype)
            self._stage(out, array)
            return out.to(self.device)
        stage = self._staging.get(name)
        if stage is None or stage.shape != shape or stage.dtype != dtype:
            stage = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._staging[name] = stage
        out = torch.empty(shape, dtype=dtype, device=self.device)
        src = stage.view(-1).view(torch.uint8)
        dst = out.view(-1).view(torch.uint8)

        def h2d(a, b):
            dst[a:b].copy_(src[a:b], non_blocking=True)

        self._stage(stage, array, h2d)
        return out

    def _stage(self, dst: torch.Tensor, array, on_chunk=None):
        with self.timers.span("upload.copy"):
            bands = upload.stage(dst, array, on_chunk)
        if bands:
            self.uploads_split += 1
            self.upload_chunks += bands

    def _first_buckets(self, last_live: Optional[int], last_face: int):
        """(reid bucket, face bucket, whether they can overflow) for the
        next step, from the previous step's counts."""
        cfg = self.pipe_cfg
        if not cfg.host_bucket_dispatch:
            return None, None, False  # the step's own switch: exact
        if cfg.disable_reid:
            return 0, 0, False  # IoU-only: zero features
        if last_live is None:
            return self._buckets[-1], self._buckets[-1], True
        return (self._pick_bucket(last_live),
                self._pick_bucket(face_bucket_need(last_face, last_live)),
                True)

    def _dispatch(self, stores, frames_dev, gmc, reid_bucket, face_bucket
                  ) -> Tuple[TrackStore, FrameResult]:
        """One device step at a static bucket pair (None: the in-program
        switch), eagerly: the override point for other ways of running a
        step. Must not write ``stores`` and must not wait for the
        device."""
        raise NotImplementedError

    def _step(self, stores, frames_dev, reid_bucket, face_bucket, gmc=None
              ) -> Tuple[TrackStore, PackedResult]:
        """One step, with its FrameResult packed on the device: through
        the graph cache where there is one, else eagerly."""
        layout = []

        def run(frames, gmc_t, *store_fields):
            new, result = self._dispatch(
                _store_from(store_fields), frames, gmc_t, reid_bucket,
                face_bucket)
            packed = pack_result(result)
            stage_mark("pack")
            layout[:] = [packed.layout]
            return [packed.packed, *_store_tensors(new)]

        inputs = [frames_dev, gmc, *_store_tensors(stores)]
        on_host = done = None
        marks = (Marks(self.timers, self.device) if self.timers.tracing
                 else None)
        with recording(marks) if marks is not None else _NULL:
            if self._graphs is None:
                out = run(*inputs)
            else:
                cache = self._graphs
                key = step_key(self.kind, frames_dev.shape, reid_bucket,
                               face_bucket, gmc is not None)
                out = cache.run(key, run, inputs)
        if self._graphs is not None:
            # A replay does not run the function: the key's first use
            # did, and left its layout.
            if layout:
                cache.meta[key] = layout[0]
            else:
                layout.append(cache.meta[key])
            if cache.has_switches(key):
                cfgs = (self.tracker_cfg, self.nms_cfg, self.pipe_cfg)
                on_host = lambda res: cache.count_branches(  # noqa: E731
                    key, switch_values(res, *cfgs))
        if marks is not None and marks.timed:
            done = torch.cuda.Event()
            done.record()
        return _store_from(out[1:]), PackedResult(out[0], layout[0],
                                                  on_host, marks, done)

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

    def _read(self, packed) -> FrameResult:
        """A step's host FrameResult. Traced: the wait for the step's last
        work (span "readback.wait"), the copy, then its stage device
        times."""
        if not self.timers.tracing:
            return packed.to_host()
        runs = packed.runs()
        with self.timers.span("readback.wait"):
            for p in runs:
                if p.done is not None:
                    p.done.synchronize()
        res = packed.to_host()
        for p in runs:
            self.timers.add_step(p.marks)
        return res

    def _settle(self, backup, frames_dev, gmc, step, buckets):
        """Read a step back and re-run it from ``backup``, the pre-step
        stores, at larger buckets while its counts overflow the picked
        ones. Returns (stores, host FrameResult, (live, face) counts or
        None)."""
        stores, packed = step
        bucket, fbucket, check = buckets
        while True:
            res = self._read(packed)
            if not check:
                return stores, res, None
            counts = self._counts(res)
            need = face_bucket_need(counts[1], counts[0])
            if counts[0] <= bucket and need <= fbucket:
                return stores, res, counts
            bucket = self._pick_bucket(counts[0])
            fbucket = self._pick_bucket(need)
            with self.timers.span("device_step"):
                stores, packed = self._step(backup, frames_dev, bucket,
                                            fbucket, gmc)


class BoTSORTPipeline(_Facade):
    """End-to-end tracker over one video stream on the bundle's device.

    graphs: replay the step from a CUDA graph (CUDA devices; False runs it
    eagerly). trace: keep each update's spans and the step's stage device
    times (``timers.export()``). graph_cache: a GraphCache shared with
    other facades of the same bundle and configuration.
    """

    kind = "frame"

    def __init__(self, bundle: ModelBundle,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig(),
                 graphs: bool = True, trace: bool = False,
                 graph_cache: Optional[GraphCache] = None):
        super().__init__(bundle, tracker_cfg, nms_cfg, pipe_cfg, graphs,
                         trace, graph_cache)
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
        self._reset_upload_counts()
        if self.gmc is not None:
            self.gmc.reset()

    def _dispatch(self, store, frame_dev, gmc_affine, reid_bucket,
                  face_bucket):
        return frame_step(
            self.bundle, store, frame_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, gmc_affine, reid_bucket=reid_bucket,
            face_bucket=face_bucket)

    def _counts(self, res: FrameResult):
        return _live_and_face_counts(res, self._det_width)

    def _session(self):
        return self.store, self._last_n_live, self._last_n_face

    def _resume(self, store, last_live, last_face):
        self.store, self._last_n_live, self._last_n_face = (
            store, last_live, last_face)

    def update(self, frame_bgr: np.ndarray) -> List[STrackView]:
        """One frame. frame_bgr: [H, W, 3] uint8 (OpenCV layout)."""
        self.timers.begin_update()
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
        with self.timers.stage("readback"):
            self.store, res, counts = self._settle(
                backup, frame_dev, gmc_affine, step, buckets)
            if counts is not None:
                self._last_n_live, self._last_n_face = counts
        self.last_result = res
        with self.timers.stage("assemble"):
            tracks = assemble_tracks(res, self.tracker_cfg, self.nms_cfg,
                                     self.pipe_cfg, warn_state=self)
        self.timers.end_update()
        return tracks


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
    eagerly). trace: keep each update's spans (the root from
    ``update_async`` to ``result()``'s return) and the step's stage device
    times (``timers.export()``). graph_cache: a GraphCache shared with
    other facades of the same bundle and configuration.
    """

    kind = "batched"

    def __init__(self, bundle: ModelBundle, n_streams: int,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig(),
                 graphs: bool = True, trace: bool = False,
                 graph_cache: Optional[GraphCache] = None):
        super().__init__(bundle, tracker_cfg, nms_cfg, pipe_cfg, graphs,
                         trace, graph_cache)
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
        self._reset_upload_counts()

    def _dispatch(self, stores, frames_dev, gmc_affines, reid_bucket,
                  face_bucket):
        return frame_step_batched(
            self.bundle, stores, frames_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, gmc_affines, reid_bucket=reid_bucket,
            face_bucket=face_bucket)

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

    def _check_frames(self, shape: Tuple[int, ...]):
        if shape[0] != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} frames, got {shape[0]}")

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
        frames = upload.as_batch(frames_bgr)
        self._check_frames(upload.batch_shape(frames)[0])
        self.timers.begin_update()
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
            tracks = self._assemble(res)
        self.timers.end_update()
        return tracks

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
                 graphs: bool = True, trace: bool = False,
                 graph_cache: Optional[GraphCache] = None):
        super().__init__(bundle, n_streams, tracker_cfg, nms_cfg, pipe_cfg,
                         graphs, trace, graph_cache)
        if t_batch < 1:
            raise ValueError(f"t_batch must be >= 1, got {t_batch}")
        self.t_batch = t_batch

    def _dispatch(self, stores, frames_dev, gmc_affines, reid_bucket,
                  face_bucket):
        return frame_step_batched_temporal(
            self.bundle, stores, frames_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, gmc_affines, reid_bucket=reid_bucket,
            face_bucket=face_bucket)

    def _check_frames(self, shape: Tuple[int, ...]):
        if shape[:2] != (self.n_streams, self.t_batch):
            raise ValueError(
                f"expected [B={self.n_streams}, T={self.t_batch}, H, W, 3] "
                f"frames, got {shape}")

    def _frame_results(self, res: FrameResult):
        return [(s, stream_result(stream_result(res, s), t))
                for t in range(self.t_batch) for s in range(self.n_streams)]

    def _assemble(self, res: FrameResult) -> List[List[List[STrackView]]]:
        flat = super()._assemble(res)
        b = self.n_streams
        return [flat[t * b:(t + 1) * b] for t in range(self.t_batch)]


class _MeshPacked(NamedTuple):
    """The slices' packed FrameResults of one mesh step."""

    parts: Tuple[PackedResult, ...]

    def runs(self) -> Tuple[PackedResult, ...]:
        return self.parts

    def to_host(self) -> FrameResult:
        """One FrameResult over all streams: each slice read back in one
        copy (every slice's step was enqueued before the first read)."""
        hosts = [p.to_host() for p in self.parts]
        return _result_from([np.concatenate(f) for f in zip(
            *[[*h[:-1], *h.tracks] for h in hosts])])


class MeshBatchedBoTSORTPipeline(BatchedBoTSORTPipeline):
    """S streams over a tuple of devices, S / devices streams on each.

    The multi-card serving topology: each device runs the same batched step
    (``frame_step_batched``) on its slice of the streams with a replica of
    the bundle (parallel/streams.py), pure data parallelism with no
    collective. Each slice is a ``BatchedBoTSORTPipeline`` on its device;
    slices on one device share its graph cache. The bucket pair is shared
    by all streams, sized by the largest live count over all of them, so
    every slice steps at the same buckets and an overflow re-runs them all.
    Every slice's step is enqueued before any is read back.

    If n_streams does not split evenly, the streams are padded with copies
    of stream 0 (their state evolves, their outputs are dropped); callers
    see exactly n_streams track lists. ``mesh`` is a tuple of devices
    (default: ``make_mesh(n_chips)`` of the bundle's device type); with one
    device it steps exactly as ``BatchedBoTSORTPipeline``. The slices share
    the facade's ``timers``: a traced update holds one ``graph.launch`` and
    one step run's stage times a slice (slices on one device replay one
    graph, whose marks then read the last slice's run).
    """

    def __init__(self, bundle: ModelBundle, n_streams: int, mesh=None,
                 n_chips: Optional[int] = None,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig(),
                 graphs: bool = True, trace: bool = False):
        from botsort_tpu_torch.parallel.streams import (
            make_mesh,
            replicate_bundle,
        )

        if mesh is None:
            mesh = make_mesh(n_chips, bundle.device.type)
        self.mesh = tuple(torch.device(d) for d in mesh)
        self.n_chips = len(self.mesh)
        pad = (-n_streams) % self.n_chips
        super().__init__(bundle, n_streams + pad, tracker_cfg, nms_cfg,
                         pipe_cfg, graphs=False, trace=trace)
        self.real_streams = n_streams
        per = self.n_streams // self.n_chips
        caches = {}
        self._slices = []
        for rep in replicate_bundle(bundle, self.mesh):
            dev = rep.device
            if dev not in caches:
                caches[dev] = GraphCache(dev) if (
                    graphs and dev.type == "cuda") else None
            self._slices.append(BatchedBoTSORTPipeline(
                rep, per, tracker_cfg, nms_cfg, pipe_cfg, graphs=False,
                graph_cache=caches[dev]))
            self._slices[-1].timers = self.timers
        self.stores = [sl.stores for sl in self._slices]

    def reset(self):
        super().reset()
        for sl in self._slices:
            sl.reset()
        self.stores = [sl.stores for sl in self._slices]

    def _upload(self, name: str, array):
        """Frames and affines go to the slices' devices, a part each; the
        facade's upload counts are the slices' sums."""
        per = len(array) // self.n_chips
        out = [sl._upload(name, array[k * per:(k + 1) * per])
               for k, sl in enumerate(self._slices)]
        for count in ("uploads", "uploads_split", "upload_chunks"):
            setattr(self, count, sum(getattr(sl, count)
                                     for sl in self._slices))
        return out

    def _step(self, stores, frames_dev, reid_bucket, face_bucket, gmc=None):
        steps = [sl._step(st, fr, reid_bucket, face_bucket,
                          None if gmc is None else gmc[k])
                 for k, (sl, st, fr) in enumerate(zip(
                     self._slices, stores, frames_dev))]
        return [st for st, _ in steps], _MeshPacked(
            tuple(p for _, p in steps))

    def _session(self):
        merged = [None if f[0] is None else torch.cat(
            [t.to(self.mesh[0]) for t in f])
            for f in zip(*[_store_tensors(st) for st in self.stores])]
        return _store_from(merged), self._last_max_live, self._last_max_face

    def _resume(self, stores, last_live, last_face):
        per = self.n_streams // self.n_chips
        self.stores = [_store_from(
            [None if t is None else t[k * per:(k + 1) * per].to(dev)
             for t in _store_tensors(stores)])
            for k, dev in enumerate(self.mesh)]
        self._last_max_live, self._last_max_face = last_live, last_face

    def update_async(self, frames_bgr, gmc_affines=None) -> "PendingBatch":
        if len(frames_bgr) != self.real_streams:
            raise ValueError(
                f"expected {self.real_streams} frames, got {len(frames_bgr)}")
        pad = self.n_streams - self.real_streams
        if pad:
            frames_bgr = list(frames_bgr) + [frames_bgr[0]] * pad
            if gmc_affines is not None:
                gmc_affines = list(gmc_affines) + [gmc_affines[0]] * pad
        return super().update_async(frames_bgr, gmc_affines)

    def _resolve(self, frames_dev, gmc, step, backup, buckets):
        out = super()._resolve(frames_dev, gmc, step, backup, buckets)
        return out[:self.real_streams]


def bucket_pairs(buckets: List[int]) -> List[Tuple[int, int]]:
    """Every (reid bucket, face bucket) a facade can pick from ``buckets``:
    the face bucket never exceeds the body bucket."""
    return [(b, fb) for b in buckets for fb in buckets if fb <= b]


def warm_up(pipeline: BoTSORTPipeline, frame_hw: Tuple[int, int]
            ) -> List[Tuple[Tuple, float]]:
    """Run the program of every bucket pair the facade can pick for frames
    of ``frame_hw`` (the one in-program-switch program with
    ``host_bucket_dispatch=False``) once, from its current store, and wait
    for each: on a card with graphs that captures each step (a live frame,
    or its re-run, then replays it; an exported pipeline loads each
    program here); elsewhere it runs each step eagerly once. The facade's
    state is not changed. Returns ((reid bucket, face bucket), seconds)
    per step."""
    frame = pipeline._upload("warm_up",
                             np.zeros(tuple(frame_hw) + (3,), np.uint8))
    first = pipeline._first_buckets(None, 0)
    pairs = bucket_pairs(pipeline._buckets) if first[2] else [first[:2]]
    out = []
    for b, fb in pairs:
        t0 = time.perf_counter()
        _, packed = pipeline._step(pipeline.store, frame, b, fb, None)
        packed.to_host()
        out.append(((b, fb), time.perf_counter() - t0))
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
