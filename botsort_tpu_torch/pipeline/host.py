"""Host-side tracker facades (port of botsort_tpu/pipeline/host.py).

``BoTSORTPipeline.update(frame) -> List[STrackView]`` uploads one frame,
runs the frame step at a static ReID bucket picked from the previous
frame's live counts, re-runs the rare frame whose counts overflow that
bucket, reads the FrameResult back and assembles the host track list
with its box hierarchy. ``BatchedBoTSORTPipeline`` does the same for B
streams per step through ``frame_step_batched``, with one bucket sized by
the largest count across the streams.
"""

from __future__ import annotations

import dataclasses
import sys
import types
from typing import Any, List, Optional

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
    reid_bucket_set,
    stream_result,
)
from botsort_tpu_torch.track.cascade import TrackOutputs
from botsort_tpu_torch.track.state import empty_store, empty_stores
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


def to_host(result: FrameResult) -> FrameResult:
    """The same FrameResult with numpy arrays in place of tensors."""
    def np_(x):
        return x.cpu().numpy()

    tracks = TrackOutputs(*(np_(x) for x in result.tracks))
    return FrameResult(*(np_(x) for x in result[:-1]), tracks)


def _check_dispatch(pipe_cfg: PipelineConfig):
    """The configurations the JAX package's facades refuse."""
    if pipe_cfg.enable_gmc:
        raise NotImplementedError(
            "camera-motion compensation is not ported yet "
            "(tracker_update takes a gmc_affine; the estimator does not "
            "exist in this package)")
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


class BoTSORTPipeline:
    """End-to-end tracker over one video stream on the bundle's device."""

    def __init__(self, bundle: ModelBundle,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig()):
        _check_dispatch(pipe_cfg)
        self.bundle = bundle
        self.tracker_cfg = tracker_cfg
        self.nms_cfg = nms_cfg
        self.pipe_cfg = pipe_cfg
        self.device = bundle.device
        self.store = empty_store(tracker_cfg, self.device)
        self.frame_id = 0
        self.timers = StageTimers(cuda_sync=self.device.type == "cuda")
        self._buckets = reid_bucket_set(tracker_cfg, nms_cfg, pipe_cfg)
        self._det_width = _det_width(tracker_cfg, nms_cfg)
        self._last_n_live: Optional[int] = None
        self._last_n_face = 0
        # The host FrameResult of the latest frame (detections, hierarchy
        # and track outputs as numpy arrays).
        self.last_result: Optional[FrameResult] = None

    def _pick_bucket(self, n: int) -> int:
        return _pick_bucket(self._buckets, n)

    def reset(self):
        self.store = empty_store(self.tracker_cfg, self.device)
        self.frame_id = 0
        self._last_n_live = None
        self._last_n_face = 0
        self.last_result = None
        self.timers.reset()

    def _step(self, store, frame_dev, reid_bucket, face_bucket):
        store, result = frame_step(
            self.bundle, store, frame_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, reid_bucket=reid_bucket, face_bucket=face_bucket)
        return store, to_host(result)

    def update(self, frame_bgr: np.ndarray) -> List[STrackView]:
        """One frame. frame_bgr: [H, W, 3] uint8 (OpenCV layout)."""
        self.frame_id += 1
        with self.timers.stage("upload"):
            frame_dev = torch.from_numpy(
                np.ascontiguousarray(frame_bgr)).to(self.device)
        with self.timers.stage("device_step"):
            cfg = self.pipe_cfg
            if not cfg.host_bucket_dispatch:
                # Every det slot embedded: exact, no re-run.
                self.store, res = self._step(self.store, frame_dev, None,
                                             None)
            elif cfg.disable_reid:
                # IoU-only: zero features make the fused cost plain IoU.
                self.store, res = self._step(self.store, frame_dev, 0, 0)
            else:
                if self._last_n_live is None:
                    bucket = fbucket = self._buckets[-1]
                else:
                    bucket = self._pick_bucket(self._last_n_live)
                    fbucket = self._pick_bucket(face_bucket_need(
                        self._last_n_face, self._last_n_live))
                # frame_step never writes its input store, so the
                # pre-step store is the overflow re-run's backup as is.
                backup = self.store
                self.store, res = self._step(backup, frame_dev, bucket,
                                             fbucket)
                n_live, n_face = _live_and_face_counts(res, self._det_width)
                need = face_bucket_need(n_face, n_live)
                if n_live > bucket or need > fbucket:
                    self.store, res = self._step(
                        backup, frame_dev, self._pick_bucket(n_live),
                        self._pick_bucket(need))
                self._last_n_live = n_live
                self._last_n_face = n_face
        self.last_result = res
        with self.timers.stage("assemble"):
            return assemble_tracks(res, self.tracker_cfg, self.nms_cfg,
                                   self.pipe_cfg, warn_state=self)


class BatchedBoTSORTPipeline:
    """B independent streams stepped together on the bundle's device.

    Every ``update`` takes one frame per stream (all of one resolution)
    and runs ``frame_step_batched``: perception batched over the streams,
    the B cascades one launch of kernel K2 on the card. The ReID bucket is
    shared, picked from the previous step's largest live count across the
    streams; a step that overflows it re-runs from the pre-step stores,
    which the step never writes.
    """

    def __init__(self, bundle: ModelBundle, n_streams: int,
                 tracker_cfg: TrackerConfig = TrackerConfig(),
                 nms_cfg: NMSConfig = NMSConfig(),
                 pipe_cfg: PipelineConfig = PipelineConfig()):
        _check_dispatch(pipe_cfg)
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.bundle = bundle
        self.n_streams = n_streams
        self.tracker_cfg = tracker_cfg
        self.nms_cfg = nms_cfg
        self.pipe_cfg = pipe_cfg
        self.device = bundle.device
        self.stores = empty_stores(tracker_cfg, n_streams, self.device)
        self.frame_id = 0
        self.timers = StageTimers(cuda_sync=self.device.type == "cuda")
        self._buckets = reid_bucket_set(tracker_cfg, nms_cfg, pipe_cfg)
        self._det_width = _det_width(tracker_cfg, nms_cfg)
        self._last_max_live: Optional[int] = None
        self._last_max_face = 0
        # Per-stream once-only warning state.
        self._warn = [types.SimpleNamespace() for _ in range(n_streams)]
        # The host FrameResult of the latest step ([B, ...] numpy arrays).
        self.last_result: Optional[FrameResult] = None

    def reset(self):
        self.stores = empty_stores(self.tracker_cfg, self.n_streams,
                                   self.device)
        self.frame_id = 0
        self._last_max_live = None
        self._last_max_face = 0
        self.last_result = None
        self.timers.reset()

    def _pick_bucket(self, n: int) -> int:
        return _pick_bucket(self._buckets, n)

    def _step(self, stores, frames_dev, reid_bucket, face_bucket):
        return frame_step_batched(
            self.bundle, stores, frames_dev, self.tracker_cfg, self.nms_cfg,
            self.pipe_cfg, reid_bucket=reid_bucket, face_bucket=face_bucket)

    def _counts(self, res_host: FrameResult):
        """(max live bodies, max attached faces) across the streams."""
        counts = [_live_and_face_counts(stream_result(res_host, s),
                                        self._det_width)
                  for s in range(self.n_streams)]
        return max(c[0] for c in counts), max(c[1] for c in counts)

    def update(self, frames_bgr) -> List[List[STrackView]]:
        """frames_bgr: [B, H, W, 3] uint8 (an array or a list of B frames,
        OpenCV layout). Returns each stream's track list."""
        return self.update_async(frames_bgr).result()

    def update_async(self, frames_bgr) -> "PendingBatch":
        """Run one step and return before reading it back: the card works
        on the step while the caller draws or encodes the previous one;
        ``result()`` reads back, re-runs an overflowing step and assembles
        the track lists. Resolve each handle before the next
        ``update_async``: the overflow check may replace the stores."""
        frames = np.stack(frames_bgr)
        if frames.shape[0] != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} frames, got {frames.shape[0]}")
        self.frame_id += 1
        with self.timers.stage("upload"):
            frames_dev = torch.from_numpy(frames).to(self.device)
        cfg = self.pipe_cfg
        if not cfg.host_bucket_dispatch:
            # Every det slot embedded: exact, no re-run.
            bucket = fbucket = None
        elif cfg.disable_reid:
            # IoU-only: zero features make the fused cost plain IoU.
            bucket = fbucket = 0
        elif self._last_max_live is None:
            bucket = fbucket = self._buckets[-1]
        else:
            bucket = self._pick_bucket(self._last_max_live)
            fbucket = self._pick_bucket(face_bucket_need(
                self._last_max_face, self._last_max_live))
        backup = self.stores
        with self.timers.stage("device_step"):
            self.stores, result = self._step(backup, frames_dev, bucket,
                                             fbucket)
        # Only a picked bucket can overflow.
        check = cfg.host_bucket_dispatch and not cfg.disable_reid
        return PendingBatch(self, frames_dev, result, backup,
                            (bucket, fbucket) if check else None)

    def _resolve(self, frames_dev, result, backup, buckets
                 ) -> List[List[STrackView]]:
        with self.timers.stage("readback"):
            res = to_host(result)
            if buckets is not None:
                max_live, max_face = self._counts(res)
                need = face_bucket_need(max_face, max_live)
                if max_live > buckets[0] or need > buckets[1]:
                    self.stores, result = self._step(
                        backup, frames_dev, self._pick_bucket(max_live),
                        self._pick_bucket(need))
                    res = to_host(result)
                self._last_max_live = max_live
                self._last_max_face = max_face
        self.last_result = res
        with self.timers.stage("assemble"):
            return [assemble_tracks(stream_result(res, s), self.tracker_cfg,
                                    self.nms_cfg, self.pipe_cfg,
                                    warn_state=self._warn[s])
                    for s in range(self.n_streams)]


class PendingBatch:
    """Handle for one ``BatchedBoTSORTPipeline`` step in flight."""

    def __init__(self, pipeline: BatchedBoTSORTPipeline, frames_dev, result,
                 backup, buckets):
        self._args = (frames_dev, result, backup, buckets)
        self._pipeline = pipeline
        self._out: Optional[List[List[STrackView]]] = None

    def result(self) -> List[List[STrackView]]:
        """Read the step back (once) and return each stream's tracks."""
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
