"""Host-side tracker facade (port of botsort_tpu/pipeline/host.py).

``BoTSORTPipeline.update(frame) -> List[STrackView]`` uploads one frame,
runs the frame step at a static ReID bucket picked from the previous
frame's live counts, re-runs the rare frame whose counts overflow that
bucket, reads the FrameResult back and assembles the host track list
with its box hierarchy.
"""

from __future__ import annotations

import dataclasses
import sys
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
    reid_bucket_set,
)
from botsort_tpu_torch.track.cascade import TrackOutputs
from botsort_tpu_torch.track.state import empty_store
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
        if pipe_cfg.enable_gmc:
            raise NotImplementedError(
                "camera-motion compensation is not ported yet "
                "(tracker_update takes a gmc_affine; the estimator does not "
                "exist in this package)")
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
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

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
