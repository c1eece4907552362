"""Structure-of-arrays track store over fixed slots (port of
botsort_tpu/track/state.py).

One slot per live track; ``state`` encodes membership: FREE = 0 (no track,
also where removed tracks go), TRACKED = 1 (``is_activated`` separates
confirmed from unconfirmed), LOST = 2. The optional feature-history ring
(``TrackerConfig.feature_history > 0``) keeps the last H detection
features of every track.

B streams' stores are one ``TrackStore`` whose every field carries a
leading [B] (``empty_stores``); ``store.map(lambda x: x[b])`` is stream
b's view.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from botsort_tpu_torch.config import TrackerConfig

FREE = 0
TRACKED = 1
LOST = 2


@dataclasses.dataclass
class TrackStore:
    state: torch.Tensor          # [N] int32
    is_activated: torch.Tensor   # [N] bool
    track_id: torch.Tensor       # [N] int32
    score: torch.Tensor          # [N] f32
    frame_id: torch.Tensor       # [N] int32 — frame of last update
    start_frame: torch.Tensor    # [N] int32
    tracklet_len: torch.Tensor   # [N] int32
    mean: torch.Tensor           # [N, 8] f32 — cx, cy, w, h and velocities
    cov: torch.Tensor            # [N, 4, 3] f32 — per-coordinate 2x2 blocks
    body_feat: torch.Tensor      # [N, Db] f32 — last raw feature
    body_smooth: torch.Tensor    # [N, Db] f32 — EMA-smoothed, normalized
    face_feat: torch.Tensor      # [N, Df] f32
    face_smooth: torch.Tensor    # [N, Df] f32
    det_index: torch.Tensor      # [N] int32 — det slot this frame, or -1
    next_id: torch.Tensor        # [] int32
    frame_count: torch.Tensor    # [] int32
    body_hist: Optional[torch.Tensor] = None  # [N, H, Db] ring buffer
    face_hist: Optional[torch.Tensor] = None  # [N, H, Df]
    hist_pos: Optional[torch.Tensor] = None   # [N] int32 write cursor

    def replace(self, **changes) -> "TrackStore":
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "TrackStore":
        """The store with fn applied to every field that is present."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})


def empty_store(cfg: TrackerConfig, device=None) -> TrackStore:
    n = cfg.max_tracks
    db = cfg.body_feature_dim
    df = cfg.face_feature_dim
    h = cfg.feature_history
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackStore(
        state=torch.zeros((n,), **i32),
        is_activated=torch.zeros((n,), dtype=torch.bool, device=device),
        track_id=torch.zeros((n,), **i32),
        score=torch.zeros((n,), **f32),
        frame_id=torch.zeros((n,), **i32),
        start_frame=torch.zeros((n,), **i32),
        tracklet_len=torch.zeros((n,), **i32),
        mean=torch.zeros((n, 8), **f32),
        cov=torch.zeros((n, 4, 3), **f32),
        body_feat=torch.zeros((n, db), **f32),
        body_smooth=torch.zeros((n, db), **f32),
        face_feat=torch.zeros((n, df), **f32),
        face_smooth=torch.zeros((n, df), **f32),
        det_index=torch.full((n,), -1, **i32),
        next_id=torch.zeros((), **i32),
        frame_count=torch.zeros((), **i32),
        body_hist=torch.zeros((n, h, db), **f32) if h > 0 else None,
        face_hist=torch.zeros((n, h, df), **f32) if h > 0 else None,
        hist_pos=torch.zeros((n,), **i32) if h > 0 else None,
    )


def empty_stores(cfg: TrackerConfig, b: int, device=None) -> TrackStore:
    """B empty stores as one, every field with a leading [B]."""
    return empty_store(cfg, device).map(
        lambda x: x.unsqueeze(0).repeat((b,) + (1,) * x.dim()))
