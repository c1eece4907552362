"""The BoT-SORT association cascade (port of botsort_tpu/track/cascade.py).

One tracker frame over the slot store: Kalman predict of the pool
(tracked + lost), three chained thresholded assignments (pool x high dets
over fused IoU + dual-appearance costs; still-tracked x low dets over IoU;
unconfirmed x leftover high dets), the measurement update, feature EMA,
lifecycle transitions, new-track slot scatter, lost-track expiry,
tracked/lost deduplication and the optional feature-history ring. The
three solves run as one call of ``solve_cascade_masked`` — kernel K1 on
the card. ``tracker_update_batched`` runs B independent streams' frames
at once (their three solves one launch of K2); ``tracker_update`` is its
one-stream case.

Deviations from the original reference, as in the JAX package: the face
anomaly mask zeroes any similarity > 0.99999; exact assignment ties may
resolve to a different optimal matching. The function is pure: the input
store is never written.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from botsort_tpu_torch.config import TrackerConfig
from botsort_tpu_torch.ops import assignment, kalman
from botsort_tpu_torch.ops.boxes import (
    iou_distance,
    tlbr_to_tlwh,
    tlwh_to_xywh,
    xywh_to_tlbr,
)
from botsort_tpu_torch.track.state import FREE, LOST, TRACKED, TrackStore


class TrackOutputs(NamedTuple):
    """Per-frame readback: valid [N] (currently Tracked), tlbr [N, 4],
    track_id / score [N], det_index [N] int32 (body-det slot matched or
    created from this frame), dropped_new [] (new tracks lost to full
    slots). ``tracker_update_batched`` gives each a leading [B]."""

    valid: torch.Tensor
    tlbr: torch.Tensor
    track_id: torch.Tensor
    score: torch.Tensor
    det_index: torch.Tensor
    dropped_new: torch.Tensor


def _ema_update(smooth: torch.Tensor, feat: torch.Tensor, alpha: float,
                apply: torch.Tensor) -> torch.Tensor:
    """normalize(alpha*smooth + (1-alpha)*feat) on the masked rows."""
    mixed = alpha * smooth + (1.0 - alpha) * feat
    norm = torch.linalg.norm(mixed, dim=-1, keepdim=True)
    mixed = mixed / torch.clamp(norm, min=1e-12)
    return torch.where(apply[..., None], mixed, smooth)


def tracker_update(store: TrackStore, det_tlbr: torch.Tensor,
                   det_score: torch.Tensor, det_valid: torch.Tensor,
                   det_body_feat: torch.Tensor, det_face_feat: torch.Tensor,
                   cfg: TrackerConfig,
                   gmc_affine: Optional[torch.Tensor] = None
                   ) -> Tuple[TrackStore, TrackOutputs]:
    """One tracker frame of one stream; det_* are padded to D slots.

    det_tlbr [D, 4] source pixels; det_score [D]; det_valid [D];
    det_body_feat [D, Db] and det_face_feat [D, Df] L2-normalised.
    gmc_affine: optional [2, 3] camera motion applied after predict.
    The one-stream case of ``tracker_update_batched``.
    """
    one = lambda x: x[None]
    stores, out = tracker_update_batched(
        store.map(one), one(det_tlbr), one(det_score), one(det_valid),
        one(det_body_feat), one(det_face_feat), cfg,
        None if gmc_affine is None else one(gmc_affine))
    return (stores.map(lambda x: x[0]),
            TrackOutputs(*(x[0] for x in out)))


def tracker_update_batched(stores: TrackStore, det_tlbr: torch.Tensor,
                           det_score: torch.Tensor, det_valid: torch.Tensor,
                           det_body_feat: torch.Tensor,
                           det_face_feat: torch.Tensor, cfg: TrackerConfig,
                           gmc_affines: Optional[torch.Tensor] = None
                           ) -> Tuple[TrackStore, TrackOutputs]:
    """One tracker frame of B independent streams (the JAX package's
    ``jax.vmap(tracker_update)``): stores carry a leading [B] on every
    field, det_* a leading [B] before the D slots ([B, D, 4], [B, D],
    ...), gmc_affines is [B, 2, 3] or None. The B cascades' assignments
    are one ``solve_cascade_masked`` call: one launch of the cascade
    kernel on the card.
    """
    bsz, n = stores.state.shape
    d = det_tlbr.shape[1]
    dev = stores.state.device
    frame = stores.frame_count + 1                                # [B]
    i32 = torch.int32
    bi = torch.arange(bsz, device=dev)[:, None]                   # [B, 1]

    tracked_m = (stores.state == TRACKED) & stores.is_activated
    unconfirmed_m = (stores.state == TRACKED) & ~stores.is_activated
    lost_m = stores.state == LOST
    pool_m = tracked_m | lost_m

    # Predict the pool; lost tracks get (vw, vh) zeroed first.
    vel_wh = torch.arange(8, device=dev) >= 6
    mean_z = torch.where(lost_m[..., None] & vel_wh, 0.0, stores.mean)
    mean_p, cov_p = kalman.predict(mean_z, stores.cov)
    mean = torch.where(pool_m[..., None], mean_p, stores.mean)
    cov = torch.where(pool_m[..., None, None], cov_p, stores.cov)
    if gmc_affines is not None:
        gmc_m = pool_m | unconfirmed_m
        mean_g, cov_g = kalman.apply_affine(mean, cov, gmc_affines)
        mean = torch.where(gmc_m[..., None], mean_g, mean)
        cov = torch.where(gmc_m[..., None, None], cov_g, cov)

    track_tlbr = xywh_to_tlbr(mean[..., :4])
    det_xywh = tlwh_to_xywh(tlbr_to_tlwh(det_tlbr))

    high_m = det_valid & (det_score > cfg.track_high_thresh)
    low_m = (det_valid & (det_score >= cfg.track_low_thresh)
             & (det_score <= cfg.track_high_thresh))

    # Pass-1 cost: IoU fused with the dual appearance distance.
    iou_d = iou_distance(track_tlbr, det_tlbr)                    # [B, N, D]
    body_sim = stores.body_feat @ det_body_feat.transpose(-1, -2)
    face_sim = stores.face_feat @ det_face_feat.transpose(-1, -2)
    face_sim = torch.where(face_sim > 0.99999, 0.0, face_sim)
    body_d = 1.0 - body_sim
    face_d = 1.0 - face_sim
    gate = torch.minimum(body_d, face_d) > cfg.appearance_thresh
    emb = torch.where(gate, 1.0, body_d)
    dists1 = torch.minimum(iou_d, emb)
    # Pass-3 cost: IoU + clamped body cosine, appearance and proximity
    # masks set 1.
    emb3 = 1.0 - torch.clamp(body_sim, min=0.0)
    emb3 = torch.where(emb3 > cfg.appearance_thresh, 1.0, emb3)
    emb3 = torch.where(iou_d > cfg.proximity_thresh, 1.0, emb3)
    dists3 = torch.minimum(iou_d, emb3)

    res1, res2, res3 = assignment.solve_cascade_masked(
        dists1, iou_d, dists3, pool_m, tracked_m, unconfirmed_m, high_m,
        low_m, (cfg.match_thresh, cfg.second_match_thresh,
                cfg.unconfirmed_match_thresh))

    r_tracked_m = tracked_m & (res1.col_for_row < 0)
    newly_lost_m = r_tracked_m & (res2.col_for_row < 0)
    removed_unconfirmed_m = unconfirmed_m & (res3.col_for_row < 0)
    leftover_m = high_m & (res1.row_for_col < 0)

    # Fused measurement update for every matched row (disjoint row sets).
    det_for_row = torch.where(
        res1.col_for_row >= 0, res1.col_for_row,
        torch.where(res2.col_for_row >= 0, res2.col_for_row,
                    res3.col_for_row))
    matched_m = det_for_row >= 0
    j = torch.clamp(det_for_row, 0, d - 1).long()                 # [B, N]
    mean_u, cov_u = kalman.update(mean, cov, det_xywh[bi, j])
    mean = torch.where(matched_m[..., None], mean_u, mean)
    cov = torch.where(matched_m[..., None, None], cov_u, cov)

    was_lost_refound = matched_m & lost_m
    body_j, face_j = det_body_feat[bi, j], det_face_feat[bi, j]
    body_feat = torch.where(matched_m[..., None], body_j, stores.body_feat)
    face_feat = torch.where(matched_m[..., None], face_j, stores.face_feat)
    body_smooth = _ema_update(stores.body_smooth, body_j,
                              cfg.feature_ema_alpha, matched_m)
    face_smooth = _ema_update(stores.face_smooth, face_j,
                              cfg.feature_ema_alpha, matched_m)

    frame_n = frame[:, None]                                      # [B, 1]
    score = torch.where(matched_m, det_score[bi, j], stores.score)
    frame_id = torch.where(matched_m, frame_n, stores.frame_id).to(i32)
    tracklet_len = torch.where(
        matched_m,
        torch.where(was_lost_refound, 0, stores.tracklet_len + 1),
        stores.tracklet_len).to(i32)
    state = torch.where(matched_m, TRACKED, stores.state).to(i32)
    is_activated = matched_m | stores.is_activated
    state = torch.where(newly_lost_m, LOST, state).to(i32)
    state = torch.where(removed_unconfirmed_m, FREE, state).to(i32)

    # New tracks from the remaining high dets, scattered into each
    # stream's free slots in detection order.
    remaining_m = leftover_m & (res3.row_for_col < 0)
    new_m = remaining_m & (det_score >= cfg.new_track_thresh)
    free_m = state == FREE
    det_rank = torch.cumsum(new_m.to(i32), 1) - 1                 # [B, D]
    slot_rank = torch.cumsum(free_m.to(i32), 1) - 1               # [B, N]
    num_free = free_m.sum(1, keepdim=True)                        # [B, 1]
    # slot_of_rank[b, r] = the r-th free slot of stream b; index n absorbs
    # the occupied slots.
    slot_of_rank = torch.full((bsz, n + 1), n, dtype=torch.int64,
                              device=dev)
    slot_of_rank.scatter_(
        1, torch.where(free_m, slot_rank, n).long(),
        torch.arange(n, device=dev).expand(bsz, n).contiguous())
    fits = new_m & (det_rank < num_free)
    target_slot = torch.where(
        fits, torch.gather(slot_of_rank, 1,
                           torch.clamp(det_rank, 0, n).long()), n)

    def scatter(arr, vals):
        # Det-indexed values into track slots through an [n+1] buffer
        # per stream whose last row absorbs the non-fitting candidates.
        buf = torch.cat([arr, torch.zeros_like(arr[:, :1])], dim=1)
        buf[bi, target_slot] = vals.to(arr.dtype)
        return buf[:, :n]

    new_mean, new_cov = kalman.initiate(det_xywh)
    mean = scatter(mean, new_mean)
    cov = scatter(cov, new_cov)
    state = scatter(state, torch.where(fits, TRACKED, FREE))
    is_activated = scatter(is_activated, fits & (frame_n == 1))
    score = scatter(score, det_score)
    frame_full = frame_n.expand(bsz, d)
    frame_id = scatter(frame_id, frame_full)
    start_frame = scatter(stores.start_frame, frame_full)
    tracklet_len = scatter(tracklet_len, torch.zeros_like(det_rank))
    new_ids = stores.next_id[:, None] + 1 + det_rank
    track_id = scatter(stores.track_id, new_ids)
    next_id = (stores.next_id + fits.sum(1)).to(i32)
    dropped_new = (new_m.sum(1) - fits.sum(1)).to(i32)
    body_feat = scatter(body_feat, det_body_feat)
    face_feat = scatter(face_feat, det_face_feat)
    body_smooth = scatter(body_smooth, det_body_feat)
    face_smooth = scatter(face_smooth, det_face_feat)

    det_index = torch.where(matched_m, det_for_row, -1).to(i32)
    det_index = scatter(det_index,
                        torch.arange(d, device=dev).expand(bsz, d))
    det_index = torch.where(state == TRACKED, det_index, -1).to(i32)

    # Expire lost tracks.
    expired_m = (state == LOST) & (frame_n - frame_id > cfg.max_time_lost)
    state = torch.where(expired_m, FREE, state).to(i32)

    # Dedup tracked vs lost pairs with IoU distance < 0.15: the
    # shorter-lived side goes (a tie drops the tracked one).
    final_tlbr = xywh_to_tlbr(mean[..., :4])
    trk_m = state == TRACKED
    lst_m = state == LOST
    dd = iou_distance(final_tlbr, final_tlbr)                     # [B, N, N]
    pair = (dd < 0.15) & trk_m[..., :, None] & lst_m[..., None, :]
    lifetime = frame_id - start_frame
    p_longer = lifetime[..., :, None] > lifetime[..., None, :]
    drop_lost = (pair & p_longer).any(dim=-2)
    drop_tracked = (pair & ~p_longer).any(dim=-1)
    state = torch.where(drop_lost | drop_tracked, FREE, state).to(i32)

    new_stores = stores.replace(
        state=state,
        is_activated=is_activated & (state != FREE),
        track_id=track_id,
        score=score,
        frame_id=frame_id,
        start_frame=start_frame,
        tracklet_len=tracklet_len,
        mean=mean,
        cov=cov,
        body_feat=body_feat,
        body_smooth=body_smooth,
        face_feat=face_feat,
        face_smooth=face_smooth,
        det_index=det_index,
        next_id=next_id,
        frame_count=frame.to(i32),
    )
    if stores.body_hist is not None:
        # Every slot that took a detection feature this frame appends to
        # its ring; new tracks restart at position 0.
        wrote = det_index >= 0
        is_new = wrote & (start_frame == frame_n)
        pos = torch.where(is_new, 0, stores.hist_pos).to(i32)
        h = stores.body_hist.shape[2]
        rows = torch.arange(n, device=dev)[None, :]
        slot = (pos % h).long()
        body_hist = stores.body_hist.clone()
        face_hist = stores.face_hist.clone()
        body_hist[bi, rows, slot] = torch.where(
            wrote[..., None], body_feat, stores.body_hist[bi, rows, slot])
        face_hist[bi, rows, slot] = torch.where(
            wrote[..., None], face_feat, stores.face_hist[bi, rows, slot])
        new_stores = new_stores.replace(
            body_hist=body_hist, face_hist=face_hist,
            hist_pos=torch.where(wrote, pos + 1, pos).to(i32))

    outputs = TrackOutputs(
        valid=state == TRACKED,
        tlbr=final_tlbr,
        track_id=track_id,
        score=score,
        det_index=det_index,
        dropped_new=dropped_new,
    )
    return new_stores, outputs
