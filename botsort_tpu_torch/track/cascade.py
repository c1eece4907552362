"""The BoT-SORT association cascade (port of botsort_tpu/track/cascade.py).

One tracker frame over the slot store: Kalman predict of the pool
(tracked + lost), three chained thresholded assignments (pool x high dets
over fused IoU + dual-appearance costs; still-tracked x low dets over IoU;
unconfirmed x leftover high dets), the measurement update, feature EMA,
lifecycle transitions, new-track slot scatter, lost-track expiry,
tracked/lost deduplication and the optional feature-history ring. The
three solves run as one call of ``solve_cascade_masked`` — kernel K1 on
the card.

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
    slots)."""

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
    return torch.where(apply[:, None], mixed, smooth)


def tracker_update(store: TrackStore, det_tlbr: torch.Tensor,
                   det_score: torch.Tensor, det_valid: torch.Tensor,
                   det_body_feat: torch.Tensor, det_face_feat: torch.Tensor,
                   cfg: TrackerConfig,
                   gmc_affine: Optional[torch.Tensor] = None
                   ) -> Tuple[TrackStore, TrackOutputs]:
    """One tracker frame; det_* are padded to D slots.

    det_tlbr [D, 4] source pixels; det_score [D]; det_valid [D];
    det_body_feat [D, Db] and det_face_feat [D, Df] L2-normalised.
    gmc_affine: optional [2, 3] camera motion applied after predict.
    """
    n = store.state.shape[0]
    d = det_tlbr.shape[0]
    dev = store.state.device
    frame = store.frame_count + 1
    i32 = torch.int32

    tracked_m = (store.state == TRACKED) & store.is_activated
    unconfirmed_m = (store.state == TRACKED) & ~store.is_activated
    lost_m = store.state == LOST
    pool_m = tracked_m | lost_m

    # Predict the pool; lost tracks get (vw, vh) zeroed first.
    vel_wh = (torch.arange(8, device=dev) >= 6)[None, :]
    mean_z = torch.where(lost_m[:, None] & vel_wh, 0.0, store.mean)
    mean_p, cov_p = kalman.predict(mean_z, store.cov)
    mean = torch.where(pool_m[:, None], mean_p, store.mean)
    cov = torch.where(pool_m[:, None, None], cov_p, store.cov)
    if gmc_affine is not None:
        gmc_m = pool_m | unconfirmed_m
        mean_g, cov_g = kalman.apply_affine(mean, cov, gmc_affine)
        mean = torch.where(gmc_m[:, None], mean_g, mean)
        cov = torch.where(gmc_m[:, None, None], cov_g, cov)

    track_tlbr = xywh_to_tlbr(mean[:, :4])
    det_xywh = tlwh_to_xywh(tlbr_to_tlwh(det_tlbr))

    high_m = det_valid & (det_score > cfg.track_high_thresh)
    low_m = (det_valid & (det_score >= cfg.track_low_thresh)
             & (det_score <= cfg.track_high_thresh))

    # Pass-1 cost: IoU fused with the dual appearance distance.
    iou_d = iou_distance(track_tlbr, det_tlbr)                    # [N, D]
    body_sim = store.body_feat @ det_body_feat.T
    face_sim = store.face_feat @ det_face_feat.T
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
    j = torch.clamp(det_for_row, 0, d - 1).long()
    mean_u, cov_u = kalman.update(mean, cov, det_xywh[j])
    mean = torch.where(matched_m[:, None], mean_u, mean)
    cov = torch.where(matched_m[:, None, None], cov_u, cov)

    was_lost_refound = matched_m & lost_m
    body_feat = torch.where(matched_m[:, None], det_body_feat[j],
                            store.body_feat)
    face_feat = torch.where(matched_m[:, None], det_face_feat[j],
                            store.face_feat)
    body_smooth = _ema_update(store.body_smooth, det_body_feat[j],
                              cfg.feature_ema_alpha, matched_m)
    face_smooth = _ema_update(store.face_smooth, det_face_feat[j],
                              cfg.feature_ema_alpha, matched_m)

    score = torch.where(matched_m, det_score[j], store.score)
    frame_id = torch.where(matched_m, frame, store.frame_id).to(i32)
    tracklet_len = torch.where(
        matched_m,
        torch.where(was_lost_refound, 0, store.tracklet_len + 1),
        store.tracklet_len).to(i32)
    state = torch.where(matched_m, TRACKED, store.state).to(i32)
    is_activated = matched_m | store.is_activated
    state = torch.where(newly_lost_m, LOST, state).to(i32)
    state = torch.where(removed_unconfirmed_m, FREE, state).to(i32)

    # New tracks from the remaining high dets, scattered into free slots
    # in detection order.
    remaining_m = leftover_m & (res3.row_for_col < 0)
    new_m = remaining_m & (det_score >= cfg.new_track_thresh)
    free_m = state == FREE
    det_rank = torch.cumsum(new_m.to(i32), 0) - 1                 # [D]
    slot_rank = torch.cumsum(free_m.to(i32), 0) - 1               # [N]
    num_free = free_m.sum()
    slot_of_rank = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    slot_of_rank[torch.where(free_m, slot_rank, n).long()] = torch.arange(
        n, device=dev)
    fits = new_m & (det_rank < num_free)
    target_slot = torch.where(
        fits, slot_of_rank[torch.clamp(det_rank, 0, n).long()], n)

    def scatter(arr, vals):
        # Det-indexed values into track slots through an [n+1] buffer
        # whose last row absorbs the non-fitting candidates.
        buf = torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)
        buf[target_slot] = vals.to(arr.dtype)
        return buf[:n]

    new_mean, new_cov = kalman.initiate(det_xywh)
    mean = scatter(mean, new_mean)
    cov = scatter(cov, new_cov)
    state = scatter(state, torch.where(fits, TRACKED, FREE))
    is_activated = scatter(is_activated, fits & (frame == 1))
    score = scatter(score, det_score)
    frame_full = frame.expand(d)
    frame_id = scatter(frame_id, frame_full)
    start_frame = scatter(store.start_frame, frame_full)
    tracklet_len = scatter(tracklet_len, torch.zeros_like(det_rank))
    new_ids = store.next_id + 1 + det_rank
    track_id = scatter(store.track_id, new_ids)
    next_id = (store.next_id + fits.sum()).to(i32)
    dropped_new = (new_m.sum() - fits.sum()).to(i32)
    body_feat = scatter(body_feat, det_body_feat)
    face_feat = scatter(face_feat, det_face_feat)
    body_smooth = scatter(body_smooth, det_body_feat)
    face_smooth = scatter(face_smooth, det_face_feat)

    det_index = torch.where(matched_m, det_for_row, -1).to(i32)
    det_index = scatter(det_index, torch.arange(d, device=dev))
    det_index = torch.where(state == TRACKED, det_index, -1).to(i32)

    # Expire lost tracks.
    expired_m = (state == LOST) & (frame - frame_id > cfg.max_time_lost)
    state = torch.where(expired_m, FREE, state).to(i32)

    # Dedup tracked vs lost pairs with IoU distance < 0.15: the
    # shorter-lived side goes (a tie drops the tracked one).
    final_tlbr = xywh_to_tlbr(mean[:, :4])
    trk_m = state == TRACKED
    lst_m = state == LOST
    dd = iou_distance(final_tlbr, final_tlbr)
    pair = (dd < 0.15) & trk_m[:, None] & lst_m[None, :]
    lifetime = frame_id - start_frame
    p_longer = lifetime[:, None] > lifetime[None, :]
    drop_lost = (pair & p_longer).any(dim=0)
    drop_tracked = (pair & ~p_longer).any(dim=1)
    state = torch.where(drop_lost | drop_tracked, FREE, state).to(i32)

    new_store = store.replace(
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
    if store.body_hist is not None:
        # Every slot that took a detection feature this frame appends to
        # its ring; new tracks restart at position 0.
        wrote = det_index >= 0
        is_new = wrote & (start_frame == frame)
        pos = torch.where(is_new, 0, store.hist_pos).to(i32)
        h = store.body_hist.shape[1]
        rows = torch.arange(n, device=dev)
        slot = (pos % h).long()
        body_hist = store.body_hist.clone()
        face_hist = store.face_hist.clone()
        body_hist[rows, slot] = torch.where(wrote[:, None], body_feat,
                                            store.body_hist[rows, slot])
        face_hist[rows, slot] = torch.where(wrote[:, None], face_feat,
                                            store.face_hist[rows, slot])
        new_store = new_store.replace(
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
    return new_store, outputs
