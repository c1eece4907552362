"""CLEAR-MOT (MOTA/MOTP) and IDF1 computation over MOT-format traces
(the port's own copy of botsort_tpu/eval/mot_metrics.py, numpy and scipy
only, so that it runs where the JAX package is not installed).

Feed it two traces (ours + ground truth, or ours + a reference-captured
trace) in the MOT challenge CSV format written by cli/eval_trace.py:
``frame,id,x,y,w,h,score,class,visibility``.

Implementation follows the standard definitions:
- CLEAR-MOT (Bernardin & Stiefelhagen): per-frame Hungarian matching
  with an IoU>=0.5 gate, carrying matches across frames before
  re-matching; MOTA = 1 - (FN + FP + IDSW) / GT.
- IDF1 (Ristani et al.): global bipartite matching between trajectory
  identities maximizing overlap, IDF1 = 2*IDTP / (2*IDTP + IDFP + IDFN).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def load_trace(path: str) -> Dict[int, List[Tuple[int, np.ndarray]]]:
    """MOT CSV -> {frame: [(track_id, tlwh), ...]}."""
    frames: Dict[int, List[Tuple[int, np.ndarray]]] = (
        collections.defaultdict(list))
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            frame, tid = int(float(parts[0])), int(float(parts[1]))
            box = np.array([float(v) for v in parts[2:6]])
            frames[frame].append((tid, box))
    return dict(frames)


def _iou(a_tlwh: np.ndarray, b_tlwh: np.ndarray) -> float:
    ax1, ay1 = a_tlwh[0], a_tlwh[1]
    ax2, ay2 = ax1 + a_tlwh[2], ay1 + a_tlwh[3]
    bx1, by1 = b_tlwh[0], b_tlwh[1]
    bx2, by2 = bx1 + b_tlwh[2], by1 + b_tlwh[3]
    ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    iy = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = ix * iy
    union = a_tlwh[2] * a_tlwh[3] + b_tlwh[2] * b_tlwh[3] - inter
    return inter / union if union > 0 else 0.0


def clear_mot(gt: Dict[int, list], hyp: Dict[int, list],
              iou_threshold: float = 0.5) -> Dict[str, float]:
    """MOTA / MOTP / FP / FN / IDSW over two traces."""
    n_gt = n_fp = n_fn = n_idsw = 0
    dist_sum = 0.0
    n_matches = 0
    last_match: Dict[int, int] = {}  # gt id -> hyp id

    all_frames = sorted(set(gt) | set(hyp))
    for f in all_frames:
        g = gt.get(f, [])
        h = hyp.get(f, [])
        n_gt += len(g)
        if not g or not h:
            n_fn += len(g)
            n_fp += len(h)
            continue
        iou = np.array([[_iou(gb, hb) for _, hb in h] for _, gb in g])
        # Prefer carrying the previous assignment (CLEAR-MOT rule):
        # give persisting pairs a bonus above any pure-IoU swap.
        bonus = np.array([
            [1.0 if last_match.get(g[i][0]) == h[j][0] else 0.0
             for j in range(len(h))] for i in range(len(g))])
        score = np.where(iou >= iou_threshold, iou + bonus, -1.0)
        rows, cols = linear_sum_assignment(-score)
        matched_g, matched_h = set(), set()
        for r, c in zip(rows, cols):
            if score[r, c] < 0:
                continue
            gid, hid = g[r][0], h[c][0]
            if gid in last_match and last_match[gid] != hid:
                n_idsw += 1
            last_match[gid] = hid
            matched_g.add(r)
            matched_h.add(c)
            dist_sum += iou[r, c]
            n_matches += 1
        n_fn += len(g) - len(matched_g)
        n_fp += len(h) - len(matched_h)

    mota = 1.0 - (n_fn + n_fp + n_idsw) / max(n_gt, 1)
    motp = dist_sum / max(n_matches, 1)
    return {"MOTA": mota, "MOTP": motp, "FP": n_fp, "FN": n_fn,
            "IDSW": n_idsw, "GT": n_gt}


def idf1(gt: Dict[int, list], hyp: Dict[int, list],
         iou_threshold: float = 0.5) -> Dict[str, float]:
    """Identity F1 via global trajectory matching."""
    # Count per-frame spatial matches for every (gt id, hyp id) pair.
    pair_overlap: Dict[Tuple[int, int], int] = collections.defaultdict(int)
    gt_len: Dict[int, int] = collections.defaultdict(int)
    hyp_len: Dict[int, int] = collections.defaultdict(int)
    for f in sorted(set(gt) | set(hyp)):
        g = gt.get(f, [])
        h = hyp.get(f, [])
        for gid, _ in g:
            gt_len[gid] += 1
        for hid, _ in h:
            hyp_len[hid] += 1
        for gid, gb in g:
            for hid, hb in h:
                if _iou(gb, hb) >= iou_threshold:
                    pair_overlap[(gid, hid)] += 1

    gids = sorted(gt_len)
    hids = sorted(hyp_len)
    if not gids or not hids:
        return {"IDF1": 0.0, "IDTP": 0, "IDFP": sum(hyp_len.values()),
                "IDFN": sum(gt_len.values())}
    overlap = np.zeros((len(gids), len(hids)))
    for (gid, hid), c in pair_overlap.items():
        overlap[gids.index(gid), hids.index(hid)] = c
    rows, cols = linear_sum_assignment(-overlap)
    idtp = int(sum(overlap[r, c] for r, c in zip(rows, cols)))
    idfn = sum(gt_len.values()) - idtp
    idfp = sum(hyp_len.values()) - idtp
    f1 = 2 * idtp / max(2 * idtp + idfp + idfn, 1)
    return {"IDF1": f1, "IDTP": idtp, "IDFP": idfp, "IDFN": idfn}


def evaluate(gt_path: str, hyp_path: str,
             iou_threshold: float = 0.5) -> Dict[str, float]:
    gt = load_trace(gt_path)
    hyp = load_trace(hyp_path)
    out = clear_mot(gt, hyp, iou_threshold)
    out.update(idf1(gt, hyp, iou_threshold))
    return out
