"""The reference's NMS, assignment and Kalman pieces on small hand-made
cases."""

import itertools

import numpy as np
import pytest
import torch

from portbench.reference import ops, tracker


def t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


def test_nms_keeps_the_best_of_an_overlapping_pair_and_a_distant_box():
    boxes = t([[[0, 0, 10, 10], [1, 0, 11, 10], [50, 50, 60, 60],
                [0, 0, 10, 10.5]]])
    scores = t([[[0.9], [0.8], [0.7], [0.95]]])
    det = ops.multiclass_nms_dense_batched(boxes, scores, 0.8, 0.15, 3, 8)
    # Box 3 (0.95) suppresses box 0 (IoU 0.95); box 1 overlaps box 3 at
    # 9 x 10 / (10 x 10.5 + 10 x 10 - 90) = 0.78 < 0.8 and survives.
    assert det.valid[0, 0].tolist() == [True, True, True]
    assert det.scores[0, 0].tolist() == pytest.approx([0.95, 0.8, 0.7])
    assert det.boxes[0, 0, 0].tolist() == [0, 0, 10, 10.5]


def test_nms_fixpoint_is_the_greedy_chain():
    """A chain a > b > c where a suppresses b and b would suppress c: the
    greedy answer keeps a and c."""
    boxes = t([[0, 0, 10, 10], [0, 0, 10, 11], [0, 0, 10, 12.2]])
    keep = ops.nms_fixpoint_plain(boxes, torch.ones(3, dtype=torch.bool),
                                  0.85)
    assert ops.iou_matrix(boxes, boxes)[0, 2] < 0.85
    assert keep.tolist() == [True, False, True]


def test_nms_below_the_score_threshold_and_the_slot_limit():
    boxes = t([[[i * 20, 0, i * 20 + 10, 10] for i in range(5)]])
    scores = t([[[0.1], [0.5], [0.6], [0.7], [0.2]]])
    det = ops.multiclass_nms_dense_batched(boxes, scores, 0.5, 0.15, 3, 8)
    assert det.scores[0, 0].tolist() == pytest.approx([0.7, 0.6, 0.5])
    assert not bool(det.clipped[0, 0])


def brute_force(cost, limit):
    """The least-cost matching of the lap.lapjv extended problem: pairs
    above the limit are never taken, every unmatched row and column pays
    limit / 2."""
    n, m = cost.shape
    best, best_pairs = None, None
    for k in range(min(n, m) + 1):
        for rows in itertools.combinations(range(n), k):
            for cols in itertools.permutations(range(m), k):
                if any(cost[r, c] > limit for r, c in zip(rows, cols)):
                    continue
                total = sum(cost[r, c] for r, c in zip(rows, cols)) + \
                    (n + m - 2 * k) * limit / 2
                if best is None or total < best - 1e-9:
                    best, best_pairs = total, dict(zip(rows, cols))
    return best, best_pairs


@pytest.mark.parametrize("seed", range(6))
def test_assignment_is_optimal_under_the_limit(seed):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, (4, 5)).astype(np.float32)
    limit = 0.6
    masks = torch.ones(3 * 4 + 3 * 5, dtype=torch.int32)
    costs = torch.from_numpy(np.stack([cost] * 3))[None]
    cfr, _ = tracker.cascade_solve_plain(
        costs, masks[None], t([10.0]), (limit, limit, limit))
    got = {r: int(c) for r, c in enumerate(cfr[0, 0]) if c >= 0}
    total = sum(cost[r, c] for r, c in got.items()) + \
        (4 + 5 - 2 * len(got)) * limit / 2
    want, _ = brute_force(cost.astype(np.float64), limit)
    assert total == pytest.approx(want, abs=1e-5)
    assert all(cost[r, c] <= limit for r, c in got.items())


def test_kalman_initiate_predict_update_by_hand():
    z = t([[100.0, 200.0, 40.0, 80.0]])
    mean, cov = tracker.initiate(z)
    assert mean.tolist() == [[100, 200, 40, 80, 0, 0, 0, 0]]
    # std_p = 2 / 20 x (w, h, w, h) = (4, 8, 4, 8); std_v = 10 / 160 x it.
    assert cov[0, :, 0].tolist() == pytest.approx([16, 64, 16, 64])
    assert cov[0, :, 2].tolist() == pytest.approx(
        [(40 / 16) ** 2, (80 / 16) ** 2, (40 / 16) ** 2, (80 / 16) ** 2])
    mean = t([[100.0, 200.0, 40.0, 80.0, 2.0, -1.0, 0.0, 0.0]])
    m2, c2 = tracker.predict(mean, cov)
    assert m2[0, :4].tolist() == [102, 199, 40, 80]
    a, b, c = cov[0, 0]
    assert c2[0, 0].tolist() == pytest.approx(
        [a + 2 * b + c + 4.0, b + c, c + (40 / 160) ** 2])
    # A measurement equal to the prediction leaves the position alone and
    # shrinks its variance: a+ = a - a^2 / (a + r).
    m3, c3 = tracker.update(m2, c2, m2[:, :4])
    assert m3[0, :4].tolist() == pytest.approx(m2[0, :4].tolist())
    r = (40 / 20) ** 2
    a2 = float(c2[0, 0, 0])
    assert float(c3[0, 0, 0]) == pytest.approx(a2 - a2 * a2 / (a2 + r))


def test_tracker_starts_tracks_then_keeps_their_ids():
    class Cfg:
        track_high_thresh, track_low_thresh, new_track_thresh = 0.5, 0.1, 0.6
        match_thresh, second_match_thresh = 0.8, 0.5
        unconfirmed_match_thresh = 0.7
        proximity_thresh, appearance_thresh = 0.5, 0.25
        feature_ema_alpha, max_time_lost, max_tracks = 0.9, 30, 8
        body_feature_dim, face_feature_dim, feature_history = 4, 4, 0
    cfg = Cfg()
    store = tracker.empty_stores(cfg, 1)
    boxes = t([[[10, 10, 50, 90], [200, 10, 240, 90], [0, 0, 0, 0]]])
    scores = t([[0.9, 0.8, 0.0]])
    valid = t([[True, True, False]], torch.bool)
    feats = torch.nn.functional.normalize(torch.eye(4)[None, :3], dim=-1)
    store, out = tracker.tracker_update_batched(store, boxes, scores, valid,
                                                feats, feats, cfg)
    assert out.valid[0].sum() == 2 and sorted(
        out.track_id[0][out.valid[0]].tolist()) == [1, 2]
    store, out = tracker.tracker_update_batched(store, boxes + 2.0, scores,
                                                valid, feats, feats, cfg)
    by_det = {int(d): int(i) for d, i, v in zip(
        out.det_index[0], out.track_id[0], out.valid[0]) if v}
    assert by_det == {0: 1, 1: 2}
