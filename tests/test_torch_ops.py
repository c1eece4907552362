"""The port's box, Kalman, crop, NMS and hierarchy ops against the JAX
package's, on the same numpy-seeded inputs.

Tolerances: boxes and the Kalman filter within atol 1e-5 (the same
float32 formulas, evaluated by two libraries); crops within atol 1e-3 of
JAX's one-hot-matmul form (the port lerps two taps where JAX sums two
weighted taps, so the float32 rounding differs) and within 0.5 of
cv2.resize; NMS and hierarchy slots, validity and indices exact, boxes
and scores within 1e-4.
"""

import numpy as np
import cv2
import jax
import jax.numpy as jnp
import pytest
import torch

from botsort_tpu.ops import boxes as jboxes
from botsort_tpu.ops import crop as jcrop
from botsort_tpu.ops import hierarchy as jhier
from botsort_tpu.ops import kalman as jkalman
from botsort_tpu.ops import nms as jnms
from botsort_tpu_torch.ops import boxes as tboxes
from botsort_tpu_torch.ops import crop as tcrop
from botsort_tpu_torch.ops import hierarchy as thier
from botsort_tpu_torch.ops import kalman as tkalman
from botsort_tpu_torch.ops import nms as tnms


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _same(got, want, atol):
    if isinstance(got, torch.Tensor):
        got = (got,)
        want = (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


def _boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(0, scale / 3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["tlwh_to_tlbr", "tlbr_to_tlwh",
                                  "tlwh_to_xywh", "xywh_to_tlwh",
                                  "xywh_to_tlbr"])
def test_box_conversions(name):
    x = _boxes(np.random.default_rng(0), 9)
    _same(getattr(tboxes, name)(*_t(x)), getattr(jboxes, name)(*_j(x)),
          1e-5)


@pytest.mark.parametrize("name", ["iou_matrix", "iou_distance"])
def test_iou(name):
    rng = np.random.default_rng(1)
    a = _boxes(rng, 12)
    b = np.concatenate([_boxes(rng, 7), a[:2], np.zeros((2, 4),
                                                        np.float32)])
    b[0] = [a[3, 2], a[3, 1], a[3, 2] + 5, a[3, 3]]  # touching: IoU 0
    _same(getattr(tboxes, name)(*_t(a, b)),
          getattr(jboxes, name)(*_j(a, b)), 1e-5)


def _kf_state(rng, n):
    # Coordinates below 64 px keep one float32 ulp (<= 3.8e-6) inside the
    # 1e-5 tolerance, whichever library rounds which way.
    meas = np.concatenate([rng.uniform(10, 60, (n, 2)),
                           rng.uniform(4, 30, (n, 2))], -1)
    mean = np.concatenate([meas, rng.normal(0, 2, (n, 4))], -1)
    cov = np.stack([rng.uniform(1, 20, (n, 4)), rng.normal(0, 1, (n, 4)),
                    rng.uniform(0.5, 5, (n, 4))], -1)
    return (meas.astype(np.float32), mean.astype(np.float32),
            cov.astype(np.float32))


@pytest.mark.parametrize("name", ["initiate", "predict", "project",
                                  "update", "gating_distance",
                                  "apply_affine"])
def test_kalman(name):
    rng = np.random.default_rng(2)
    meas, mean, cov = _kf_state(rng, 11)
    if name == "initiate":
        args = (meas,)
    elif name in ("predict", "project"):
        args = (mean, cov)
    elif name == "update":
        args = (mean, cov, meas + rng.normal(0, 3, meas.shape).astype(
            np.float32))
    elif name == "gating_distance":
        args = (mean[0], cov[0], meas)
    else:
        th = 0.02
        aff = np.array([[1.01 * np.cos(th), -np.sin(th), 4.0],
                        [np.sin(th), 1.01 * np.cos(th), -2.0]], np.float32)
        args = (mean, cov, aff)
    want = getattr(jkalman, name)(*_j(*args))
    got = getattr(tkalman, name)(*_t(*args))
    _same(got, want, 1e-5)


def _crop_boxes(rng, n, h, w):
    out = []
    for _ in range(n):
        x1, y1 = rng.integers(0, w - 2), rng.integers(0, h - 2)
        out.append([x1, y1, rng.integers(x1 + 1, w + 1),
                    rng.integers(y1 + 1, h + 1)])
    out.append([5, 5, 5, 30])    # zero width: zeros
    out.append([0, 0, w, h])     # the whole frame
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("out_hw", [(64, 32), (32, 32), (96, 128)])
def test_crop_matches_jax(out_hw):
    """Against the JAX crop jitted, as the JAX steps run it: XLA computes
    the sample grid with a reciprocal and an FMA, which the port follows,
    and op-by-op JAX without them (one unit of the last place apart in a
    sample position, up to about 2e-3 intensity apart here)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    boxes = _crop_boxes(rng, 9, 120, 160)
    want = jax.jit(lambda i, b: jcrop.crop_and_resize(i, b, out_hw))(
        jnp.asarray(img), jnp.asarray(boxes))
    got = tcrop.crop_and_resize(*_t(img, boxes), out_hw)
    assert got.shape == (len(boxes),) + out_hw + (3,)
    _same(got, want, 1e-3)


def test_crop_matches_cv2():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (120, 160, 3)).astype(np.float32)
    boxes = np.array([[10, 20, 74, 100], [0, 0, 160, 120],
                      [50, 30, 58, 46]], np.float32)
    got = tcrop.crop_and_resize(*_t(img, boxes), (64, 32)).numpy()
    for i, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
        ref = cv2.resize(img[y1:y2, x1:x2], (32, 64),
                         interpolation=cv2.INTER_LINEAR)
        assert np.abs(got[i] - ref).max() < 0.5, i


def _nms_inputs(seed, ties):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, 300, 200.0)
    boxes[150:200] = boxes[100:150] + rng.uniform(-2, 2, (50, 4)).astype(
        np.float32)  # heavy overlap
    scores = rng.uniform(0, 1, (300, 4)).astype(np.float32)
    if ties:
        scores = np.round(scores * 10) / 10
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("seed,ties,top_k",
                         [(5, False, 512), (6, True, 512), (7, True, 64)])
def test_multiclass_nms_dense_matches_jax(seed, ties, top_k):
    boxes, scores = _nms_inputs(seed, ties)
    kw = dict(iou_threshold=0.5, score_threshold=0.15, max_per_class=50,
              pre_nms_top_k=top_k)
    want = jnms.multiclass_nms_dense(*_j(boxes, scores), **kw)
    got = tnms.multiclass_nms_dense(*_t(boxes, scores), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.clipped.numpy(),
                                  np.asarray(want.clipped))
    _same((got.boxes, got.scores), (want.boxes, want.scores), 1e-4)


def test_nms_single_class_matches_jax():
    boxes, scores = _nms_inputs(8, True)
    valid = np.random.default_rng(8).uniform(0, 1, 300) < 0.8
    args = (boxes, scores[:, 0], valid)
    want = jnms.nms_single_class(*_j(*args), 0.6, 0.2, 20, 128)
    got = tnms.nms_single_class(*_t(*args), 0.6, 0.2, 20, 128)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[3]) == bool(want[3])
    _same(got[:2], want[:2], 1e-4)


def _hier_problem(rng, nb, nt):
    base = _boxes(rng, nb, 120.0)
    target = base[rng.integers(0, nb, nt)] + rng.uniform(
        -8, 8, (nt, 4)).astype(np.float32)
    target[::4] = target[1::4][:len(target[::4])]  # IoU ties
    return (base, rng.uniform(0, 1, nb) < 0.85, target,
            rng.uniform(0, 1, nt) < 0.85)


@pytest.mark.parametrize("rounds", [1, 2])
def test_greedy_assign_matches_jax(rounds):
    prob = _hier_problem(np.random.default_rng(9 + rounds), 12, 12)
    want = jhier.greedy_assign(*_j(*prob), rounds=rounds)
    got = thier.greedy_assign(*_t(*prob), rounds=rounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_greedy_assign_batch_matches_jax():
    rng = np.random.default_rng(12)
    probs = [_hier_problem(rng, 10, 10) for _ in range(3)]
    rounds = (1, 1, 2)
    want = jhier.greedy_assign_batch(
        [tuple(_j(*p)) + (r,) for p, r in zip(probs, rounds)])
    got = thier.greedy_assign_batch(
        [tuple(_t(*p)) + (r,) for p, r in zip(probs, rounds)])
    for gp, wp in zip(got, want):
        assert len(gp) == len(wp)
        for g, w in zip(gp, wp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
