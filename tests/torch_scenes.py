"""Synthetic detector scenes for the port's tests, in PyTorch and numpy
only (tests/test_torch_cuda.py runs where there is no JAX; the JAX
stand-in is tests/test_torch_pipeline.py::JaxCountDetector).

A detector stand-in makes the live count a function of the frame: eight
bodies on a 4 x 2 grid of the 96 x 128 detector input, a head in each, a
face in the even ones' heads; the first floor(mean / 20) bodies (mean of
the input's first channel) score 0.9, the others 0.001 (below the score
threshold). The real MINI encoders embed real crops of the noise frames.
With max_reid_batch 4 and 8 body slots the in-program bucket switch has
three branches: no crop (0 live), 4 slots (1..4 live) and 8 (5..8).
"""

import numpy as np
import torch

SRC_HW = (240, 320)
# Frame brightness per regime -> 0, 3 and 7 live bodies (2 and 4 faces).
REGIMES = {"none": 10, "chunk": 70, "full": 150}
LIVE = {"none": 0, "chunk": 3, "full": 7}
WIDTH = {"none": 0, "chunk": 4, "full": 8}   # slots the taken branch fills


def count_scene():
    """(anchor boxes [24, 4] in detector-input pixels, class scores
    [24, 4] before the bodies' own are set)."""
    bodies, heads, faces = [], [], []
    for i in range(8):
        x0, y0 = 32 * (i % 4), 48 * (i // 4)
        bodies.append((x0 + 2, y0 + 2, x0 + 30, y0 + 46))
        heads.append((x0 + 8, y0 + 3, x0 + 24, y0 + 15))
        faces.append((x0 + 11, y0 + 5, x0 + 21, y0 + 13))
    boxes = np.asarray(bodies + heads + faces, np.float32)
    scores = np.full((24, 4), 0.001, np.float32)
    scores[8:16, 1] = 0.8
    scores[16:24:2, 3] = 0.7
    return boxes, scores


def chain_scene(n=40):
    """(boxes [n, 4], class scores [n, 4]): n bodies in a row, each
    overlapping its neighbours at IoU 0.885 and the next ones at 0.782 (the
    NMS threshold is 0.8), scores descending: a suppression chain of n
    boxes, which the fixpoint settles one box an iteration."""
    x = np.arange(n, dtype=np.float32) * 2.2
    boxes = np.stack([x, np.full(n, 20.0, np.float32), x + 36.0,
                      np.full(n, 76.0, np.float32)], axis=1)
    scores = np.full((n, 4), 0.001, np.float32)
    scores[:, 0] = np.linspace(0.9, 0.5, n)
    return boxes, scores


class TorchCountDetector(torch.nn.Module):
    """The stand-in for the port's YOLOX (``scene="chain"``: ``chain_scene``
    on every frame); its constants are buffers, so that a step can be
    captured in a CUDA graph."""

    def __init__(self, scene="count"):
        super().__init__()
        self.scene = scene
        boxes, scores = chain_scene() if scene == "chain" else count_scene()
        self.register_buffer("boxes", torch.from_numpy(boxes))
        self.register_buffer("scores", torch.from_numpy(scores))
        # ModelBundle.device reads the detector's first parameter.
        self.anchor = torch.nn.Parameter(torch.zeros(1), requires_grad=False)

    def forward(self, x):
        b = x.shape[0]
        if self.scene == "chain":
            return (self.boxes.expand(b, -1, -1),
                    self.scores.expand(b, -1, -1))
        n_on = torch.floor(x[..., 0].mean(dim=(1, 2)) / 20.0)
        on = torch.arange(8, device=x.device)[None, :] < n_on[:, None]
        s = self.scores.expand(b, -1, -1).clone()
        s[:, :8, 0] = torch.where(on, 0.9, 0.001)
        return self.boxes.expand(b, -1, -1), s


def level_frames(levels, seed=0):
    """One noise frame a level (SRC_HW, values within 8 of the level)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(v - 8, v + 9, SRC_HW + (3,)).astype(np.uint8)
            for v in levels]


def _iou_f32(a, b):
    """ops/boxes.py::iou_matrix for row-aligned box pairs in numpy float32,
    in its order of operations."""
    w = np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0])
    h = np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1])
    inter = w * h
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    denom = area_a + area_b - inter
    iou = inter / np.maximum(denom, np.float32(1e-12))
    return np.where((w > 0) & (h > 0) & (denom > 0), iou, np.float32(0))


def boundary_boxes(thr, pairs=2, seed=0):
    """Box pairs at the suppression threshold: for each IoU target
    f32(thr) one ulp down, f32(thr) and one ulp up (in that order),
    ``pairs`` pairs (a, b) whose float32 IoU in iou_matrix's order is the
    target exactly. Box b = [0, 0, wb, hb] lies inside a = [0, 0, wa, ha]
    (integer sides, wb a float32 near target * wa * ha / hb). Returns
    (boxes [3 * pairs, 2, 4] float32, one pair a problem with a ranked
    first; IoU targets [3 * pairs]): greedy NMS keeps b unless its IoU
    with a is above f32(thr), i.e. only at the ulp above. A seeded search:
    random sides, then the float32 neighbours of wb, 256 ulps each way."""
    rng = np.random.default_rng(seed)
    t = np.float32(thr)
    targets = [np.nextafter(t, np.float32(-np.inf)), t,
               np.nextafter(t, np.float32(np.inf))]
    steps = np.arange(-256, 257, dtype=np.int32)
    out, ious = [], []
    for target in targets:
        found = 0
        while found < pairs:
            wa, ha = (int(x) for x in rng.integers(64, 2048, 2))
            hb = int(rng.integers(int(np.ceil(float(target) * ha)), ha + 1))
            wb0 = np.float32(float(target) * wa * ha / hb)
            wb = (wb0.view(np.int32) + steps).view(np.float32)
            wb = wb[(wb > 0) & (wb <= wa)]
            n = len(wb)
            a = np.tile(np.array([0, 0, wa, ha], np.float32), (n, 1))
            b = np.stack([np.zeros(n, np.float32), np.zeros(n, np.float32),
                          wb, np.full(n, hb, np.float32)], 1)
            hit = np.flatnonzero(_iou_f32(a, b) == target)
            if len(hit):
                out.append(np.stack([a[hit[0]], b[hit[0]]]))
                ious.append(target)
                found += 1
    return np.stack(out), np.asarray(ious, np.float32)


# The hierarchy's rounds pattern: each frame's faces -> heads and heads ->
# bodies claim once, hands -> bodies twice (pipeline/frame_step.py).
HIER_ROUNDS = (1, 1, 2)
HIER_KINDS = ("random", "dupes", "grid", "invalid")


def hierarchy_case(rng, problems, n_bases, n_targets, kind,
                   pattern=HIER_ROUNDS):
    """Greedy-hierarchy problems in numpy: (base [P, B, 4], base_valid
    [P, B], target [P, T, 4], target_valid [P, T], rounds [P]) with rounds
    ``pattern`` (the step's (1, 1, 2)) repeated. Kinds: "random" (targets
    jittered copies of bases, 15% invalid); "dupes" (every second target
    and base a copy of the one before: IoU and distance ties between
    them); "grid" (corners on an 8-pixel grid, sides 16, 24 or 32: exact
    IoU and distance ties everywhere); "invalid" (60% invalid, every third
    problem without a valid base or target, one with valid bases and no
    valid target)."""
    if kind == "grid":
        tl = rng.integers(0, 12, (problems, n_bases + n_targets, 2)) * 8.0
        wh = rng.choice([16.0, 24.0, 32.0], (problems, n_bases + n_targets,
                                             2))
        boxes = np.concatenate([tl, tl + wh], -1).astype(np.float32)
        base, target = boxes[:, :n_bases], boxes[:, n_bases:]
    else:
        tl = rng.uniform(0, 300, (problems, n_bases, 2))
        base = np.concatenate([tl, tl + rng.uniform(20, 80, tl.shape)],
                              -1).astype(np.float32)
        pick = rng.integers(0, n_bases, (problems, n_targets))
        target = (np.take_along_axis(base, pick[..., None], 1)
                  + rng.uniform(-10, 10, (problems, n_targets, 4))
                  ).astype(np.float32)
    if kind == "dupes":
        base[:, 1::2] = base[:, 0::2][:, :n_bases // 2]
        target[:, 1::2] = target[:, 0::2][:, :n_targets // 2]
    p_valid = 0.4 if kind == "invalid" else 0.85
    base_valid = rng.uniform(0, 1, (problems, n_bases)) < p_valid
    target_valid = rng.uniform(0, 1, (problems, n_targets)) < p_valid
    if kind == "invalid":
        base_valid[::3] = False
        target_valid[::3] = False
        if problems > 1:
            base_valid[1] = True
            target_valid[1] = False
    rounds = tuple(pattern[i % len(pattern)] for i in range(problems))
    return base, base_valid, target, target_valid, rounds


def hierarchy_problems(case, to_tensor):
    """``hierarchy_case``'s arrays as ``greedy_assign_batch``'s problem
    list, each array through ``to_tensor``."""
    base, base_valid, target, target_valid, rounds = case
    return [(to_tensor(base[i]), to_tensor(base_valid[i]),
             to_tensor(target[i]), to_tensor(target_valid[i]), r)
            for i, r in enumerate(rounds)]
