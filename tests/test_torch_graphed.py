"""The replayable frame step on the CPU: batch norm + activation as one
call (kernel K6's plain version) against Flax, the NMS fixpoint with a
fixed iteration count, a step that builds no tensor from Python values,
the one-copy readback, and the cache of captured steps.

A CUDA graph needs the card, so the cache is driven here through a
stand-in that "captures" by running the eager step and "replays" by
running it again into the same output buffers: the keying, the copies out
of the graph's buffers and the overflow re-run from the pre-step stores
are the code the card runs; only ``GraphCache._capture`` differs
(tests/test_torch_cuda.py holds the real one bit-equal to the eager step
on the card).

Tolerances: bn_act_plain against Flax in float32 rtol/atol 1e-5 (two
libraries' rsqrt and exp); in bfloat16 rtol/atol 2**-6, two units in the
last place (Flax rounds the norm once to bfloat16 as the port does, but
jax computes SiLU as x * sigmoid(x) with a bfloat16 rounding after each
factor, the port in float32 with one rounding). Everything the port is
compared with itself on is bitwise.
"""

import ast
import dataclasses
import sys
from pathlib import Path
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.ops import nms as jnms
from botsort_tpu.pipeline.host import BatchedBoTSORTPipeline as JBatched
from botsort_tpu.pipeline.host import BoTSORTPipeline as JPipeline
from botsort_tpu_torch.models import bn_act
from botsort_tpu_torch.models.common import BatchNorm
from botsort_tpu_torch.ops.boxes import iou_matrix
from botsort_tpu_torch.ops import nms as tnms
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import graphed
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.pipeline import switch
from botsort_tpu_torch.track import state as tstate
from tests.test_torch_multistream import _ids, _stream_frames
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    NMSC,
    PIPE,
    REGIMES,
    SWITCH_PIPE,
    T_NMSC,
    T_PIPE,
    T_TRK,
    TRK,
    _frames,
    _port,
    bundles,
    count_bundles,
    level_frames,
)
from tests.torch_scenes import boundary_boxes

JAX_ACTS = {"none": lambda x: x, "silu": nn.silu, "relu": nn.relu,
            "relu6": lambda x: jnp.minimum(nn.relu(x), 6.0)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: tier-1 runs several workers on
    a few cores, and a thread pool per worker makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- bn_act_plain against Flax's BatchNorm + activation -------------------


def _bn_case(rng, shape):
    c = shape[1]
    x = rng.normal(0, 2, shape).astype(np.float32)
    stats = dict(scale=rng.uniform(0.5, 1.5, c), bias=rng.normal(0, 0.3, c),
                 mean=rng.normal(0, 0.5, c), var=rng.uniform(0.3, 1.8, c))
    return x, {k: v.astype(np.float32) for k, v in stats.items()}


@pytest.mark.parametrize("act", bn_act.ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,eps", [((2, 6, 5, 7), 1e-3),
                                       ((4, 10), 1e-5)])
def test_bn_act_plain_matches_flax(shape, eps, dtype, act):
    x, st = _bn_case(np.random.default_rng(len(shape) + len(act)), shape)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    # Flax normalises the last axis: NCHW -> NHWC and back.
    to_last = (0, 2, 3, 1) if len(shape) == 4 else (0, 1)
    from_last = (0, 3, 1, 2) if len(shape) == 4 else (0, 1)
    bn = nn.BatchNorm(use_running_average=True, epsilon=eps, dtype=jdt)
    variables = {"params": {"scale": st["scale"], "bias": st["bias"]},
                 "batch_stats": {"mean": st["mean"], "var": st["var"]}}
    jx = jnp.asarray(x).astype(jdt).transpose(to_last)
    want = JAX_ACTS[act](bn.apply(variables, jx)).transpose(from_last)
    assert want.dtype == jdt

    mul = torch.rsqrt(torch.from_numpy(st["var"]) + eps) * torch.from_numpy(
        st["scale"])
    got = bn_act.bn_act(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(st["mean"]), mul,
                        torch.from_numpy(st["bias"]), act)
    assert got.dtype == tdt and tuple(got.shape) == shape
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_batchnorm_module_is_bn_act_of_its_statistics():
    """The module's forward is bn_act on its cached multiplier, equal to
    the chain it replaced bit for bit; the cache follows in-place writes,
    replaced tensors and eps. Inference modules require no grad (as
    build_bundle leaves them); one whose scale requires grad, with grad
    enabled, gets the multiplier with its graph instead (training)."""
    rng = np.random.default_rng(3)
    x, st = _bn_case(rng, (2, 6, 4, 4))
    bn = BatchNorm(6, 1e-3).eval().requires_grad_(False)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(st[key]))

    def chain(x):  # the forward before bn_act, then the activation
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = (x.float() - bn.running_mean.view(shape)) * mul.view(shape)
        return torch.nn.functional.silu((y + bn.bias.view(shape)).to(x.dtype))

    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        with torch.no_grad():
            assert torch.equal(bn(xt, "silu"), chain(xt))
    first = bn.mul()
    assert bn.mul() is first
    with torch.no_grad():
        bn.running_var.mul_(2.0)
    assert bn.mul() is not first
    with torch.no_grad():
        assert torch.equal(bn(xt, "silu"), chain(xt))
    second = bn.mul()
    bn.eps = 1e-5
    assert bn.mul() is not second
    bn.double().float()  # replaces the tensors
    with torch.no_grad():
        assert torch.equal(bn(xt, "silu"), chain(xt))
    with pytest.raises(ValueError, match="unknown activation"):
        bn(xt, "gelu")
    bn.weight.requires_grad_(True)
    assert bn.mul().requires_grad and bn.mul() is not bn.mul()
    with torch.no_grad():
        assert bn.mul() is bn.mul()


# --- the NMS fixpoint run to its end (K8's plain version) -----------------


def _fixpoint_iterations(boxes, scores, iou_threshold, score_threshold):
    """Iterations the fixpoint needs until nothing changes (the last one
    confirms it), counted outside the port."""
    order = np.argsort(-scores, kind="stable")
    b, s = torch.from_numpy(boxes[order]), scores[order]
    valid = torch.from_numpy(s > score_threshold)
    from botsort_tpu_torch.ops.boxes import iou_matrix

    iou = iou_matrix(b, b)
    rank = torch.arange(len(s))
    dom = ((iou > iou_threshold) & (rank[:, None] < rank[None, :])
           & valid[:, None] & valid[None, :])
    keep, n_iters = valid, 0
    while True:
        new = valid & ~(dom & keep[:, None]).any(dim=0)
        n_iters += 1
        if torch.equal(new, keep):
            return n_iters
        keep = new


def _chain_boxes(n):
    """n boxes in a row, each overlapping only its neighbours above the
    threshold, scores descending: greedy keeps every other one, and the
    fixpoint settles one box an iteration."""
    x = np.arange(n, dtype=np.float32) * 3.0
    boxes = np.stack([x, np.zeros(n, np.float32), x + 10.0,
                      np.full(n, 10.0, np.float32)], axis=1)
    scores = np.linspace(0.9, 0.5, n).astype(np.float32)
    return boxes, scores


def _nms_case(case):
    """(boxes [N, 4], scores [N], pre_nms_top_k) of one input kind."""
    rng = np.random.default_rng(11)
    if case in ("random", "tied"):
        tl = rng.uniform(0, 200, (100, 2))
        boxes = np.concatenate([tl, tl + rng.uniform(10, 60, (100, 2))],
                               -1).astype(np.float32)
        scores = rng.uniform(0, 1, 100).astype(np.float32)
        if case == "tied":  # equal scores and duplicated boxes
            scores = (np.round(scores * 5) / 5).astype(np.float32)
            boxes[50:] = boxes[:50]
        return boxes, scores, 128
    if case == "chain40":
        return (*_chain_boxes(40), 128)
    if case == "random1100":  # more candidates than K8 keeps in shared memory
        tl = rng.uniform(0, 600, (1300, 2))
        boxes = np.concatenate([tl, tl + rng.uniform(10, 60, (1300, 2))],
                               -1).astype(np.float32)
        return boxes, rng.uniform(0.1, 1, 1300).astype(np.float32), 1100
    return (*_chain_boxes(128), 128)  # a chain as long as P


@pytest.mark.parametrize("form", ["single", "multiclass", "batched"])
@pytest.mark.parametrize("case", ["random", "tied", "chain40", "chainP",
                                  "random1100"])
def test_nms_fixpoint_equals_jax_while_loop(case, form):
    """The port's NMS (the fixpoint run to its end, no re-run) against the
    JAX ``lax.while_loop`` NMS: kept slots exactly, boxes and scores to
    1e-4, ``converged`` set. The chains need more iterations than the 16
    the step ran before; chainP needs P. random1100: P = 1,100 of 1,300
    boxes, above the 1,024 candidates whose dominance words K8 keeps in
    shared memory, more above the score threshold than P (clipped)."""
    boxes, scores, top_k = _nms_case(case)
    iters = _fixpoint_iterations(boxes, scores, 0.5, 0.2)
    if case.startswith("chain"):
        assert iters > 16
    if case == "chainP":
        assert len(scores) == top_k and iters >= top_k
    if case == "random1100":
        assert len(scores) > top_k > tnms.SMEM_CANDIDATES
        assert (scores > 0.2).sum() > top_k and iters > 2
    if form == "single":
        valid = np.ones(len(scores), bool)
        args = (boxes, scores, valid)
        want = jnms.nms_single_class(*[jnp.asarray(a) for a in args],
                                     0.5, 0.2, 64, top_k)
        got = tnms.nms_single_class(*[torch.from_numpy(a) for a in args],
                                    0.5, 0.2, 64, top_k)
        pairs = list(zip(got[:4], want))
        assert bool(got[4])
    else:
        cls = np.stack([scores, scores[::-1].copy(), scores * 0.9], axis=1)
        kw = dict(iou_threshold=0.5, score_threshold=0.2, max_per_class=64,
                  pre_nms_top_k=top_k)
        if form == "multiclass":
            want = jnms.multiclass_nms_dense(jnp.asarray(boxes),
                                             jnp.asarray(cls), **kw)
            got = tnms.multiclass_nms_dense(torch.from_numpy(boxes),
                                            torch.from_numpy(cls), **kw)
        else:  # two frames, the second its boxes shifted and reversed
            bb = np.stack([boxes, boxes[::-1] + 7.0])
            cc = np.stack([cls, cls[::-1]])
            want = jax.vmap(lambda b, c: jnms.multiclass_nms_dense(
                b, c, **kw))(jnp.asarray(bb), jnp.asarray(cc))
            got = tnms.multiclass_nms_dense_batched(
                torch.from_numpy(bb), torch.from_numpy(cc), **kw)
        pairs = list(zip(got[:4], want))
        assert bool(got.converged.all())
    for i, (g, w) in enumerate(pairs):
        if i in (2, 3):   # valid, clipped
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:             # boxes, scores
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)
    if case == "chain40" and form == "single":
        assert int(got[2].sum()) == 20   # every other box


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.8])
def test_nms_boundary_iou_equals_jax(thr):
    """Box pairs whose float32 IoU (iou_matrix's order) is f32(thr) one ulp
    down, exactly, and one ulp up (tests/torch_scenes.py::boundary_boxes):
    the port's NMS (K8's plain version) keeps what the JAX package's
    nms_single_class and multiclass_nms_dense keep, and suppresses the
    lower-ranked box only at the ulp above (iou > thr in float32)."""
    boxes, ious = boundary_boxes(thr)
    tb = torch.from_numpy(boxes)
    np.testing.assert_array_equal(
        iou_matrix(tb, tb)[:, 0, 1].numpy(), ious)
    suppressed = ious > np.float32(thr)
    assert suppressed.tolist() == [False] * 4 + [True] * 2
    scores = np.array([0.9, 0.8], np.float32)
    args = (scores, np.ones(2, bool))
    for pair, sup in zip(boxes, suppressed):
        got = tnms.nms_single_class(
            torch.from_numpy(pair), *map(torch.from_numpy, args), thr, 0.2,
            2, 2)
        want = jnms.nms_single_class(jnp.asarray(pair),
                                     *map(jnp.asarray, args), thr, 0.2, 2,
                                     2)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert int(got[2].sum()) == (1 if sup else 2)
    # Every pair a frame of one batched call; class 1 ranks b first.
    cls = np.broadcast_to(np.array([[0.9, 0.8], [0.8, 0.9]], np.float32),
                          (len(boxes), 2, 2)).copy()
    kw = dict(iou_threshold=thr, score_threshold=0.2, max_per_class=2,
              pre_nms_top_k=2)
    want = jax.vmap(lambda b, c: jnms.multiclass_nms_dense(b, c, **kw))(
        jnp.asarray(boxes), jnp.asarray(cls))
    got = tnms.multiclass_nms_dense_batched(tb, torch.from_numpy(cls), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.valid.sum(-1).numpy(),
                                  np.where(suppressed, 1, 2)[:, None]
                                  .repeat(2, 1))


@pytest.mark.parametrize("problems,want", [
    (4, 16), (8, 16), (9, 14), (32, 4), (33, 4), (34, 3), (66, 2), (67, 1),
    (132, 1), (133, 1)])
def test_k8_cluster_size_rule(problems, want):
    """K8's cluster size on a card of 132 SMs that holds any number of
    clusters at once: the largest c <= 16 with problems x c <= 132, else
    1."""
    assert tnms.cluster_size(problems, 132, lambda c: 10 ** 6) == want


def test_k8_cluster_size_lowers_until_every_cluster_fits():
    """Where the card cannot hold every problem's cluster at once (fewer
    active clusters than problems; 0: none), the size is lowered one block
    at a time until it can, down to 1 (launched, and raising if
    refused). The H100's counts at 1024 threads: 30 clusters of 4, 39 of
    3, 7 of 16."""
    asked = []

    def h100(c):
        asked.append(c)
        return {16: 7, 4: 30, 3: 39}[c]

    assert tnms.cluster_size(32, 132, h100) == 3
    assert asked == [4, 3]
    assert tnms.cluster_size(4, 132, h100) == 16
    assert tnms.cluster_size(4, 132, lambda c: 0) == 1
    assert tnms.cluster_size(4, 132, lambda c: 0 if c > 8 else 4) == 8
    assert tnms.cluster_size(200, 132, lambda c: 0) == 1


def test_nms_fixpoint_op_and_dispatch():
    """K8's custom op on the CPU is the plain version (opcheck: schema,
    fake, dispatch); the dispatcher takes the plain version for CPU
    tensors and refuses a device without a kernel; the CUDA wrapper
    refuses CPU tensors."""
    boxes, scores = _chain_boxes(40)
    tb = torch.from_numpy(np.stack([boxes, boxes + 1.0]))
    tv = torch.from_numpy(np.stack([scores > 0.6, scores > 0.0]))
    want = tnms.nms_fixpoint_plain(tb, tv, 0.5)
    assert want.dtype == torch.bool and want.shape == tv.shape
    assert torch.equal(tnms.nms_fixpoint_op(tb, tv, 0.5), want)
    assert torch.equal(tnms.nms_fixpoint(tb, tv, 0.5), want)
    torch.library.opcheck(tnms.nms_fixpoint_op, (tb, tv, 0.5))
    # Nothing to suppress: the fixpoint is the input, returned as a copy.
    torch.library.opcheck(tnms.nms_fixpoint_op, (tb, tv, 0.99))
    with pytest.raises(ValueError, match="no kernel"):
        tnms.nms_fixpoint(tb.to("meta"), tv.to("meta"), 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tnms.nms_fixpoint_cuda(tb, tv, 0.5)


@pytest.mark.parametrize("streams", [1, 2])
def test_facade_steps_a_long_chain_scene_once_a_frame(bundles, streams):
    """A detector stand-in puts a 40-box suppression chain on every frame
    (more than the 16 iterations the step ran before, which made the
    facades re-run it in full): the facade now makes one step call a frame
    and tracks what the JAX pipeline tracks."""
    jcb, tcb = count_bundles(*bundles, scene="chain")
    if streams == 1:
        jp = JPipeline(jcb, TRK, NMSC, PIPE)
        tp = thost.BoTSORTPipeline(tcb, T_TRK, T_NMSC, T_PIPE)
    else:
        jp = JBatched(jcb, streams, TRK, NMSC, PIPE)
        tp = thost.BatchedBoTSORTPipeline(tcb, streams, T_TRK, T_NMSC,
                                          T_PIPE)
    calls = []
    real = tp._step
    tp._step = lambda *a: calls.append(a[2:4]) or real(*a)
    steps = _stream_frames(3, streams, seed=14)
    for t, frames in enumerate(steps):
        arg = frames[0] if streams == 1 else frames
        want, got = jp.update(arg), tp.update(arg)
        if streams == 1:
            want, got = [want], [got]
        assert _ids(got) == _ids(want), t
        for gs, ws in zip(got, want):
            for a, b in zip(gs, ws):
                np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0,
                                           atol=1e-3)
        res = tp.last_result
        assert bool(np.all(res.nms_converged))
        assert int(np.asarray(res.det_valid)[..., 0, :].sum()) == \
            8 * streams     # 20 kept, 8 slots
    assert len(calls) == len(steps)


@pytest.mark.parametrize("value", [0, 1, 4, 5, 8])
def test_branch_flags_and_zero_beyond(value):
    """K9's plain version sets one flag, the branch ``branch_index``
    picks (none at 0); ``zero_beyond`` keeps exactly that branch's width
    (the eager route on the card) and ``run_every_branch`` (the warm-up)
    ends in the same buffer."""
    calls = []

    def encode(tlbr):
        calls.append(tlbr.shape[1])
        return tlbr[..., :1].expand(-1, -1, 3) + 1.0

    branches = switch.bucket_branches(encode, 8, 4)
    assert [(b.lo, b.hi, b.width) for b in branches] == [
        (0, 4, 4), (4, switch.INT32_MAX, 8)]
    assert [b.width for b in switch.bucket_branches(encode, 4, 4)] == [4]
    v = torch.tensor(value, dtype=torch.int32)
    flags = switch.branch_flags_plain(v, branches)
    k = switch.branch_index(value, branches)
    assert flags.tolist() == [k == 0, k == 1]
    width = 0 if k is None else branches[k].width
    tlbr = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    out = torch.zeros(2, 8, 3)
    switch.run_every_branch(v, branches, (tlbr,), out)
    assert calls == [4, 8]
    want = torch.zeros(2, 8, 3)
    want[:, :width] = tlbr[:, :width, :1] + 1.0
    assert torch.equal(out, want)
    eager = torch.zeros(2, 8, 3)
    switch.run_eager(v, branches, (tlbr,), eager)
    assert torch.equal(eager, want)


# The stream levels of each step of the switch rehearsal.
SWITCH_STEPS = (("none", "none"), ("chunk", "none"), ("full", "chunk"),
                ("none", "chunk"), ("none", "none"))


@pytest.mark.parametrize("streams", [1, 2])
def test_switch_program_through_the_cache_equals_eager(bundles, streams):
    """``host_bucket_dispatch=False`` through the CPU stand-in of the
    segmented capture: one key (None buckets) and one capture for every
    load, the program in five pieces (work, switch, work, switch, work),
    each step equal to the eager facade (the JAX switch) bit for bit while
    the loads change, and every body branch taken across the steps."""
    _, tcb = count_bundles(*bundles)
    pipe = _port(SWITCH_PIPE)

    def make():
        if streams == 1:
            return thost.BoTSORTPipeline(tcb, T_TRK, T_NMSC, pipe)
        return thost.BatchedBoTSORTPipeline(tcb, streams, T_TRK, T_NMSC,
                                            pipe)

    eager, cached = make(), make()
    cached._graphs = cache = EagerReplayCache(torch.device("cpu"))
    taken = []
    for t, row in enumerate(SWITCH_STEPS):
        frames = np.stack(level_frames([REGIMES[r] for r in row[:streams]],
                                       seed=20 + t))
        arg = frames[0] if streams == 1 else frames
        want = eager.update(arg)
        got = cached.update(arg)
        if streams == 1:
            want, got = [want], [got]
        assert _ids(got) == _ids(want), t
        for a, b in zip(eager.last_result[:-1], cached.last_result[:-1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(eager.last_result.tracks, cached.last_result.tracks):
            np.testing.assert_array_equal(a, b)
        taken.append(tuple(tfs.switch_values(cached.last_result, T_TRK,
                                             T_NMSC, pipe)))
    kind = "frame" if streams == 1 else "batched"
    assert cache.keys() == [(kind, streams, 1, 240, 320, None, None, False)]
    assert (cache.captures, cache.replays) == (1, len(SWITCH_STEPS))
    items = cache.programs[0]
    assert [i[0] for i in items] == ["segment", "switch", "segment",
                                     "switch", "segment"]
    assert all([b.width for b in i[2]] == [4, 8] for i in items[1::2])
    assert {v[0] for v in taken} == {0, 3, 7}   # every body branch ran
    for x, y in zip(thost._store_tensors(eager.store if streams == 1
                                         else eager.stores),
                    thost._store_tensors(cached.store if streams == 1
                                         else cached.stores)):
        assert (x is None and y is None) or torch.equal(x, y)


# --- no tensor from Python values in a warm step; one-copy readback -------


def test_second_step_builds_no_tensor_from_python_values(bundles):
    """Once the constants are cached, a step calls ``torch.tensor`` nowhere
    but in the plain assignment solver (``jv_solve_plain``, the cascade's
    ``_cascade_pass``), which runs on the CPU only (on the card the cascade
    kernel takes its place)."""
    _, tb = bundles
    frames = [torch.from_numpy(f) for f in _stream_frames(2, 2, seed=9)]
    stores = tstate.empty_stores(T_TRK, 2)
    gmc = torch.eye(2, 3).expand(2, 2, 3).contiguous()
    stores, _ = tfs.frame_step_batched(tb, stores, frames[0], T_TRK, T_NMSC,
                                       T_PIPE, gmc, 4, 4)
    real = torch.tensor
    callers = []

    def counting(*args, **kwargs):
        callers.append(sys._getframe(1).f_code.co_name)
        return real(*args, **kwargs)

    with mock.patch.object(torch, "tensor", counting):
        stores, res = tfs.frame_step_batched(tb, stores, frames[1], T_TRK,
                                             T_NMSC, T_PIPE, gmc, 4, 4)
        packed = thost.pack_result(res)
    assert set(callers) <= {"jv_solve_plain", "_cascade_pass"}, \
        set(callers)
    assert int(stores.frame_count[0]) == 2 and packed.packed.dtype == \
        torch.uint8


def test_packed_readback_is_one_copy_and_loses_nothing(bundles):
    _, tb = bundles
    frames = torch.from_numpy(_stream_frames(1, 2, seed=10)[0])
    _, res = tfs.frame_step_batched(tb, tstate.empty_stores(T_TRK, 2),
                                    frames, T_TRK, T_NMSC, T_PIPE)
    packed = thost.pack_result(res)
    assert packed.packed.dim() == 1 and packed.packed.numel() % 8 == 0
    real_cpu = torch.Tensor.cpu
    copies = []
    with mock.patch.object(torch.Tensor, "cpu",
                           lambda t, *a: copies.append(1) or real_cpu(t, *a)):
        back = packed.to_host()
    assert len(copies) == 1
    for name, got, want in zip(res._fields[:-1], back[:-1], res[:-1]):
        assert got.dtype == want.numpy().dtype, name
        np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
    for name, got, want in zip(res.tracks._fields, back.tracks, res.tracks):
        np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
    same = thost.to_host(res)
    np.testing.assert_array_equal(same.det_boxes, back.det_boxes)


# --- the cache of captured steps, with a stand-in for the capture ---------


class EagerReplayCache(graphed.GraphCache):
    """GraphCache whose "graph" is the eager function itself: captured by
    running it once, replayed by running it again into the captured output
    buffers. Like a capture, the capturing run's results are not used.

    A step with a bucket switch is recorded in segments by the cache's own
    ``_capture``, as on the card; here a segment is not replayable, so a
    replay re-runs the step, and at each switch hands the replay's inputs
    and zeroed output buffer to the tensors the capture recorded (what a
    graph's fixed addresses do), runs the branch the value picks with the
    captured branch on the captured tensors only, and hands the buffer
    back: a branch that read anything but its declared inputs and the
    step's static inputs would see the capture's stale values."""

    def _begin(self):
        return None

    def _end(self, token):
        return None

    def _program(self, items, fn, static_in, outputs):
        recorded = [item for item in items if item[0] == "switch"]
        self.programs.append(items)

        def handover(value, branches, inputs, out):
            _, c_value, c_branches, _, c_inputs, c_out = recorded[
                handover.at]
            handover.at += 1
            assert len(branches) == len(c_branches)
            for dst, src in zip((c_value, *c_inputs, c_out),
                                (value, *inputs, out)):
                dst.copy_(src)
            k = switch.branch_index(int(c_value), c_branches)
            if k is not None:
                c_branches[k].run(*c_inputs, c_out)
            out.copy_(c_out)

        def replay():
            handover.at = 0
            with switch.runner(handover):
                fresh = fn(*static_in)
            assert handover.at == len(recorded)
            for dst, src in zip(outputs, fresh):
                if dst is not None:
                    dst.copy_(src)

        return replay

    def __init__(self, device):
        super().__init__(device)
        # Every captured program's items, in capture order.
        self.programs = []


def test_step_key_names_what_changes_the_program():
    """Kind, shape, buckets and affines; no NMS count (the fixpoint runs to
    its end in every program); None buckets for the in-program switch."""
    key = graphed.step_key("batched", (8, 1080, 1920, 3), 16, 16, False)
    assert key == ("batched", 8, 1, 1080, 1920, 16, 16, False)
    temporal = graphed.step_key("temporal", (8, 2, 1080, 1920, 3), 16, 0,
                                True)
    assert temporal == ("temporal", 8, 2, 1080, 1920, 16, 0, True)
    dynamic = graphed.step_key("frame", (1080, 1920, 3), None, None, False)
    assert dynamic == ("frame", 1, 1, 1080, 1920, None, None, False)
    assert len({key, temporal, dynamic,
                graphed.step_key("batched", (8, 1080, 1920, 3), 16, 16,
                                 True),
                graphed.step_key("batched", (8, 1080, 1920, 3), 0, 16,
                                 False),
                graphed.step_key("batched", (4, 1080, 1920, 3), 16, 16,
                                 False)}) == 6


def test_graph_cache_imports_no_model_or_op():
    """The cache is generic over what it captures: ``pipeline/graphed.py``
    imports nothing from the port's models or ops, which it runs."""
    tree = ast.parse(Path(graphed.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            # A relative import resolves from botsort_tpu_torch.pipeline.
            base = (["botsort_tpu_torch", "pipeline"][:3 - node.level]
                    if node.level else [])
            module = ".".join(base + ([node.module] if node.module else []))
            names.update(f"{module}.{a.name}" for a in node.names)
    assert "botsort_tpu_torch.pipeline.switch" in names
    inside = [n for n in names if n.startswith(("botsort_tpu_torch.models",
                                                "botsort_tpu_torch.ops"))]
    assert inside == [], inside


def test_cache_copies_out_and_counts_launches_per_replay():
    """Each run of a captured key launches its graph once (the stand-in's
    replay runs the step once), each replay's results are copies of the
    graph's output buffers, and keys of one input signature share the
    input buffers. The kernels a replay launches are counted on the card
    from torch.profiler (tests/test_torch_cuda.py)."""
    cache = EagerReplayCache(torch.device("cpu"))
    calls = []

    def fn(x, absent, y):
        assert absent is None
        calls.append(1)
        return [x + y, None, x * 2]

    a, b = torch.arange(4.0), torch.ones(4)
    first = cache.run("k", fn, [a, None, b])
    assert (cache.warmups, cache.captures, cache.replays) == (
        graphed.WARMUP_CALLS, 1, 1)
    # The warm-up calls, the capture and the first replay.
    assert len(calls) == graphed.WARMUP_CALLS + 2
    assert torch.equal(first[0], a + b) and first[1] is None
    second = cache.run("k", fn, [a + 10, None, b])
    assert (cache.captures, cache.replays) == (1, 2)
    assert len(calls) == graphed.WARMUP_CALLS + 3
    assert torch.equal(second[0], a + 11) and torch.equal(second[2],
                                                          (a + 10) * 2)
    # The first call's results are copies: the second replay wrote the
    # graph's own buffers, not them.
    assert torch.equal(first[0], a + b) and torch.equal(first[2], a * 2)
    entry = cache._entries["k"]
    assert all(o is None or o.data_ptr() != e.data_ptr()
               for o, e in zip(second, entry.outputs))
    # Another key with the same input signature shares the input buffers.
    cache.run("other", fn, [a, None, b])
    assert len(cache._inputs) == 1 and cache.keys() == ["k", "other"]
    cache.run("wider", lambda x: [x], [torch.zeros(5)])
    assert len(cache._inputs) == 2


@pytest.mark.parametrize("streams", [1, 2])
def test_facade_through_the_cache_equals_eager(bundles, streams):
    """The facades over a cache (the stand-in) against the eager facades:
    equal results and stores over bucket changes and a forced overflow
    re-run, one key per (buckets) pair, the pre-step stores untouched by
    the step that replaced them."""
    _, tb = bundles

    def make():
        if streams == 1:
            return thost.BoTSORTPipeline(tb, T_TRK, T_NMSC, T_PIPE)
        return thost.BatchedBoTSORTPipeline(tb, streams, T_TRK, T_NMSC,
                                            T_PIPE)

    eager, cached = make(), make()
    assert eager._graphs is None  # the CPU runs eagerly by default
    cached._graphs = cache = EagerReplayCache(torch.device("cpu"))
    store_of = (lambda p: p.store) if streams == 1 else (lambda p: p.stores)
    runs = []
    real = cached._step
    cached._step = lambda *a: runs.append(a[2:4]) or real(*a)
    for t, frames in enumerate(_stream_frames(5, streams, seed=12)):
        arg = frames[0] if streams == 1 else frames
        if t == 2:  # forget the counts: bucket 0, then the overflow re-run
            for p in (eager, cached):
                if streams == 1:
                    p._last_n_live, p._last_n_face = 0, 0
                else:
                    p._last_max_live, p._last_max_face = 0, 0
        before = store_of(cached)
        snapshot = [None if x is None else x.clone()
                    for x in thost._store_tensors(before)]
        want, got = eager.update(arg), cached.update(arg)
        if streams == 1:
            want, got = [want], [got]
        assert _ids(got) == _ids(want), t
        for a, b in zip(eager.last_result[:-1], cached.last_result[:-1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(eager.last_result.tracks, cached.last_result.tracks):
            np.testing.assert_array_equal(a, b)
        for x, y in zip(thost._store_tensors(before), snapshot):
            assert (x is None and y is None) or torch.equal(x, y)
        for x, y in zip(thost._store_tensors(store_of(eager)),
                        thost._store_tensors(store_of(cached))):
            assert (x is None and y is None) or torch.equal(x, y)
    assert (0, 0) in runs and len(runs) > 5          # the overflow re-run
    assert len(set(runs)) >= 2                        # a bucket change
    kind = "frame" if streams == 1 else "batched"
    assert sorted(cache.keys()) == sorted(
        (kind, streams, 1, 240, 320, rb, fb, False)
        for rb, fb in set(runs))
    assert cache.captures == len(set(runs)) and cache.replays == len(runs)
    assert len(cache._inputs) == 1  # every key shares the input buffers


def test_graphs_argument_and_dispatch_override(bundles):
    """graphs=True asks for a CUDA graph only on a CUDA device; the
    single-stream facade's ``_dispatch`` is the override point for another
    way of running a step."""
    _, tb = bundles
    assert thost.BoTSORTPipeline(tb, T_TRK, T_NMSC, T_PIPE,
                                 graphs=True)._graphs is None

    class Counting(thost.BoTSORTPipeline):
        dispatched = 0

        def _dispatch(self, *args):
            self.dispatched += 1
            return super()._dispatch(*args)

    pipe = Counting(tb, T_TRK, T_NMSC, T_PIPE)
    plain = thost.BoTSORTPipeline(tb, T_TRK, T_NMSC, T_PIPE)
    for frame in _frames(2, seed=13):
        assert _ids([pipe.update(frame)]) == _ids([plain.update(frame)])
    assert pipe.dispatched >= 2
    profiled = thost.BoTSORTPipeline(tb, T_TRK, T_NMSC,
                                     dataclasses.replace(T_PIPE),
                                     trace=True)
    assert profiled.timers.tracing and profiled.timers.export() == {
        "spans": [], "stages": [],
        "body_encoder": []}  # nothing traced before an update
