"""The replayable frame step on the CPU: batch norm + activation as one
call (kernel K6's plain version) against Flax, the NMS fixpoint with a
fixed iteration count, a step that builds no tensor from Python values,
the one-copy readback, and the cache of captured steps.

A CUDA graph needs the card, so the cache is driven here through a
stand-in that "captures" by running the eager step and "replays" by
running it again into the same output buffers: the keying, the copies out
of the graph's buffers, the launch-count bookkeeping and the overflow
re-run from the pre-step stores are the code the card runs; only
``GraphCache._capture`` differs (tests/test_torch_cuda.py holds the real
one bit-equal to the eager step on the card).

Tolerances: bn_act_plain against Flax in float32 rtol/atol 1e-5 (two
libraries' rsqrt and exp); in bfloat16 rtol/atol 2**-6, two units in the
last place (Flax rounds the norm once to bfloat16 as the port does, but
jax computes SiLU as x * sigmoid(x) with a bfloat16 rounding after each
factor, the port in float32 with one rounding). Everything the port is
compared with itself on is bitwise.
"""

import dataclasses
import sys
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botsort_tpu.ops import nms as jnms
from botsort_tpu_torch.models import bn_act
from botsort_tpu_torch.models.common import BatchNorm
from botsort_tpu_torch.ops import assignment_cuda
from botsort_tpu_torch.ops import nms as tnms
from botsort_tpu_torch.pipeline import frame_step as tfs
from botsort_tpu_torch.pipeline import graphed
from botsort_tpu_torch.pipeline import host as thost
from botsort_tpu_torch.track import state as tstate
from tests.test_torch_multistream import _ids, _stream_frames
from tests.test_torch_pipeline import (  # noqa: F401 (bundles: a fixture)
    T_NMSC,
    T_PIPE,
    T_TRK,
    _frames,
    bundles,
)

JAX_ACTS = {"none": lambda x: x, "silu": nn.silu, "relu": nn.relu,
            "relu6": lambda x: jnp.minimum(nn.relu(x), 6.0)}


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


# --- the NMS fixpoint with a fixed iteration count -------------------------


def _old_fixpoint_keep(boxes, scores, iou_threshold, score_threshold):
    """The kept set of the fixpoint as it ran before: iterate until
    nothing changes, asking after every iteration."""
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
            return order[keep.numpy()], n_iters
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


def _run_both(boxes, scores, iters):
    valid = np.ones(len(scores), bool)
    want = jnms.nms_single_class(jnp.asarray(boxes), jnp.asarray(scores),
                                 jnp.asarray(valid), 0.5, 0.2, 64, 128)
    got = tnms.nms_single_class(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(valid), 0.5, 0.2, 64, 128,
                                iters)
    return got, want


def test_fixed_count_nms_equals_jax_and_the_old_fixpoint():
    rng = np.random.default_rng(11)
    tl = rng.uniform(0, 200, (100, 2))
    boxes = np.concatenate([tl, tl + rng.uniform(10, 60, (100, 2))],
                           -1).astype(np.float32)
    scores = rng.uniform(0, 1, 100).astype(np.float32)
    got, want = _run_both(boxes, scores, None)
    assert bool(got[4])  # converged inside the fixed count
    kept, n_iters = _old_fixpoint_keep(boxes, scores, 0.5, 0.2)
    assert n_iters <= tnms.FIXPOINT_ITERS
    n = int(got[2].sum())
    assert n == min(len(kept), 64)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_array_equal(got[0].numpy()[:n], boxes[kept][:n])


def test_a_chain_longer_than_the_count_clears_converged():
    """40 boxes that suppress each other in a chain need about 40
    iterations: the fixed count reports that it did not converge (and its
    kept set is wrong), the full count converges to JAX's result."""
    boxes, scores = _chain_boxes(40)
    kept, n_iters = _old_fixpoint_keep(boxes, scores, 0.5, 0.2)
    assert n_iters > tnms.FIXPOINT_ITERS
    short, want = _run_both(boxes, scores, None)
    assert not bool(short[4])
    assert not np.array_equal(short[2].numpy(), np.asarray(want[2]))
    full, _ = _run_both(boxes, scores, 128)
    assert bool(full[4])
    np.testing.assert_array_equal(full[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(full[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    assert int(full[2].sum()) == len(kept) == 20
    # More iterations than candidates are capped: the same result.
    capped, _ = _run_both(boxes, scores, 10 ** 6)
    assert all(torch.equal(a, b) for a, b in zip(capped, full))


@pytest.mark.parametrize("streams", [1, 2])
def test_facade_reruns_a_step_whose_nms_did_not_converge(bundles, streams):
    """With the fixed count forced to 1 (and an IoU threshold low enough
    that boxes do suppress each other) the MINI frames do not converge;
    the facade re-runs each such step from the pre-step stores with the
    full count, and tracks exactly what the default count tracks."""
    _, tb = bundles
    nmsc = dataclasses.replace(T_NMSC, iou_threshold=0.2)

    def make():
        if streams == 1:
            return thost.BoTSORTPipeline(tb, T_TRK, nmsc, T_PIPE)
        return thost.BatchedBoTSORTPipeline(tb, streams, T_TRK, nmsc,
                                            T_PIPE)

    want_pipe, got_pipe = make(), make()
    calls = []
    real = got_pipe._step
    got_pipe._step = lambda *a: calls.append(a[5] if len(a) > 5 else None) \
        or real(*a)
    for frames in _stream_frames(3, streams, seed=8):
        arg = frames[0] if streams == 1 else frames
        want = want_pipe.update(arg)
        assert want_pipe.last_result.nms_converged.all()
        with mock.patch.object(tnms, "FIXPOINT_ITERS", 1):
            got = got_pipe.update(arg)
        assert got_pipe.last_result.nms_converged.all()
        if streams == 1:
            want, got = [want], [got]
        assert _ids(got) == _ids(want)
        for a, b in zip(want_pipe.last_result[:-1],
                        got_pipe.last_result[:-1]):
            np.testing.assert_array_equal(a, b)
    assert T_NMSC.pre_nms_top_k in calls  # at least one step re-ran in full


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
    buffers. Like a capture, the capturing run's results are not used;
    like a replay, a re-run leaves the wrappers' Python counters alone."""

    def _capture(self, fn, static_in):
        outputs = [None if o is None else torch.zeros_like(o)
                   for o in fn(*static_in)]

        def replay():
            before = graphed._read_counters()
            for dst, src in zip(outputs, fn(*static_in)):
                if dst is not None:
                    dst.copy_(src)
            for (wrapper, attr), n in zip(graphed.LAUNCH_COUNTERS, before):
                setattr(wrapper, attr, n)

        return replay, outputs


def test_step_key_names_what_changes_the_program():
    key = graphed.step_key("batched", (8, 1080, 1920, 3), 16, 16, False, None)
    assert key == ("batched", 8, 1, 1080, 1920, 16, 16, False, None)
    temporal = graphed.step_key("temporal", (8, 2, 1080, 1920, 3), 16, 0,
                                True, 512)
    assert temporal == ("temporal", 8, 2, 1080, 1920, 16, 0, True, 512)
    assert len({key, temporal,
                graphed.step_key("batched", (8, 1080, 1920, 3), 16, 16, True,
                                 None),
                graphed.step_key("batched", (8, 1080, 1920, 3), 0, 16, False,
                                 None),
                graphed.step_key("batched", (4, 1080, 1920, 3), 16, 16, False,
                                 None)}) == 5


def test_cache_copies_out_and_counts_launches_per_replay():
    cache = EagerReplayCache(torch.device("cpu"))
    k1 = assignment_cuda.cascade_solve_cuda
    k1.launches = 0

    def fn(x, absent, y):
        assert absent is None
        k1.launches += 2  # a step that launches K1 twice
        return [x + y, None, x * 2]

    a, b = torch.arange(4.0), torch.ones(4)
    first = cache.run("k", fn, [a, None, b])
    # One warm-up call ran eagerly (2 launches), the capture's ticks were
    # taken back, one replay stands for 2 more.
    assert (cache.warmups, cache.captures, cache.replays) == (
        graphed.WARMUP_CALLS, 1, 1)
    assert k1.launches == 2 * graphed.WARMUP_CALLS + 2
    assert torch.equal(first[0], a + b) and first[1] is None
    second = cache.run("k", fn, [a + 10, None, b])
    assert (cache.captures, cache.replays) == (1, 2)
    assert torch.equal(second[0], a + 11) and torch.equal(second[2],
                                                          (a + 10) * 2)
    # The first call's results are copies: the second replay wrote the
    # graph's own buffers, not them.
    assert torch.equal(first[0], a + b) and torch.equal(first[2], a * 2)
    entry = cache._entries["k"]
    assert all(o is None or o.data_ptr() != e.data_ptr()
               for o, e in zip(second, entry.outputs))
    assert entry.launches[0] == 2 and k1.launches == 2 + 2 * 2
    # Another key with the same input signature shares the input buffers.
    cache.run("other", fn, [a, None, b])
    assert len(cache._inputs) == 1 and cache.keys() == ["k", "other"]
    cache.run("wider", lambda x: [x], [torch.zeros(5)])
    assert len(cache._inputs) == 2
    k1.launches = 0


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
        (kind, streams, 1, 240, 320, rb, fb, False, None)
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
                                     profile=True)
    assert profiled.timers.cuda_sync is False  # nothing to wait for here
