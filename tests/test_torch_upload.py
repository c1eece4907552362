"""The facades' upload on the CPU: frames into a staging tensor in bands on
the shared pool of worker threads (pipeline/upload.py), and the facade's
counters and span around it (pipeline/host.py). Every copy is held to
``np.copyto`` byte for byte; each band must have landed when the caller
hears of it (where a facade on a CUDA device enqueues its H2D)."""

import threading
import types

import numpy as np
import pytest
import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.pipeline import host, upload

FRAME = (1080, 1920, 3)


def _frames(n, seed, shape=FRAME):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n,) + shape, dtype=np.uint8)


def _readonly(a):
    a.flags.writeable = False
    return a


# (case, source, whether it is split)
CASES = {
    # One 1080p frame (6.2 MB) is below the split; two are above it.
    "frame": (lambda: _frames(1, 1)[0], False),
    "2frames": (lambda: _frames(2, 16), True),
    "8frames": (lambda: _frames(8, 2), True),
    "list8": (lambda: list(_frames(8, 3)), True),
    # 28.8 MB: neither a multiple of the band nor of the alignment.
    "uneven": (lambda: _frames(5, 4, (1001, 1917, 3)), True),
    "readonly": (lambda: _readonly(_frames(2, 5)), True),
    "gmc": (lambda: np.random.default_rng(6).normal(
        size=(8, 2, 3)).astype(np.float32), False),
    "negative_stride": (lambda: _frames(1, 7)[0][..., ::-1], False),
    "fortran": (lambda: np.asfortranarray(_frames(1, 8)[0]), False),
    "list_with_a_view": (lambda: [*_frames(3, 9), _frames(1, 10)[0, ::-1]],
                         False),
}


def _want(src):
    shape, dtype = upload.batch_shape(upload.as_batch(src))
    out = np.empty(shape, dtype)
    np.copyto(out, np.stack(src) if isinstance(src, list) else src)
    return out


def _facade(trace=False):
    return host._Facade(types.SimpleNamespace(device=torch.device("cpu")),
                        TrackerConfig(), NMSConfig(), PipelineConfig(),
                        graphs=False, trace=trace)


@pytest.mark.parametrize("case", list(CASES))
def test_upload_copies_every_byte(case):
    """Through ``upload.stage`` (the ranges it reports, in landing order,
    tile the buffer and hold their bytes when reported) and through a
    facade's ``_upload`` (its counters and its ``upload.copy`` span)."""
    make, split = CASES[case]
    src = make()
    want = _want(src)
    shape, dtype = upload.batch_shape(upload.as_batch(src))
    dst = torch.zeros(shape, dtype=upload.torch_dtype(dtype))
    got_bytes = dst.numpy().reshape(-1).view(np.uint8)
    want_bytes = want.reshape(-1).view(np.uint8)
    ranges = []

    def landed(a, b):
        assert np.array_equal(got_bytes[a:b], want_bytes[a:b]), (a, b)
        ranges.append((a, b))

    bands = upload.stage(dst, upload.as_batch(src), landed)
    assert np.array_equal(dst.numpy(), want)
    assert (bands > 0) == split
    assert len(ranges) == max(bands, 1)
    edges = sorted(ranges)
    assert edges[0][0] == 0 and edges[-1][1] == want.nbytes
    assert all(x[1] == y[0] for x, y in zip(edges, edges[1:]))
    if split:
        assert all(b - a >= upload.CHUNK_BYTES // 2 for a, b in ranges)

    pipe = _facade(trace=True)
    pipe.timers.begin_update()
    with pipe.timers.stage("upload"):
        out = pipe._upload("frames", upload.as_batch(src))
    pipe.timers.end_update()
    assert out.dtype == dst.dtype and np.array_equal(out.numpy(), want)
    assert (pipe.uploads, pipe.uploads_split, pipe.upload_chunks) == (
        1, int(split), bands)
    spans = pipe.timers.export()["spans"]
    assert [s[3] for s in spans if s[0] == "upload.copy"] == ["upload"]


def test_second_upload_leaves_nothing_of_the_first_and_starts_no_thread():
    dst = torch.zeros((8,) + FRAME, dtype=torch.uint8)
    first, second = _frames(8, 11), _frames(8, 12)
    assert upload.stage(dst, first) > 0
    pool = upload.workers()
    threads = threading.active_count()
    assert upload.stage(dst, second) > 0
    assert upload.workers() is pool and threading.active_count() == threads
    assert np.array_equal(dst.numpy(), second)
    assert 1 <= len(pool.threads) <= upload.MAX_WORKERS
    assert all(t.is_alive() for t in pool.threads)


def test_concurrent_callers_share_the_pool():
    """More callers than cores (a server's facades on their own threads),
    the interpreter switching threads often: every destination holds its
    own source's bytes after every call."""
    import sys

    callers, rounds = 12, 3
    srcs = [_frames(1, 100 + k, (1500, 2000, 3))[0] for k in range(callers)]
    dsts = [torch.zeros(x.shape, dtype=torch.uint8) for x in srcs]
    wrong, done = [], []

    def caller(k):
        for r in range(rounds):
            src = srcs[(k + r) % callers]
            if upload.stage(dsts[k], src) == 0 or not np.array_equal(
                    dsts[k].numpy(), src):
                wrong.append((k, r))
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(callers)) and not wrong, wrong


def test_stage_refuses_a_destination_of_another_shape():
    with pytest.raises(ValueError, match="cannot stage"):
        upload.stage(torch.zeros((2,) + FRAME, dtype=torch.uint8),
                     _frames(3, 15))


@pytest.mark.parametrize("where", ["band", "on_chunk"])
def test_a_failure_is_raised_once_every_band_has_landed(monkeypatch, where):
    """A band copy or the caller's ``on_chunk`` that raises: ``stage``
    raises it, after waiting for every other band."""
    dst = torch.zeros((8,) + FRAME, dtype=torch.uint8)
    src = _frames(8, 13)
    copied, calls = [], []
    real = upload._copy_band

    def copy_band(d, s):
        if where == "band" and not copied:
            copied.append(None)
            raise OSError("band")
        real(d, s)
        copied.append(d.nbytes)

    def on_chunk(a, b):
        calls.append((a, b))
        if where == "on_chunk":
            raise OSError("on_chunk")

    monkeypatch.setattr(upload, "_copy_band", copy_band)
    with pytest.raises(OSError, match=where):
        upload.stage(dst, src, on_chunk)
    bands = len(upload._bands(src.nbytes))
    assert len(copied) == bands
    # Nothing is reported once the failure is known.
    assert len(calls) == 1 if where == "on_chunk" else len(calls) < bands


@pytest.mark.parametrize("frames", ["array", "list"])
def test_batched_update_refuses_a_wrong_frame_count(frames):
    pipe = host.BatchedBoTSORTPipeline(
        types.SimpleNamespace(device=torch.device("cpu")), 3, graphs=False)
    src = _frames(2, 14, (24, 32, 3))
    with pytest.raises(ValueError, match="expected 3 frames, got 2"):
        pipe.update_async(src if frames == "array" else list(src))
    assert pipe.uploads == 0


def test_a_list_of_frames_of_two_shapes_is_refused():
    with pytest.raises(ValueError, match="same shape"):
        upload.as_batch([np.zeros((4, 6, 3), np.uint8),
                         np.zeros((4, 5, 3), np.uint8)])
