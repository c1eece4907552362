"""The host half of a facade's upload: frames into a staging tensor.

``stage(dst, src, on_chunk)`` copies an array, or a list of arrays that
make up ``dst``'s leading axis, into ``dst``, a contiguous CPU tensor (the
facade's pinned staging buffer). A small upload is one ``np.copyto`` on
the calling thread. From ``SPLIT_BYTES`` on, the bytes are cut into bands
of about ``CHUNK_BYTES`` and copied on a pool of worker threads that every
facade shares: the copy releases the GIL, so the bands copy in parallel,
and ``on_chunk`` sees each band on the calling thread as soon as it has
landed, in the order they land (the facade enqueues that band's H2D
there, so the copy engine works on the first bands while the workers
still fill the rest). The pool is made at its first use; its idle
workers block on a queue and take no CPU.

A source that is not C-contiguous (a negative-stride or Fortran-ordered
view), or whose dtype differs from ``dst``'s, takes the plain path: numpy
copies it element by element, as before, and no extra full copy is made
for the contiguous case.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# From this many bytes on an upload is split: below, one copy on the
# calling thread beats waking the workers. Measured on an H100's 8-core
# host (cold 1080p uint8 frames into pinned memory, medians of 40, up to
# the H2D's end; one thread / 8 workers, 2 MiB bands): 3.1 MB 0.59 / 0.65
# ms, 6.2 MB 1.04 / 0.89, 12.4 MB 3.00 / 1.29, 49.8 MB 10.93 / 3.33. But
# split at 4 MiB, a one-camera 1080p tracker (6.2 MB frames) tracked
# fewer frames a second in 6 of 7 paired runs and its 95th-percentile
# update rose in all 7, so one such frame stays on the calling thread.
SPLIT_BYTES = 8 << 20
# Bytes a band, at least. Inside the 8-camera tracker's update (8 workers,
# blocks alternating in one process) the 49.8 MB upload took 2.72 ms with
# 4 MiB bands against 3.10 with 2 MiB; a one-off copy, 3.11 against 3.33.
CHUNK_BYTES = 4 << 20
# Workers at most, whatever the host has. The same update's upload with 4
# MiB bands: 8 workers 2.72 ms, 7 2.90, 4 3.61.
MAX_WORKERS = 8
# Band boundaries fall on multiples of this many bytes (within a frame).
_ALIGN = 4096

Frames = Union[np.ndarray, Sequence[np.ndarray]]


def as_batch(frames: Frames) -> Frames:
    """``frames`` as an array, or as a list of arrays of one shape that a
    batch's leading axis stacks (copied into the staging buffer one by
    one, never stacked)."""
    if isinstance(frames, np.ndarray):
        return frames
    parts = [np.asarray(f) for f in frames]
    if not parts:
        raise ValueError("need at least one frame")
    if any(p.shape != parts[0].shape for p in parts):
        raise ValueError("all frames must have the same shape, got "
                         f"{sorted({p.shape for p in parts})}")
    return parts


def batch_shape(frames: Frames) -> Tuple[Tuple[int, ...], np.dtype]:
    """(shape, dtype) of the array that ``frames`` (``as_batch``) holds."""
    if isinstance(frames, np.ndarray):
        return frames.shape, frames.dtype
    return (len(frames),) + frames[0].shape, np.result_type(*frames)


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Workers:
    """Daemon threads that run jobs from one queue."""

    def __init__(self, n: int):
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self.threads = [threading.Thread(target=self._work, daemon=True,
                                         name=f"upload-copy-{k}")
                        for k in range(n)]
        for t in self.threads:
            t.start()

    def _work(self):
        while True:
            job = self._jobs.get()
            job()

    def submit(self, job: Callable[[], None]) -> None:
        self._jobs.put(job)


_workers: Optional[_Workers] = None
_workers_lock = threading.Lock()


def workers() -> _Workers:
    """The shared pool: one worker a CPU this process may run on, at most
    ``MAX_WORKERS``."""
    global _workers
    if _workers is None:
        with _workers_lock:
            if _workers is None:
                _workers = _Workers(max(1, min(
                    MAX_WORKERS, len(os.sched_getaffinity(0)))))
    return _workers


def _forget_workers():
    # A forked child has the pool's object but none of its threads.
    global _workers
    _workers = None


os.register_at_fork(after_in_child=_forget_workers)


def _copy_band(dst: np.ndarray, src: np.ndarray) -> None:
    """dst[:] = src for two uint8 vectors of one length: a ``memmove``
    through ctypes, which releases the GIL for the copy (``np.copyto``
    keeps it). ``Tensor.copy_`` releases it too, but took 3.48 ms where
    this takes 2.48 (49.8 MB, 8 workers, 2 MiB bands) and would fan out to
    PyTorch's intra-op threads from every worker."""
    ctypes.memmove(dst.__array_interface__["data"][0],
                   src.__array_interface__["data"][0], dst.nbytes)


def _bands(nbytes: int) -> List[Tuple[int, int]]:
    """[start, stop) byte ranges of about ``CHUNK_BYTES`` covering one
    frame's ``nbytes``."""
    n = max(1, nbytes // CHUNK_BYTES)
    cuts = [0] + [nbytes * k // n // _ALIGN * _ALIGN for k in range(1, n)]
    return list(zip(cuts, cuts[1:] + [nbytes]))


def _splits(dst: torch.Tensor, parts: List[np.ndarray]) -> bool:
    return (dst.numel() * dst.element_size() >= SPLIT_BYTES
            and all(p.flags.c_contiguous and torch_dtype(p.dtype) == dst.dtype
                    for p in parts))


def stage(dst: torch.Tensor, src: Frames,
          on_chunk: Optional[Callable[[int, int], None]] = None) -> int:
    """Copy ``src`` (``as_batch``) into ``dst``, a contiguous CPU tensor of
    its shape. ``on_chunk(start, stop)`` is called on the calling thread
    with each landed range of ``dst``'s bytes, in the order they land (the
    plain path: once, with all of them). Returns the number of bands the
    copy was split into, 0 for the plain path."""
    src = as_batch(src)
    if tuple(dst.shape) != batch_shape(src)[0] or dst.device.type != "cpu" \
            or not dst.is_contiguous():
        raise ValueError(f"cannot stage {batch_shape(src)[0]} frames into a "
                         f"{tuple(dst.shape)} {dst.device} tensor")
    parts = [src] if isinstance(src, np.ndarray) else src
    nbytes = dst.numel() * dst.element_size()
    if not _splits(dst, parts):
        out = dst.numpy()
        if isinstance(src, np.ndarray):
            np.copyto(out, src)
        else:
            for k, p in enumerate(parts):
                np.copyto(out[k], p)
        if on_chunk is not None and nbytes:
            on_chunk(0, nbytes)
        return 0
    dst_bytes = dst.numpy().reshape(-1).view(np.uint8)
    jobs = []
    off = 0
    for p in parts:
        src_bytes = p.reshape(-1).view(np.uint8)
        jobs += [(off + a, off + b, src_bytes[a:b])
                 for a, b in _bands(src_bytes.nbytes)]
        off += src_bytes.nbytes
    landed: "queue.SimpleQueue" = queue.SimpleQueue()

    def band(a, b, s):
        def job():
            try:
                _copy_band(dst_bytes[a:b], s)
                landed.put((a, b, None))
            except BaseException as exc:  # handed to the caller
                landed.put((a, b, exc))
        return job

    pool = workers()
    for a, b, s in jobs:
        pool.submit(band(a, b, s))
    # Every band is waited for, even after a failure: no worker may still
    # be writing ``dst`` once this returns.
    error = None
    for _ in jobs:
        a, b, exc = landed.get()
        if exc is None and error is None and on_chunk is not None:
            try:
                on_chunk(a, b)
            except BaseException as raised:  # re-raised once all landed
                exc = raised
        error = error or exc
    if error is not None:
        raise error
    return len(jobs)
