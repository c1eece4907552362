"""The encoders' bucket switch inside the step (the JAX package's
``lax.switch`` / ``lax.cond`` in ``_encode_chunked``).

With ``PipelineConfig.host_bucket_dispatch=False`` the JAX frame step
picks each encoder's batch on the device from the live count
(botsort_tpu/pipeline/frame_step.py:112-170, 704-730): no crop, the first
``max_reid_batch`` slots, or the full padded width; the slots beyond the
taken branch are zeros. One program serves every load.

``bucket_switch(value, branches, inputs, out)`` is that switch in the
port: ``value`` is an int32 device scalar, each ``Branch`` runs where
``lo < value <= hi`` and writes the first ``width`` slots (axis 1) of the
preallocated, zeroed ``out`` from the tensors in ``inputs``. How it runs
depends on who runs the step:

- on the CPU, eagerly: a Python branch on the value (reading it is free
  there), exactly the JAX switch;
- on the card, eagerly (``graphs=False``): no readback is allowed
  between upload and readback, so the widest branch runs and the slots
  beyond the width the value picks are zeroed with ``torch.where``;
- inside ``GraphCache`` (pipeline/graphed.py): the cache installs its own
  runner (``runner``), which captures each branch as its own CUDA graph
  and assembles them as conditional nodes behind kernel K9
  (csrc/graph_cond.cu), so that only the picked branch runs.

``branch_flags_plain`` is K9's plain version; ``ConditionalProgram``
assembles the parent graph through csrc/graph_cond.cu and
``launch_conditional`` launches it.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from botsort_tpu_torch.runtime import kernels
from botsort_tpu_torch.utils.consts import const

INT32_MAX = 2 ** 31 - 1


class Branch(NamedTuple):
    """One branch of a switch: runs where lo < value <= hi and writes the
    first ``width`` slots of ``out``: ``run(*inputs, out)``."""

    lo: int
    hi: int
    width: int
    run: Callable[..., None]


def bucket_branches(encode: Callable[[torch.Tensor], torch.Tensor],
                    dp: int, chunk: int) -> List[Branch]:
    """The JAX ``_encode_chunked`` branches over dp padded slots: the
    first ``chunk`` slots where 0 < n <= chunk, all dp where n > chunk (a
    ``lax.cond`` of one branch, all dp where n > 0, when dp <= chunk).
    ``encode`` maps tlbr [B, k, 4] to features [B, k, D]."""

    def branch(width):
        def run(tlbr, out):
            out[:, :width] = encode(tlbr[:, :width])
        return run

    if dp <= chunk:
        return [Branch(0, INT32_MAX, dp, branch(dp))]
    return [Branch(0, chunk, chunk, branch(chunk)),
            Branch(chunk, INT32_MAX, dp, branch(dp))]


def branch_flags_plain(value: torch.Tensor, branches: Sequence[Branch]
                       ) -> torch.Tensor:
    """K9's plain version: [len(branches)] bool, lo < value <= hi per
    branch (what K9 sets each conditional node's handle to)."""
    lo = const(tuple(b.lo for b in branches), torch.int32, value.device)
    hi = const(tuple(b.hi for b in branches), torch.int32, value.device)
    return (value > lo) & (value <= hi)


def branch_index(value: int, branches: Sequence[Branch]) -> Optional[int]:
    """The branch a host integer picks (None: no branch)."""
    for k, b in enumerate(branches):
        if b.lo < value <= b.hi:
            return k
    return None


def zero_beyond(value: torch.Tensor, branches: Sequence[Branch],
                out: torch.Tensor) -> None:
    """Zero the slots of ``out`` beyond the width of the branch ``value``
    picks (all of them where it picks none), on the device."""
    widths = const(tuple(b.width for b in branches), torch.int32,
                   out.device)
    width = (branch_flags_plain(value, branches) * widths).sum()
    slots = torch.arange(out.shape[1], device=out.device)
    keep = (slots < width).reshape((1, -1) + (1,) * (out.dim() - 2))
    out.copy_(torch.where(keep, out, torch.zeros_like(out)))


def run_eager(value: torch.Tensor, branches: Sequence[Branch],
              inputs: Tuple[torch.Tensor, ...], out: torch.Tensor) -> None:
    """The switch outside a graph: a Python branch on the CPU; on the card
    the widest branch, then ``zero_beyond`` (no readback)."""
    if value.device.type == "cpu":
        k = branch_index(int(value), branches)
        if k is not None:
            branches[k].run(*inputs, out)
        return
    if value.device.type != "cuda":
        raise ValueError(f"bucket_switch: no route for device "
                         f"{value.device}")
    max(branches, key=lambda b: b.width).run(*inputs, out)
    zero_beyond(value, branches, out)


def run_every_branch(value, branches, inputs, out) -> None:
    """Every branch in turn, then ``zero_beyond``: a warm-up call before a
    capture, so that each branch's batch size has met cuDNN and the
    kernels' caches before it is captured."""
    for b in branches:
        b.run(*inputs, out)
    zero_beyond(value, branches, out)


_RUNNERS: List[Callable] = []


@contextlib.contextmanager
def runner(fn: Callable[..., None]):
    """Run every ``bucket_switch`` inside the block through ``fn(value,
    branches, inputs, out)``."""
    _RUNNERS.append(fn)
    try:
        yield
    finally:
        _RUNNERS.pop()


def bucket_switch(value: torch.Tensor, branches: Sequence[Branch],
                  inputs: Tuple[torch.Tensor, ...], out: torch.Tensor
                  ) -> None:
    """Run the branch of ``branches`` that ``value`` (int32 []) picks into
    ``out`` (zeroed by the caller), reading only ``inputs`` and tensors
    that do not change from step to step (the frames' static buffer, the
    weights). See the module docstring for who runs it how."""
    (_RUNNERS[-1] if _RUNNERS else run_eager)(value, list(branches),
                                              tuple(inputs), out)


# --- the parent graph: segments, K9 and conditional nodes ------------------


def _lib() -> ctypes.CDLL:
    lib = kernels.load("graph_cond")
    if lib.graph_cond_add_switch.argtypes is None:
        vp = ctypes.c_void_p
        lib.graph_cond_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.graph_cond_create.argtypes = [ctypes.POINTER(vp)]
        lib.graph_cond_add_segment.argtypes = [vp, ctypes.POINTER(vp), vp]
        lib.graph_cond_add_switch.argtypes = [
            vp, ctypes.POINTER(vp), vp, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(vp)]
        lib.graph_cond_instantiate.argtypes = [vp, ctypes.POINTER(vp)]
        lib.graph_cond_launch.argtypes = [vp, vp]
        lib.graph_cond_destroy.argtypes = [vp, vp]
        for name in ("versions", "create", "add_segment", "add_switch",
                     "instantiate", "launch", "destroy"):
            getattr(lib, f"graph_cond_{name}").restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"conditional graph: {what} failed: CUDA error "
                           f"{rc}")


def cuda_versions() -> Tuple[int, int]:
    """(runtime, driver) CUDA versions as the kernels' library sees them."""
    rt, drv = ctypes.c_int(0), ctypes.c_int(0)
    _check(_lib().graph_cond_versions(ctypes.byref(rt), ctypes.byref(drv)),
           "cudaRuntimeGetVersion")
    return rt.value, drv.value


class ConditionalProgram:
    """One CUDA graph assembled from captured segments (``torch.cuda.
    CUDAGraph(keep_graph=True)``) in run order: ``("segment", graph)`` runs
    unconditionally; ``("switch", value, branches, graphs)`` adds K9,
    which reads the int32 at ``value`` when the program runs, and one IF
    node per branch whose body is that branch's graph. The segments are
    cloned into the program; the tensors they read and write must stay
    allocated as long as it lives. ``launch_conditional`` runs it.
    A driver without conditional nodes or a refused node raises: nothing
    falls back to another way of running the switch."""

    def __init__(self, items: Sequence[tuple], device: torch.device):
        device = torch.device(device)
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.device = device
        lib = _lib()
        self._graph = ctypes.c_void_p(None)
        self._exec = ctypes.c_void_p(None)
        with torch.cuda.device(self.device):
            _check(lib.graph_cond_create(ctypes.byref(self._graph)),
                   "cudaGraphCreate")
            last = ctypes.c_void_p(None)
            for item in items:
                if item[0] == "segment":
                    _check(lib.graph_cond_add_segment(
                        self._graph, ctypes.byref(last),
                        ctypes.c_void_p(item[1].raw_cuda_graph())),
                        "a child-graph node")
                    continue
                _, value, branches, graphs = item
                if value.dtype != torch.int32 or value.numel() != 1 or \
                        value.device != self.device:
                    raise ValueError("a switch value is one int32 on the "
                                     "program's device")
                n = len(branches)
                lo = (ctypes.c_int * n)(*(b.lo for b in branches))
                hi = (ctypes.c_int * n)(*(b.hi for b in branches))
                bodies = (ctypes.c_void_p * n)(
                    *(g.raw_cuda_graph() for g in graphs))
                _check(lib.graph_cond_add_switch(
                    self._graph, ctypes.byref(last),
                    ctypes.c_void_p(value.data_ptr()), n, lo, hi, bodies),
                    "K9 and its conditional nodes")
            _check(lib.graph_cond_instantiate(self._graph,
                                              ctypes.byref(self._exec)),
                   "cudaGraphInstantiate")

    def __del__(self):
        graph, exe = getattr(self, "_graph", None), getattr(self, "_exec",
                                                            None)
        if graph is not None and (graph.value or exe.value):
            self._graph = self._exec = ctypes.c_void_p(None)
            try:
                _lib().graph_cond_destroy(exe, graph)
            except Exception:  # noqa: BLE001 (interpreter shutdown)
                pass


def launch_conditional(program: ConditionalProgram) -> None:
    """Launch ``program`` on the current stream of its device, without
    waiting. K9 runs once a switch in it."""
    rc = _lib().graph_cond_launch(
        program._exec,
        ctypes.c_void_p(kernels.current_stream(program.device)))
    _check(rc, "cudaGraphLaunch")
