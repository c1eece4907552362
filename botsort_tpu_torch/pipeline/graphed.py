"""The frame step as a replayable program: a cache of CUDA graphs.

The JAX package's step is one jitted program per static (reid bucket, face
bucket) pair (botsort_tpu/pipeline/frame_step.py, ``jax.jit`` with
``static_argnames``). The port's step is the same arithmetic as several
thousand kernel launches, and in eager mode the host's launch rate, not
the card, sets its time. ``GraphCache`` captures a step once per key into
a CUDA graph and replays it afterwards: one launch of the whole program.

A step is keyed by ``step_key``: its kind, the frames' shape (B, T, H, W),
the two buckets, whether camera-motion affines are given and the NMS
iteration count: everything that changes the program, as opposed to its
data. The cache is generic over what a step computes: it takes a function
of tensors that returns a list of tensors (either may hold None for an
absent one) and

- keeps one set of static input buffers per input signature (shapes and
  dtypes), shared by every key of that signature, and copies each call's
  inputs into them;
- at a key's first use runs the function ``WARMUP_CALLS`` times eagerly
  (cuDNN picks its algorithms, the kernels build, the per-module caches
  fill: none of that may happen inside a capture), then captures it; all
  graphs of one cache share one memory pool, so the scratch of one graph
  (the fused stem's alone is hundreds of megabytes) is the scratch of the
  next;
- replays, and returns *copies* of the graph's output buffers: the next
  replay overwrites those buffers, while the callers keep results and
  pre-step track stores across steps (the overflow re-run reads the
  pre-step store).

A capture or a replay that fails raises; nothing here falls back to the
eager step. Kernel wrappers count their launches in Python, which a replay
does not run: the cache records how many launches of each kernel a capture
enqueued (``LAUNCH_COUNTERS``) and adds them per replay, so the counts stay
the number of times each kernel really ran.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from botsort_tpu_torch.models import bn_act, facereid_dw, fastreid_fused
from botsort_tpu_torch.ops import assignment_cuda

WARMUP_CALLS = 1

# (wrapper, counter attribute) of every kernel wrapper a step can launch.
LAUNCH_COUNTERS = (
    (assignment_cuda.cascade_solve_cuda, "launches"),
    (assignment_cuda.cascade_solve_cuda, "batched_launches"),
    (assignment_cuda.jv_solve_cuda, "launches"),
    (fastreid_fused.stem_stage1_cuda, "launches"),
    (facereid_dw.dw_conv3x3_cuda, "launches"),
    (bn_act.bn_act_cuda, "launches"),
)


def step_key(kind: str, frames_shape: Sequence[int],
             reid_bucket: Optional[int], face_bucket: Optional[int],
             gmc_given: bool, nms_iters: Optional[int]) -> Tuple:
    """The key of one captured step. ``frames_shape`` is [H, W, 3] for one
    stream's step, [B, H, W, 3] for a batched one or [B, T, H, W, 3] for a
    temporal one."""
    shape = tuple(frames_shape)
    b = shape[0] if len(shape) >= 4 else 1
    t = shape[1] if len(shape) == 5 else 1
    h, w = shape[-3], shape[-2]
    return (kind, b, t, h, w, reid_bucket, face_bucket, bool(gmc_given),
            nms_iters)


def _read_counters() -> List[int]:
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


class _Entry:
    """One captured step: its replay, its output buffers and the kernel
    launches one replay stands for."""

    def __init__(self, replay: Callable[[], None],
                 outputs: List[torch.Tensor], launches: List[int]):
        self.replay = replay
        self.outputs = outputs
        self.launches = launches


class GraphCache:
    """Captured steps of one pipeline on one CUDA device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._entries: Dict[Tuple, _Entry] = {}
        self._inputs: Dict[Tuple, List[Optional[torch.Tensor]]] = {}
        self._pool = None
        # What the callers keep per key beside the graph (the facades: the
        # packed result's layout, which a replay does not recompute).
        self.meta: Dict[Tuple, object] = {}
        # Totals, for checks: captures made, warm-up calls run eagerly and
        # replays.
        self.captures = 0
        self.warmups = 0
        self.replays = 0

    def keys(self):
        return list(self._entries)

    def _static_inputs(self, inputs) -> List[Optional[torch.Tensor]]:
        sig = tuple(None if x is None else (tuple(x.shape), x.dtype)
                    for x in inputs)
        static = self._inputs.get(sig)
        if static is None:
            static = [None if x is None else torch.empty_like(x)
                      for x in inputs]
            self._inputs[sig] = static
        return static

    def _capture(self, fn, static_in
                 ) -> Tuple[Callable[[], None], List[torch.Tensor]]:
        """Capture ``fn(*static_in)`` into a CUDA graph; returns its
        replay and its output buffers."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(graph, pool=self._pool):
            outputs = list(fn(*static_in))
        return graph.replay, outputs

    def run(self, key: Tuple, fn: Callable[..., Sequence[torch.Tensor]],
            inputs: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """``fn(*inputs)`` through the graph captured for ``key`` (captured
        now if this is the key's first use). ``fn`` must be the same
        function of its inputs on every call with one key. Returns fresh
        tensors."""
        static_in = self._static_inputs(inputs)
        for dst, src in zip(static_in, inputs):
            if dst is not None:
                dst.copy_(src)
        entry = self._entries.get(key)
        if entry is None:
            for _ in range(WARMUP_CALLS):
                fn(*static_in)
                self.warmups += 1
            before = _read_counters()
            replay, outputs = self._capture(fn, static_in)
            after = _read_counters()
            # A capture enqueues and runs nothing: take its ticks back and
            # keep them as what one replay launches.
            for (wrapper, attr), b in zip(LAUNCH_COUNTERS, before):
                setattr(wrapper, attr, b)
            entry = _Entry(replay, outputs,
                           [a - b for a, b in zip(after, before)])
            self._entries[key] = entry
            self.captures += 1
        entry.replay()
        self.replays += 1
        for (wrapper, attr), n in zip(LAUNCH_COUNTERS, entry.launches):
            if n:
                setattr(wrapper, attr, getattr(wrapper, attr) + n)
        return [None if o is None else o.clone() for o in entry.outputs]
