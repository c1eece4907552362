"""The frame step as a replayable program: a cache of CUDA graphs.

The JAX package's step is one jitted program per static (reid bucket, face
bucket) pair (botsort_tpu/pipeline/frame_step.py, ``jax.jit`` with
``static_argnames``). The port's step is the same arithmetic as several
thousand kernel launches, and in eager mode the host's launch rate, not
the card, sets its time. ``GraphCache`` captures a step once per key into
a CUDA graph and replays it afterwards: one launch of the whole program.

A step is keyed by ``step_key``: its kind, the frames' shape (B, T, H, W),
the two buckets (None for the in-program switch of
``host_bucket_dispatch=False``) and whether camera-motion affines are
given: everything that changes the program, as opposed to its data. The
cache is generic over what a step computes: it takes a function of
tensors that returns a list of tensors (either may hold None for an
absent one) and

- keeps one set of static input buffers per input signature (shapes and
  dtypes), shared by every key of that signature, and copies each call's
  inputs into them;
- at a key's first use runs the function ``WARMUP_CALLS`` times eagerly
  (cuDNN picks its algorithms, the kernels build, the per-module caches
  fill: none of that may happen inside a capture; a bucket switch runs
  every branch then), then captures it; all graphs of one cache share one
  memory pool, so the scratch of one graph (the fused stem's alone is
  hundreds of megabytes) is the scratch of the next;
- replays, and returns *copies* of the graph's output buffers: the next
  replay overwrites those buffers, while the callers keep results and
  pre-step track stores across steps (the overflow re-run reads the
  pre-step store).

A step that reaches ``pipeline/switch.py::bucket_switch`` is captured in
segments, in run order on one capture stream and into the one pool: the
work before the switch, each branch, the work after it. The segments'
graphs are assembled into one ``ConditionalProgram`` (the branches as the
bodies of conditional nodes behind kernel K9), so one capture serves every
load. The tensors that cross a segment boundary stay referenced by the
step's own frames until the last segment is captured, so the pool hands
none of them to a later segment.

A capture or a replay that fails raises; nothing here falls back to the
eager step. Kernel wrappers count their launches in Python, which a replay
does not run: the cache records how many launches of each kernel a capture
enqueued (``LAUNCH_COUNTERS``) and adds them per replay, so the counts stay
the number of times each kernel really ran. A switch's branches are
counted apart: only the host knows which one ran, once it has read the
step's result, and tells the cache with ``count_branches``.

A traced facade enqueues its step under ``utils/profiling.py::recording``.
The cache then captures the step's stage marks as event-record nodes,
keeps them with the entry, and hands them to the caller's marks after each
replay, which it spans as ``graph.launch``. A mark inside a switch branch
is refused (a conditional node's body takes no event-record node); the
warm-up calls and the replay itself record none. A step captured untraced
has no marks and holds no event-record node.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from botsort_tpu_torch.models import bn_act, facereid_dw, fastreid_fused
from botsort_tpu_torch.ops import assignment_cuda, crop, hierarchy, nms
from botsort_tpu_torch.pipeline import switch
from botsort_tpu_torch.utils import profiling

WARMUP_CALLS = 1

# (wrapper, counter attribute) of every kernel wrapper a step can launch.
LAUNCH_COUNTERS = (
    (assignment_cuda.cascade_solve_cuda, "launches"),
    (assignment_cuda.cascade_solve_cuda, "batched_launches"),
    (assignment_cuda.jv_solve_cuda, "launches"),
    (fastreid_fused.stem_stage1_cuda, "launches"),
    (facereid_dw.dw_conv3x3_cuda, "launches"),
    (bn_act.bn_act_cuda, "launches"),
    (bn_act.bn_act_cuda, "launches_channels_last"),
    (crop.crop_resize_cuda, "launches"),
    (nms.nms_fixpoint_cuda, "launches"),
    (hierarchy.greedy_scan_cuda, "launches"),
)


def step_key(kind: str, frames_shape: Sequence[int],
             reid_bucket: Optional[int], face_bucket: Optional[int],
             gmc_given: bool) -> Tuple:
    """The key of one captured step. ``frames_shape`` is [H, W, 3] for one
    stream's step, [B, H, W, 3] for a batched one or [B, T, H, W, 3] for a
    temporal one; None buckets: the in-program switch."""
    shape = tuple(frames_shape)
    b = shape[0] if len(shape) >= 4 else 1
    t = shape[1] if len(shape) == 5 else 1
    h, w = shape[-3], shape[-2]
    return (kind, b, t, h, w, reid_bucket, face_bucket, bool(gmc_given))


def _read_counters() -> List[int]:
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


def _add_counts(counts: Sequence[int]) -> None:
    for (wrapper, attr), n in zip(LAUNCH_COUNTERS, counts):
        if n:
            setattr(wrapper, attr, getattr(wrapper, attr) + n)


class _Entry:
    """One captured step: its replay, its output buffers, the kernel
    launches one replay stands for outside any switch, per switch its
    branches and each branch's launches, what the replay needs kept alive
    (the segments' graphs) and its stage marks (None: captured
    untraced)."""

    def __init__(self, replay: Callable[[], None],
                 outputs: List[torch.Tensor], launches: List[int],
                 switches: List[tuple], keep: object,
                 marks: Optional[profiling.Marks] = None):
        self.replay = replay
        self.outputs = outputs
        self.launches = launches
        self.switches = switches
        self.keep = keep
        self.marks = marks


class GraphCache:
    """Captured steps of one pipeline on one CUDA device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._entries: Dict[Tuple, _Entry] = {}
        self._inputs: Dict[Tuple, List[Optional[torch.Tensor]]] = {}
        self._pool = None
        self._stream = None
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

    # The capture's primitives: a CUDA graph per segment, assembled into one
    # program. tests/test_torch_graphed.py's CPU stand-in overrides them.

    def _begin(self):
        """Start capturing a segment on the cache's capture stream into its
        pool; returns what ``_end`` takes."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        ctx = torch.cuda.graph(graph, pool=self._pool, stream=self._stream)
        ctx.__enter__()
        return graph, ctx

    def _end(self, token):
        """End a segment's capture; returns its graph."""
        graph, ctx = token
        ctx.__exit__(None, None, None)
        return graph

    def _program(self, items, fn, static_in, outputs) -> Callable[[], None]:
        """The replay of a captured step's ``items`` (``("segment",
        graph)`` and ``("switch", value, branches, graphs, inputs, out)``,
        in run order): one graph's replay, or a ConditionalProgram."""
        if len(items) == 1:
            graph = items[0][1]
            graph.instantiate()
            return graph.replay
        program = switch.ConditionalProgram([item[:4] for item in items],
                                            self.device)
        return lambda: switch.launch_conditional(program)

    def _capture(self, fn, static_in):
        """Capture ``fn(*static_in)``, in segments at its switches; returns
        its replay, its output buffers, the launches of the work outside
        the switches, the switches (branches, launches per branch) and the
        items to keep alive."""
        items: List[tuple] = []
        switches: List[tuple] = []
        start = _read_counters()
        mark = [start]
        base = [0] * len(LAUNCH_COUNTERS)

        def since_mark() -> List[int]:
            now = _read_counters()
            out = [a - b for a, b in zip(now, mark[0])]
            mark[0] = now
            return out

        open_segment = [self._begin()]

        def split(value, branches, inputs, out):
            items.append(("segment", self._end(open_segment.pop())))
            base[:] = [a + b for a, b in zip(base, since_mark())]
            graphs, counts = [], []
            for b in branches:
                token = self._begin()
                try:
                    with profiling.recording(profiling.NO_MARKS_IN_BRANCH):
                        b.run(*inputs, out)
                finally:
                    graphs.append(self._end(token))
                counts.append(since_mark())
            items.append(("switch", value, branches, graphs, inputs, out))
            switches.append((branches, counts))
            open_segment.append(self._begin())

        try:
            device = (torch.cuda.device(self.device)
                      if self.device.type == "cuda"
                      else contextlib.nullcontext())
            with device, switch.runner(split):
                outputs = list(fn(*static_in))
        finally:
            if open_segment:
                items.append(("segment", self._end(open_segment.pop())))
        base[:] = [a + b for a, b in zip(base, since_mark())]
        # A capture enqueues and runs nothing: take its ticks back.
        for (wrapper, attr), n in zip(LAUNCH_COUNTERS, start):
            setattr(wrapper, attr, n)
        replay = self._program(items, fn, static_in, outputs)
        return replay, outputs, base, switches, items

    def run(self, key: Tuple, fn: Callable[..., Sequence[torch.Tensor]],
            inputs: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """``fn(*inputs)`` through the graph captured for ``key`` (captured
        now if this is the key's first use). ``fn`` must be the same
        function of its inputs on every call with one key. Returns fresh
        tensors. The launches of a switch's branches are not counted here
        (``count_branches``)."""
        marks = profiling.current_marks()
        static_in = self._static_inputs(inputs)
        for dst, src in zip(static_in, inputs):
            if dst is not None:
                dst.copy_(src)
        entry = self._entries.get(key)
        if entry is None:
            with switch.runner(switch.run_every_branch), \
                    profiling.recording(None):
                for _ in range(WARMUP_CALLS):
                    fn(*static_in)
                    self.warmups += 1
            captured = (None if marks is None
                        else profiling.Marks(marks.tracer, self.device))
            with profiling.recording(captured):
                entry = _Entry(*self._capture(fn, static_in), captured)
            self._entries[key] = entry
            self.captures += 1
        if marks is None:
            entry.replay()
        else:
            with marks.tracer.span("graph.launch"), \
                    profiling.recording(None):
                entry.replay()
            marks.take(entry.marks)
        self.replays += 1
        _add_counts(entry.launches)
        return [None if o is None else o.clone() for o in entry.outputs]

    def has_switches(self, key: Tuple) -> bool:
        return bool(self._entries[key].switches)

    def count_branches(self, key: Tuple, values: Sequence[int]) -> None:
        """Count the launches of the branches one replay of ``key`` ran,
        given the switches' values in run order as the host read them back
        (the step's FrameResult holds what they were computed from)."""
        for (branches, counts), v in zip(self._entries[key].switches,
                                         values):
            k = switch.branch_index(int(v), branches)
            if k is not None:
                _add_counts(counts[k])
