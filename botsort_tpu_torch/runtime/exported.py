"""Exported frame-step programs (port of botsort_tpu/runtime/exported.py).

The JAX package serialises its jitted step per (resolution, bucket pair)
with ``jax.export``, so that a serving host runs the program without the
model code and without tracing it again. The port does the same with
``torch.export``: the step is traced once per program into an
``ExportedProgram`` and written with ``torch.export.save``; a serving host
loads it (``torch.export.load``) and calls it, and on a card the facade's
graph cache captures and replays it like the live step.

A program is a function of flat tuples of tensors::

    program(weights, constants, store, frames) -> (*store, *result)

- ``weights``: the three networks' state-dict tensors, in the manifest's
  order. They are call arguments, not part of the file: one checkpoint
  serves every program and any fine-tune of the same architecture.
- ``constants``: the inference constants derived from the weights (each
  batch norm's ``mul``, K5's taps, K4's fold, flattened by
  models/fastreid_fused.py::fold_tensors), computed once at load by the
  same methods the live models use (``inference_constant``), never once a
  step.
- ``store``: the TrackStore's fields that are present (a leading [B] in a
  batched program); ``frames``: [H, W, 3] uint8 ([B, H, W, 3] batched).
- The outputs are the new store's fields, then the FrameResult's fields
  and its TrackOutputs' fields, in the manifest's order (``outputs``):
  the analogue of the JAX package's registered named tuples.

The kernels appear in the program as the custom ops
``torch.ops.botsort_tpu_torch.*`` (K1/K2 ``cascade_solve``, K6 ``bn_act``,
with lowered encoders K4 ``stem_stage1`` and K5 ``dw_conv3x3``): their CUDA
implementation is the kernel, their CPU implementation the plain version,
so a program exported on one platform runs only there.

The fixed NMS iteration count of a step can fall short, and the facades
then re-run the step with ``nms_iters = pre_nms_top_k``
(pipeline/host.py): every (resolution, bucket pair) has both programs.

Artifact directory (written by cli/export.py)::

    manifest.json
    step_{H}x{W}_b{B}_f{F}_nms{fixed|full}.pt2
    step_s{S}_{H}x{W}_b{B}_f{F}_nms{fixed|full}.pt2   (--streams S)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.models.fastreid_fused import (
    FoldedStemStage1,
    fold_tensors,
    folded_from,
)
from botsort_tpu_torch.pipeline import host
from botsort_tpu_torch.pipeline.host import bucket_pairs
from botsort_tpu_torch.pipeline.frame_step import (
    FrameResult,
    ModelBundle,
    frame_step,
    frame_step_batched,
    reid_bucket_set,
)
from botsort_tpu_torch.track.cascade import TrackOutputs
from botsort_tpu_torch.track.state import TrackStore, empty_store, empty_stores

FORMAT = "torch.export ExportedProgram (torch.export.save)"
MANIFEST = "manifest.json"
NETS = ("detector", "body_encoder", "face_encoder")
STORE_FIELDS = tuple(f.name for f in dataclasses.fields(TrackStore))
RESULT_FIELDS = FrameResult._fields[:-1]
TRACK_FIELDS = TrackOutputs._fields


class _Nets(nn.Module):
    """The bundle's networks under one module, so that one state dict
    names all their tensors ("detector.", "body_encoder.", ...)."""

    def __init__(self, bundle: ModelBundle):
        super().__init__()
        for name in NETS:
            setattr(self, name, getattr(bundle, name))

    def forward(self, fn, *args):
        return fn(ModelBundle(*(getattr(self, n) for n in NETS)), *args)


def weight_names(bundle: ModelBundle) -> List[str]:
    return list(_Nets(bundle).state_dict())


def bundle_weights(bundle: ModelBundle) -> Tuple[torch.Tensor, ...]:
    """The weights a program takes, in ``weight_names`` order."""
    return tuple(t.detach() for t in _Nets(bundle).state_dict().values())


def inference_constants(bundle: ModelBundle
                        ) -> Tuple[Tuple[torch.Tensor, ...], List[list]]:
    """(tensors, spec): the inference constants a program takes, computed
    by the live models' own ``inference_constant`` methods, and for each
    module that has one [name, number of tensors, K4 plan or None]."""
    tensors, spec = [], []
    for name, m in _Nets(bundle).named_modules():
        value = (m.inference_constant()
                 if hasattr(m, "inference_constant") else None)
        if value is None:
            continue
        if isinstance(value, FoldedStemStage1):
            flat, plan = fold_tensors(value)
            tensors += flat
            spec.append([name, len(flat), plan])
        else:
            tensors.append(value)
            spec.append([name, 1, None])
    return tuple(t.detach() for t in tensors), spec


@contextlib.contextmanager
def _bound(nets: _Nets, spec, constants):
    """Bind ``constants`` to their modules' ``bound_constant`` for the
    duration (the trace reads them there instead of deriving them)."""
    modules = dict(nets.named_modules())
    at = 0
    try:
        for name, count, plan in spec:
            part = constants[at:at + count]
            at += count
            modules[name].bound_constant = (
                folded_from(part, plan) if plan is not None else part[0])
        yield
    finally:
        for name, _, _ in spec:
            modules[name].bound_constant = None


def _present(store: TrackStore) -> Tuple[torch.Tensor, ...]:
    return tuple(t for t in host._store_tensors(store) if t is not None)


def store_names(tracker_cfg: TrackerConfig) -> List[str]:
    """The TrackStore fields a program takes and gives (the present ones)."""
    return [n for n, t in zip(STORE_FIELDS, host._store_tensors(
        empty_store(tracker_cfg))) if t is not None]


def _store_of(fields, names: Sequence[str]) -> TrackStore:
    given = dict(zip(names, fields))
    return TrackStore(*(given.get(n) for n in STORE_FIELDS))


class _Program(nn.Module):
    """What is traced: one step as a function of flat tuples. It has no
    parameters of its own; the networks' tensors are swapped for the
    ``weights`` argument (``torch.func.functional_call``) and their
    inference constants bound to the ``constants`` argument."""

    def __init__(self, bundle, names, spec, fields, step):
        super().__init__()
        # Not a submodule: its tensors must not become the program's own.
        object.__setattr__(self, "_nets", _Nets(bundle))
        self._names = list(names)
        self._spec = spec
        self._fields = list(fields)
        self._stepfn = step

    def forward(self, weights, constants, store, frames):
        def run(bundle, store, frames):
            new, result = self._stepfn(
                bundle, _store_of(store, self._fields), frames)
            return (*_present(new), *host._result_tensors(result))

        with _bound(self._nets, self._spec, constants):
            return torch.func.functional_call(
                self._nets, dict(zip(self._names, weights)),
                (run, store, frames))


def _check_exportable(pipe_cfg: PipelineConfig) -> None:
    if pipe_cfg.enable_gmc:
        raise ValueError(
            "exported programs take no camera motion: export and serve "
            "with enable_gmc=False, or use the live pipeline")
    if not pipe_cfg.host_bucket_dispatch:
        raise ValueError(
            "exported serving requires host_bucket_dispatch=True (one "
            "program per bucket pair)")


def export_frame_step(bundle: ModelBundle, tracker_cfg: TrackerConfig,
                      nms_cfg: NMSConfig, pipe_cfg: PipelineConfig,
                      frame_hw: Tuple[int, int], reid_bucket: int,
                      face_bucket: int, nms_iters: Optional[int] = None,
                      streams: int = 0) -> torch.export.ExportedProgram:
    """Trace one (resolution, bucket pair, NMS count) step on the bundle's
    device into an ExportedProgram: ``frame_step`` (``streams`` = 0) or
    ``frame_step_batched`` over ``streams`` streams."""
    _check_exportable(pipe_cfg)
    dev = bundle.device
    h, w = frame_hw
    if streams:
        store = empty_stores(tracker_cfg, streams, dev)
        frames = torch.zeros((streams, h, w, 3), dtype=torch.uint8,
                             device=dev)
        fn = frame_step_batched
    else:
        store = empty_store(tracker_cfg, dev)
        frames = torch.zeros((h, w, 3), dtype=torch.uint8, device=dev)
        fn = frame_step

    def step(b, store, frames):
        return fn(b, store, frames, tracker_cfg, nms_cfg, pipe_cfg, None,
                  reid_bucket=reid_bucket, face_bucket=face_bucket,
                  nms_iters=nms_iters)

    constants, spec = inference_constants(bundle)
    program = _Program(bundle, weight_names(bundle), spec,
                       store_names(tracker_cfg), step)
    with torch.no_grad():
        ep = torch.export.export(
            program, (bundle_weights(bundle), constants, _present(store),
                      frames), strict=False)
    # The example inputs hold the weights: they are not part of the file.
    ep.example_inputs = None
    return ep


def save_program(ep: torch.export.ExportedProgram, path: str) -> int:
    """Write ``ep``; returns the file's size in bytes."""
    torch.export.save(ep, path)
    return os.path.getsize(path)


def artifact_name(frame_hw: Tuple[int, int], reid_bucket: int,
                  face_bucket: int, nms_iters: Optional[int],
                  streams: int = 0) -> str:
    h, w = frame_hw
    s = f"s{streams}_" if streams else ""
    nms = "fixed" if nms_iters is None else "full"
    return f"step_{s}{h}x{w}_b{reid_bucket}_f{face_bucket}_nms{nms}.pt2"


def platform_of(device: torch.device) -> Dict[str, Any]:
    device = torch.device(device)
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device)}
    return {"type": device.type}


def describe_io(bundle: ModelBundle, tracker_cfg: TrackerConfig,
                weights: Sequence[torch.Tensor],
                constants: Sequence[torch.Tensor], spec: List[list]
                ) -> Dict[str, Any]:
    """The manifest's input and output layout of the programs of one
    bundle and tracker configuration, given the bundle's weights and
    ``inference_constants``."""
    names = store_names(tracker_cfg)

    def layout(names, tensors):
        return [[n, list(t.shape), str(t.dtype).replace("torch.", "")]
                for n, t in zip(names, tensors)]

    const_names = [f"{name}.{i}" if count > 1 else name
                   for name, count, _ in spec for i in range(count)]
    return {
        "inputs": {
            "weights": layout(weight_names(bundle), weights),
            "constants": layout(const_names, constants),
            "constant_modules": spec,
            "store": names,
            "frames": "[H, W, 3] uint8; [S, H, W, 3] in a batched program",
        },
        "outputs": {"store": names, "result": list(RESULT_FIELDS),
                    "tracks": list(TRACK_FIELDS)},
    }


def export_all(bundle: ModelBundle, tracker_cfg: TrackerConfig,
               nms_cfg: NMSConfig, pipe_cfg: PipelineConfig, out_dir: str,
               resolutions: Sequence[Tuple[int, int]], streams: int = 0,
               buckets: Optional[Sequence[int]] = None, mini: bool = False,
               one_stream: bool = True, log=print) -> Dict[str, Any]:
    """Export both NMS programs of every (resolution, bucket pair): at one
    stream (unless ``one_stream`` is False) and, with ``streams``, at that
    many streams; write the manifest. ``buckets``: the bucket set (default
    ``reid_bucket_set``'s). Returns the manifest."""
    _check_exportable(pipe_cfg)
    if buckets is None:
        buckets = reid_bucket_set(tracker_cfg, nms_cfg, pipe_cfg)
    os.makedirs(out_dir, exist_ok=True)
    kinds = ([0] if one_stream else []) + ([streams] if streams else [])
    entries = {0: [], streams: []}
    for hw in resolutions:
        for b, fb in bucket_pairs(buckets):
            for iters in (None, nms_cfg.pre_nms_top_k):
                for s in kinds:
                    t0 = time.perf_counter()
                    ep = export_frame_step(bundle, tracker_cfg, nms_cfg,
                                           pipe_cfg, hw, b, fb, iters, s)
                    name = artifact_name(hw, b, fb, iters, s)
                    size = save_program(ep, os.path.join(out_dir, name))
                    dt = time.perf_counter() - t0
                    entry = {"file": name, "frame_hw": list(hw),
                             "reid_bucket": b, "face_bucket": fb,
                             "nms_iters": iters, "bytes": size,
                             "export_seconds": dt}
                    if s:
                        entry["streams"] = s
                    entries[s].append(entry)
                    log(f"exported {name} ({size} bytes, {dt:.3f} s)")
    manifest = {
        "format": FORMAT,
        "call": "program(weights, constants, store, frames) -> "
                "(*store, *result, *tracks)",
        "tracker_cfg": dataclasses.asdict(tracker_cfg),
        "nms_cfg": dataclasses.asdict(nms_cfg),
        "pipe_cfg": dataclasses.asdict(pipe_cfg),
        "platform": platform_of(bundle.device),
        "torch_version": torch.__version__,
        "mini": mini,
        "buckets": list(buckets),
        **describe_io(bundle, tracker_cfg, bundle_weights(bundle),
                      *inference_constants(bundle)),
        "artifacts": entries[0],
        "batched_artifacts": entries[streams] if streams else [],
    }
    text = json.dumps(manifest, indent=1)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        f.write(text)
    return json.loads(text)


def _cfg_from_dict(cls, d):
    """A config dataclass from its manifest dict (JSON turns tuples into
    lists; the configs have no list fields)."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


def read_manifest(artifact_dir: str) -> Dict[str, Any]:
    with open(os.path.join(artifact_dir, MANIFEST)) as f:
        return json.load(f)


def manifest_configs(manifest: Dict[str, Any]
                     ) -> Tuple[TrackerConfig, NMSConfig, PipelineConfig]:
    return (_cfg_from_dict(TrackerConfig, manifest["tracker_cfg"]),
            _cfg_from_dict(NMSConfig, manifest["nms_cfg"]),
            _cfg_from_dict(PipelineConfig, manifest["pipe_cfg"]))


class Programs:
    """The programs of one artifact directory for one bundle: loaded at
    first use and kept (share one ``Programs`` between the pipelines of a
    server), called with the bundle's weights and inference constants,
    which are computed once, here."""

    def __init__(self, artifact_dir: str, bundle: ModelBundle,
                 manifest: Optional[Dict[str, Any]] = None):
        self.artifact_dir = artifact_dir
        self.manifest = manifest or read_manifest(artifact_dir)
        _check_exportable(manifest_configs(self.manifest)[2])
        want = self.manifest["platform"]["type"]
        if bundle.device.type != want:
            raise ValueError(
                f"the artifacts in {artifact_dir} were exported for "
                f"{self.manifest['platform']}, the bundle is on "
                f"{bundle.device}: export again on this platform")
        self.weights = bundle_weights(bundle)
        self.constants, spec = inference_constants(bundle)
        io = describe_io(bundle, manifest_configs(self.manifest)[0],
                         self.weights, self.constants, spec)
        for part in ("weights", "constants"):
            if io["inputs"][part] != self.manifest["inputs"][part]:
                raise ValueError(
                    f"the bundle's {part} (names, shapes, dtypes) differ "
                    f"from those the artifacts in {artifact_dir} were "
                    "exported with")
        self.store_names = self.manifest["inputs"]["store"]
        self.buckets = list(self.manifest["buckets"])
        self._files = {}
        for e in self.manifest["artifacts"] + \
                self.manifest["batched_artifacts"]:
            key = (e.get("streams", 0), tuple(e["frame_hw"]),
                   e["reid_bucket"], e["face_bucket"], e["nms_iters"])
            self._files[key] = e["file"]
        self._loaded: Dict[Tuple, Any] = {}
        self.load_seconds = 0.0

    def streams(self) -> List[int]:
        return sorted({k[0] for k in self._files})

    def resolutions(self, streams: int = 0) -> List[Tuple[int, int]]:
        return sorted({k[1] for k in self._files if k[0] == streams})

    def check_complete(self, streams: int, nms_full: int) -> None:
        """Every bucket pair of every exported resolution has both NMS
        programs at ``streams``: a facade's re-run always finds one."""
        if not self.resolutions(streams):
            raise ValueError(
                f"no programs for {streams or 1} stream(s) in "
                f"{self.artifact_dir} (cli/export.py --streams)")
        for hw in self.resolutions(streams):
            for b, fb in bucket_pairs(self.buckets):
                for iters in (None, nms_full):
                    if (streams, hw, b, fb, iters) not in self._files:
                        raise ValueError(
                            f"{self.artifact_dir} lacks the program for "
                            f"{hw}, buckets ({b}, {fb}), nms_iters "
                            f"{iters}: export again")

    def _load(self, streams, hw, reid_bucket, face_bucket, nms_iters):
        key = (streams, tuple(hw), reid_bucket, face_bucket, nms_iters)
        hit = self._loaded.get(key)
        if hit is None:
            name = self._files.get(key)
            if name is None:
                raise KeyError(
                    f"no exported program for {streams or 1} stream(s) at "
                    f"frame {tuple(hw)}; exported resolutions: "
                    f"{self.resolutions(streams)} (cli/export.py)")
            t0 = time.perf_counter()
            ep = torch.export.load(os.path.join(self.artifact_dir, name))
            hit = (ep, ep.module())
            self.load_seconds += time.perf_counter() - t0
            self._loaded[key] = hit
        return hit

    def exported_program(self, streams: int, hw: Tuple[int, int],
                         reid_bucket, face_bucket, nms_iters
                         ) -> torch.export.ExportedProgram:
        """The loaded ExportedProgram of one key (``streams`` 0: the
        one-stream program)."""
        return self._load(streams, hw, reid_bucket, face_bucket,
                          nms_iters)[0]

    def program(self, streams: int, hw: Tuple[int, int], reid_bucket,
                face_bucket, nms_iters):
        """The callable of one key, loaded at its first use."""
        return self._load(streams, hw, reid_bucket, face_bucket,
                          nms_iters)[1]

    def run(self, streams: int, store: TrackStore, frames: torch.Tensor,
            reid_bucket, face_bucket, nms_iters
            ) -> Tuple[TrackStore, FrameResult]:
        hw = tuple(frames.shape[-3:-1])
        mod = self.program(streams, hw, reid_bucket, face_bucket, nms_iters)
        out = mod(self.weights, self.constants, _present(store), frames)
        k = len(self.store_names)
        return _store_of(out[:k], self.store_names), \
            host._result_from(out[k:])


def load_pipeline(artifact_dir: str, bundle: ModelBundle,
                  graphs: bool = True, profile: bool = False,
                  programs: Optional[Programs] = None,
                  graph_cache=None) -> host.BoTSORTPipeline:
    """A ``BoTSORTPipeline`` whose step is the exported program of each
    (resolution, bucket pair, NMS count), called with ``bundle``'s weights.
    The bucket dispatch, the re-runs and the track assembly are the live
    facade's; the configurations and the bucket set come from the
    manifest. On a card the programs are captured and replayed from CUDA
    graphs like the live step (``graphs``). ``programs`` / ``graph_cache``:
    shared with other pipelines of one server. Refuses GMC,
    ``host_bucket_dispatch=False``, an incomplete export and a bundle on
    another platform; a frame of a resolution that was not exported raises
    KeyError listing those that were."""
    programs = programs or Programs(artifact_dir, bundle)
    tracker_cfg, nms_cfg, pipe_cfg = manifest_configs(programs.manifest)
    programs.check_complete(0, nms_cfg.pre_nms_top_k)

    class ExportedPipeline(host.BoTSORTPipeline):
        kind = "exported_frame"

        def _dispatch(self, store, frame_dev, gmc_affine, reid_bucket,
                      face_bucket, nms_iters=None):
            if gmc_affine is not None:
                raise ValueError("exported programs take no camera motion")
            return programs.run(0, store, frame_dev, reid_bucket,
                                face_bucket, nms_iters)

    pipe = ExportedPipeline(bundle, tracker_cfg, nms_cfg, pipe_cfg, graphs,
                            profile, graph_cache=graph_cache)
    pipe._buckets = programs.buckets
    pipe.programs = programs
    return pipe


def load_batched_pipeline(artifact_dir: str, bundle: ModelBundle,
                          n_streams: int, graphs: bool = True,
                          profile: bool = False,
                          programs: Optional[Programs] = None
                          ) -> host.BatchedBoTSORTPipeline:
    """A ``BatchedBoTSORTPipeline`` of ``n_streams`` streams served from
    the batched programs (cli/export.py ``--streams``); the multi-stream
    analogue of ``load_pipeline``, with the same refusals."""
    programs = programs or Programs(artifact_dir, bundle)
    tracker_cfg, nms_cfg, pipe_cfg = manifest_configs(programs.manifest)
    programs.check_complete(n_streams, nms_cfg.pre_nms_top_k)

    class ExportedBatchedPipeline(host.BatchedBoTSORTPipeline):
        kind = "exported_batched"

        def _dispatch(self, stores, frames_dev, gmc_affines, reid_bucket,
                      face_bucket, nms_iters=None):
            if gmc_affines is not None:
                raise ValueError("exported programs take no camera motion")
            return programs.run(n_streams, stores, frames_dev, reid_bucket,
                                face_bucket, nms_iters)

    pipe = ExportedBatchedPipeline(bundle, n_streams, tracker_cfg, nms_cfg,
                                   pipe_cfg, graphs, profile)
    pipe._buckets = programs.buckets
    pipe.programs = programs
    return pipe
