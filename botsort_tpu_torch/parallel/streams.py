"""Multi-stream tracking over several devices: data parallelism over
streams (port of botsort_tpu/parallel/streams.py).

Per-stream tracker state has no coupling across streams, so the streams
split into ``len(mesh)`` equal slices, each device runs
``frame_step_batched`` on its slice with a replica of the bundle on that
device, and no collective runs at any step. A "mesh" here is a tuple of
``torch.device``s (``make_mesh``); a device may appear more than once (two
slices on one card, or ``(cpu, cpu)`` in the tests), and then its slices
share one bundle. One bucket pair is shared by every slice: the host sizes
it by the largest live count over all streams, so every device runs the
same step. The step issues every slice's work before it gathers any
result, so the devices run concurrently.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import torch

from botsort_tpu_torch.config import NMSConfig, PipelineConfig, TrackerConfig
from botsort_tpu_torch.pipeline.frame_step import (
    FrameResult,
    ModelBundle,
    frame_step_batched,
)
from botsort_tpu_torch.track.cascade import TrackOutputs
from botsort_tpu_torch.track.state import TrackStore, empty_stores

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> Mesh:
    """The first ``n_devices`` devices of a type (all of them by default).
    ``cuda`` counts the cards and raises for more than there are; ``cpu``
    has one device, which a mesh of n repeats n times."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if count == 0 or not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} CUDA devices asked for, "
                             f"{count} present")
        return tuple(torch.device("cuda", i) for i in range(n))
    if device_type == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    raise ValueError(f"make_mesh: unknown device type {device_type!r}")


def replicate_bundle(bundle: ModelBundle, mesh: Sequence[torch.device]
                     ) -> List[ModelBundle]:
    """One bundle per mesh entry: ``bundle`` itself on its own device, one
    copy per other distinct device (copied once, shared by its slices)."""
    copies = {bundle.device: bundle}
    out = []
    for dev in mesh:
        dev = torch.device(dev)
        if dev not in copies:
            rep = copy.deepcopy(bundle)
            for model in (rep.detector, rep.body_encoder, rep.face_encoder):
                model.to(dev)
            copies[dev] = rep
        out.append(copies[dev])
    return out


def split_streams(n_streams: int, mesh: Sequence[torch.device]) -> int:
    """Streams per slice; ``n_streams`` must split evenly."""
    if n_streams % len(mesh):
        raise ValueError(f"{n_streams} streams do not split over "
                         f"{len(mesh)} devices")
    return n_streams // len(mesh)


def init_stream_stores(mesh: Sequence[torch.device], n_streams: int,
                       tracker_cfg: TrackerConfig) -> List[TrackStore]:
    """Per-slice stacked track stores, each on its slice's device."""
    per = split_streams(n_streams, mesh)
    return [empty_stores(tracker_cfg, per, torch.device(dev)) for dev in mesh]


def gather_results(results: Sequence[FrameResult],
                   device: torch.device) -> FrameResult:
    """The slices' FrameResults as one with the leading stream dim, on
    ``device``."""
    def cat(fields):
        return torch.cat([f.to(device, non_blocking=True) for f in fields])

    n = len(FrameResult._fields) - 1
    head = [cat([r[i] for r in results]) for i in range(n)]
    tracks = TrackOutputs(*[cat([r.tracks[i] for r in results])
                            for i in range(len(TrackOutputs._fields))])
    return FrameResult(*head, tracks)


def make_multi_stream_step(mesh: Sequence[torch.device],
                           tracker_cfg: TrackerConfig, nms_cfg: NMSConfig,
                           pipe_cfg: PipelineConfig):
    """Build the multi-device step.

    Returned fn: (replicas, stores, frames [S, H, W, 3], reid_bucket=None,
    face_bucket=None) -> (stores, FrameResult with the
    leading stream dim on ``mesh[0]``). ``replicas`` is
    ``replicate_bundle(bundle, mesh)`` (JAX passes the bundle, which jit
    replicates; here the copies are made once by the caller), ``stores``
    ``init_stream_stores``' list. S must be a multiple of the mesh size;
    slice k's frames go to ``mesh[k]`` and its step is enqueued there
    before any result is gathered."""
    mesh = tuple(torch.device(d) for d in mesh)

    def step(replicas, stores, frames, reid_bucket=None, face_bucket=None):
        per = split_streams(frames.shape[0], mesh)
        out = [frame_step_batched(
            replicas[k], stores[k],
            frames[k * per:(k + 1) * per].to(dev, non_blocking=True),
            tracker_cfg, nms_cfg, pipe_cfg, None, reid_bucket=reid_bucket,
            face_bucket=face_bucket)
            for k, dev in enumerate(mesh)]
        return ([s for s, _ in out],
                gather_results([r for _, r in out], mesh[0]))

    return step
