"""The system under test: the port's facade, built for one cell.

The only file of the benchmark that imports ``botsort_tpu_torch``. It
builds the port's class of each network the configuration's ``models``
entry names (``program``, imported by name under ``botsort_tpu_torch.``,
with the entry's ``args``), loads the seeded float32 state dicts through
``load_state_dict``, casts them to the configuration's dtype as the
port's own bundles are, and wraps them in the facade the traffic names,
with every threshold and size the benchmark's ``Settings`` holds.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

import numpy as np
import torch

from portbench import networks, trace
from portbench.reference.pipeline import Settings

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels,
    so that no build falls inside a capture or the window."""
    from botsort_tpu_torch.runtime import kernels

    kernels.load_all()


def bundle(states: List[Dict[str, torch.Tensor]], cfg: Dict, dtype: str,
           device):
    """The port's ModelBundle of the configuration's networks, holding
    ``states`` (detector, body, face)."""
    from botsort_tpu_torch.models.common import cast_compute
    from botsort_tpu_torch.pipeline.frame_step import ModelBundle

    models = []
    for name, state in zip(networks.NETWORKS, states):
        entry = cfg["models"][name]
        module, cls_name = networks.split(entry["program"],
                                          networks.PROGRAM)
        cls = getattr(importlib.import_module(module), cls_name)
        with torch.device("meta"):
            model = cls(**networks.args_of(entry))
        model.to_empty(device=device)
        model.load_state_dict(state)
        models.append(cast_compute(model, DTYPES[dtype]).eval()
                      .requires_grad_(False))
    return ModelBundle(*models)


def configs(s: Settings, traffic: Dict, cfg: Dict):
    """(TrackerConfig, NMSConfig, PipelineConfig) of the settings."""
    from botsort_tpu_torch.config import (NMSConfig, PipelineConfig,
                                          TrackerConfig)

    fields = {f.name for f in dataclasses.fields(TrackerConfig)}
    tracker_cfg = TrackerConfig(**{k: getattr(s, k) for k in fields})
    nms_cfg = NMSConfig(score_threshold=s.score_threshold,
                        iou_threshold=s.iou_threshold,
                        max_boxes_per_class=s.max_boxes_per_class,
                        num_classes=4, pre_nms_top_k=s.pre_nms_top_k)
    pipe_cfg = PipelineConfig(
        detector_input_hw=tuple(s.detector_input_hw),
        body_reid_input_hw=tuple(s.body_reid_input_hw),
        face_reid_input_hw=tuple(s.face_reid_input_hw),
        max_reid_batch=traffic["max_reid_batch"],
        compute_dtype=cfg["dtype"],
        crop_int8=s.crop_mode == "int8",
        host_bucket_dispatch=traffic["host_bucket_dispatch"])
    return tracker_cfg, nms_cfg, pipe_cfg


def facade(model_bundle, s: Settings, traffic: Dict, cfg: Dict):
    """The facade the traffic names; its buckets must be the traffic's."""
    from botsort_tpu_torch.pipeline import host
    from botsort_tpu_torch.pipeline.frame_step import reid_bucket_set

    cfgs = configs(s, traffic, cfg)
    buckets = reid_bucket_set(*cfgs)
    if traffic["host_bucket_dispatch"] and \
            buckets != traffic["buckets"]:
        raise ValueError(f"the program's buckets {buckets} are not the "
                         f"traffic's {traffic['buckets']}")
    kind = traffic["facade"]
    if kind == "BoTSORTPipeline":
        return host.BoTSORTPipeline(model_bundle, *cfgs, graphs=True)
    if kind == "BatchedBoTSORTPipeline":
        return host.BatchedBoTSORTPipeline(model_bundle, traffic["streams"],
                                           *cfgs, graphs=True)
    raise ValueError(f"unknown facade {kind!r}")


def graph_cache(pipe):
    """The facade's CUDA-graph cache (None where it runs eagerly)."""
    return getattr(pipe, "_graphs", None)


def store(pipe):
    """The facade's track store (one stream's, or B streams' stacked)."""
    return pipe.store if hasattr(pipe, "store") else pipe.stores


def as_dict(res) -> Dict[str, np.ndarray]:
    """A host FrameResult (the facade's ``last_result``) as a dict of
    numpy arrays (tracks' fields as ``tracks.<name>``)."""
    out = {k: v for k, v in res._asdict().items() if k != "tracks"}
    out.update({f"tracks.{k}": v for k, v in res.tracks._asdict().items()})
    return out


def step_counter():
    """A counter of step runs by graph key: patches ``GraphCache.run`` for
    the traced run (the key holds the two buckets the step ran at).
    Returns (counts dict, undo)."""
    from botsort_tpu_torch.pipeline import graphed

    counts: Dict[tuple, int] = {}
    original = graphed.GraphCache.run

    def run(self, key, fn, inputs):
        counts[key] = counts.get(key, 0) + 1
        return original(self, key, fn, inputs)

    graphed.GraphCache.run = run

    def undo():
        graphed.GraphCache.run = original
    return counts, undo


def spans():
    """record_function spans around the facade's layers, for a profiled
    run: ``host.upload``, ``graph.step`` (a step's enqueue, or its capture),
    ``host.readback`` (the wait for the card and the copy) and
    ``host.assemble``. Patches the classes; returns the undo."""
    from botsort_tpu_torch.pipeline import host

    def wrap(fn, name):
        def spanned(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return spanned

    upload, step, readback, assemble = trace.SPANS[1:]
    patches = [(host._Facade, "_upload", upload),
               (host._Facade, "_step", step),
               (host.PackedResult, "to_host", readback),
               (host, "assemble_tracks", assemble)]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, wrap(getattr(obj, attr), name))

    def undo():
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return undo
