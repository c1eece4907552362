"""Finds a cell's files by the names BENCHMARK.json gives them.

Every configuration, traffic mix, per-layer metric and set of output
limits is a file of its own, found by name:

- ``configs/<config>.json``: the networks (their ``models`` entries, see
  networks.py), their input sizes and dtype;
- ``traffic/<traffic>.json``: the facade, streams, thresholds, buckets,
  frames, the load guard and the correctness sample;
- ``metrics/<metric>.py``: a reader with ``read(records) -> float | None``;
- ``limits/<workload>.json``: the limit of each number the correctness
  check compares, with the readings it was set from.

A later cell, mix or metric is a new file; no file here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Callable, Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r} at {path}")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    return _json("configs", name)


def traffic(name: str) -> Dict[str, Any]:
    return _json("traffic", name)


def limits(workload: str) -> Dict[str, Any]:
    return _json("limits", workload)


def metric_reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py`` (a metric name may
    hold dots, so the file is loaded by path)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no metric reader for {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict[str, Any], name: str, kind: str):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the
    workload reports: those without a ``workloads`` key and those that
    list it."""
    return [m for m in bench[kind]
            if name in m.get("workloads", [name])]
