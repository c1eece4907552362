"""The three networks of a configuration, as its ``models`` entry names
them.

A configuration file names each of its networks (``detector``, ``body``,
``face``) by one entry:

- ``program``: ``"botsort_tpu_torch.<module>:<Class>"``, the port's class,
  imported by name in portbench/program.py alone;
- ``reference``: ``"portbench.reference.<module>:<Class>"``, its plain
  float32 copy, imported by name here (by module name, never by file
  path, so that ``nets.BatchNorm`` and the other classes the recipe and
  the counts look for are the same objects for every family);
- ``args``: the constructor arguments of both classes (JSON lists become
  tuples);
- ``float32_norms`` (optional): the module paths of the norms the port
  runs on float32 inputs, for the analytic counts.

No file lists architectures: a new family is a class on each side and a
configuration that names them.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Tuple

import torch

NETWORKS = ("detector", "body", "face")
ENCODERS = ("body", "face")
PROGRAM = "botsort_tpu_torch."
REFERENCE = "portbench.reference."


def split(spec: str, prefix: str) -> Tuple[str, str]:
    """(module, class) of ``"<module>:<Class>"``, the module under
    ``prefix``."""
    module, sep, name = spec.partition(":")
    if not (sep and name and module.startswith(prefix)):
        raise ValueError(f"{spec!r} is not '{prefix}<module>:<Class>'")
    return module, name


def args_of(entry: Dict[str, Any]) -> Dict[str, Any]:
    """The entry's constructor arguments, JSON lists as tuples."""
    def tupled(v):
        return tuple(tupled(x) for x in v) if isinstance(v, list) else v
    return {k: tupled(v) for k, v in entry.get("args", {}).items()}


def reference_network(entry: Dict[str, Any]) -> torch.nn.Module:
    """The reference's module of one ``models`` entry, on the meta
    device."""
    module, name = split(entry["reference"], REFERENCE)
    # Imported before the meta context, which would hold any tensor the
    # module makes at import.
    cls = getattr(importlib.import_module(module), name)
    with torch.device("meta"):
        return cls(**args_of(entry))


def reference(cfg: Dict[str, Any]):
    """(detector, body encoder, face encoder) of the reference, on the meta
    device."""
    return tuple(reference_network(cfg["models"][n]) for n in NETWORKS)


def feature_dims(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The tracker's embedding widths, ``{"body_feature_dim": ...,
    "face_feature_dim": ...}``: each encoder's ``feature_dim`` attribute,
    the width of its output, read off its meta module (a forward, even on
    the meta device, would cost set-up seconds of lazy imports)."""
    return {f"{n}_feature_dim":
            int(reference_network(cfg["models"][n]).feature_dim)
            for n in ENCODERS}
