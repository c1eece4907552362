"""Small constant tensors, built once per (value, dtype, device).

``torch.tensor(python_value, device="cuda")`` stages the value in pageable
host memory and copies it to the card, which makes the host wait; inside
a CUDA-graph capture it is an error. The frame step therefore takes its
few constants (image means, cost limits, infinities) from this cache: the
first call builds the tensor, every later call returns the same one. The
tensors are shared, so callers never write to them.
"""

from __future__ import annotations

import functools
from typing import Any

import torch


def _freeze(value: Any):
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


@functools.lru_cache(maxsize=None)
def _build(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def const(value: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """The cached read-only tensor of ``value`` (a Python scalar or a
    nested list or tuple of scalars) in ``dtype`` on ``device``."""
    return _build(_freeze(value), dtype, torch.device(device))
