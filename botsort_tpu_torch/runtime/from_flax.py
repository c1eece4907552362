"""Carry a Flax variable tree into the port's modules.

The port's modules name their children after the JAX package's Flax
modules (``CSPDarknet_0/CSPLayer_1/Bottleneck_0/ConvBN_1/Conv_0``), so a
leaf's path names its target module directly. The tree is nested dicts
of numpy arrays, ``{"params": ..., "batch_stats": ...}`` (as
``jax.device_get`` returns a Flax variable dict); nothing here imports
JAX. Layouts convert per module type:

  Conv2d     kernel HWIO -> weight OIHW (grouped and depthwise alike:
             (3, 3, 1, C) -> (C, 1, 3, 3)), bias as is
  Linear     kernel (in, out) -> weight (out, in), bias as is
  BatchNorm  scale/bias/mean/var -> weight/bias/running_mean/running_var
  GeMPool    p

Any Flax leaf without a target, any shape mismatch and any module
tensor left unfilled raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from botsort_tpu_torch.models.common import BatchNorm
from botsort_tpu_torch.models.fastreid import GeMPool

_IDENTITY = lambda a: a  # noqa: E731
_LEAVES = {
    nn.Conv2d: {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),
                "bias": ("bias", _IDENTITY)},
    nn.Linear: {"kernel": ("weight", lambda a: a.T),
                "bias": ("bias", _IDENTITY)},
    BatchNorm: {"scale": ("weight", _IDENTITY),
                "bias": ("bias", _IDENTITY),
                "mean": ("running_mean", _IDENTITY),
                "var": ("running_var", _IDENTITY)},
    GeMPool: {"p": ("p", _IDENTITY)},
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def load_flax_variables(module: nn.Module,
                        variables: Mapping[str, Mapping[str, Any]]
                        ) -> nn.Module:
    """Copy every leaf of ``variables`` into ``module`` (in place, into
    the module's own dtypes and device); returns the module."""
    targets: Dict[str, torch.Tensor] = dict(module.named_parameters())
    targets.update(module.named_buffers())
    filled = set()
    for collection, tree in variables.items():
        for path, arr in _leaves(tree):
            *mod_path, leaf = path
            where = f"{collection}/{'/'.join(path)}"
            sub = module
            for name in mod_path:
                if name not in sub._modules:
                    raise KeyError(f"{where}: no module {name!r} in "
                                   f"{type(sub).__name__}")
                sub = sub._modules[name]
            table = next((_LEAVES[t] for t in type(sub).__mro__
                          if t in _LEAVES), {})
            if leaf not in table:
                raise KeyError(f"{where}: {type(sub).__name__} has no "
                               f"counterpart for {leaf!r}")
            attr, convert = table[leaf]
            key = ".".join(mod_path + [attr])
            value = torch.from_numpy(np.array(
                convert(np.asarray(arr, np.float32)), order="C"))
            dst = targets[key]
            if tuple(dst.shape) != tuple(value.shape):
                raise ValueError(f"{where}: shape {tuple(value.shape)} != "
                                 f"{key} {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(value)
            filled.add(key)
    left = sorted(set(targets) - filled)
    if left:
        raise KeyError(f"{len(left)} module tensors not in the Flax tree: "
                       f"{left[:5]}")
    return module
