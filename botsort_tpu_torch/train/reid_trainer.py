"""Batch-hard triplet-loss trainer for the ReID encoders, data-parallel over
devices (port of botsort_tpu/train/reid_trainer.py).

Same names as the JAX module: ``TrainState(params, opt_state, step)``,
``batch_hard_triplet_loss`` and ``make_trainer(model, mesh,
learning_rate)`` returning ``(init_fn, train_step)``.

What it trains is what the JAX trainer trains: ``model.init``'s whole
variable tree there, so here every parameter of the model and every
``BatchNorm``'s ``running_mean`` and ``running_var`` (the norms keep
normalising with their running statistics, Flax's
``use_running_average=True``, and those statistics are leaves that
gradient descent moves). They go through ``torch.func.functional_call``
as float32 master tensors. The forward computes in the model's compute
dtype, the dtype its convolution weights have when ``make_trainer`` is
called (``cast_compute``): convolution and dense weights and dense biases
are cast to it inside the forward, as Flax casts at each use, so their
gradients land in float32; norm parameters and statistics stay float32.
On the card the norms are kernel K6 forward and kernel K6b backward
(models/bn_act.py); convolutions and their gradients are cuDNN's.

The optimiser is optax's ``adamw`` at its defaults (b1 0.9, b2 0.999, eps
1e-8, weight decay 1e-4 on every leaf), as ``torch.optim.AdamW`` with those
settings: the same update, ``p -= lr * (m_hat / (sqrt(v_hat) + eps) +
wd * p)``, in another order of float32 operations.

Data parallel in one process over ``mesh``, a tuple of devices
(parallel/streams.py::make_mesh): the global batch splits into equal
slices, each replica runs the forward on its slice, the features are
gathered on ``mesh[0]`` and the loss is taken over the whole batch (as the
JAX step computes it from sharded inputs, not as a mean of per-shard
losses); backward runs through the gather, the replicas' gradients are
summed on ``mesh[0]``, the optimiser steps there, and the parameters are
copied back to the replicas. With one device no copies are made.
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from botsort_tpu_torch.models.common import BatchNorm
from botsort_tpu_torch.models.transreid import refuse

# optax.adamw's defaults.
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # float32 masters on mesh[0], by name
    opt_state: torch.optim.AdamW      # the optimiser over ``params``
    step: int


def batch_hard_triplet_loss(features: torch.Tensor, labels: torch.Tensor,
                            margin: float = 0.3) -> torch.Tensor:
    """Hermans et al. batch-hard triplet loss on L2-normalised features.

    features: [N, D] (normalised); labels: [N] int. The hardest positive and
    negative are ``amax`` / ``amin``, whose gradient splits evenly between
    ties, as ``jnp.max`` / ``jnp.min``'s does."""
    dist = 1.0 - features @ features.T                         # [N, N]
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    pos_mask = same & ~eye
    neg_mask = ~same
    inf = torch.full_like(dist, float("inf"))
    hardest_pos = torch.amax(torch.where(pos_mask, dist, -inf), dim=1)
    hardest_neg = torch.amin(torch.where(neg_mask, dist, inf), dim=1)
    valid = pos_mask.any(dim=1) & neg_mask.any(dim=1)
    loss = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / torch.clamp(valid.sum(), min=1)


def trained_names(model: nn.Module) -> Tuple[str, ...]:
    """The leaves the trainer trains: every parameter, then every
    BatchNorm's running mean and variance (JAX's ``batch_stats``)."""
    names = [n for n, _ in model.named_parameters()]
    for prefix, m in model.named_modules():
        if isinstance(m, BatchNorm):
            dot = prefix + "." if prefix else ""
            names += [dot + "running_mean", dot + "running_var"]
    return tuple(names)


def _cast_names(model: nn.Module) -> frozenset:
    """Leaves the forward casts to the compute dtype: convolution and dense
    weights and dense biases."""
    out = []
    for prefix, m in model.named_modules():
        dot = prefix + "." if prefix else ""
        if isinstance(m, nn.Conv2d):
            out.append(dot + "weight")
        elif isinstance(m, nn.Linear):
            out += [dot + "weight", dot + "bias"]
    return frozenset(out)


def _compute_dtype(model: nn.Module) -> torch.dtype:
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            return m.weight.dtype
    return torch.float32


def make_trainer(model: nn.Module, mesh: Sequence[torch.device],
                 learning_rate: float = 3.5e-4):
    """Build ``(init_fn, train_step)`` for data-parallel ReID fine-tuning.

    ``init_fn()`` takes the model's current weights (the port's modules own
    theirs, so there is no seed to draw from) as float32 masters on
    ``mesh[0]``. ``train_step(state, images, labels) -> (state, loss)``
    updates ``state`` in place (the JAX step donates it) and returns it with
    the step count advanced, and the loss of the whole batch as a 0-d
    tensor on ``mesh[0]``. images [N, H, W, 3] and labels [N], N a multiple
    of ``len(mesh)``, on any device: each slice is copied to its replica's.
    A TransReID encoder is refused (NotImplementedError): the trainer is
    the JAX trainer's, written for the convolutional encoders.
    """
    refuse(model, "make_trainer")
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("make_trainer needs at least one device")
    names = trained_names(model)
    cast = _cast_names(model)
    dtype = _compute_dtype(model)
    home = mesh[0]
    # One module a distinct device: functional_call replaces every leaf,
    # so a replica's own tensors only give it its device and structure.
    modules = {home: model.to(home)}
    for dev in mesh:
        if dev not in modules:
            modules[dev] = copy.deepcopy(model).to(dev)
    # Per distinct device other than home: the replica of the masters.
    replicas: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def init_fn() -> TrainState:
        state = dict(model.named_parameters())
        state.update(model.named_buffers())
        params = {n: state[n].detach().to(home, torch.float32).clone()
                  for n in names}
        opt = torch.optim.AdamW(list(params.values()), lr=learning_rate,
                                betas=BETAS, eps=EPS,
                                weight_decay=WEIGHT_DECAY)
        replicas.clear()
        for dev in mesh:
            if dev != home and dev not in replicas:
                replicas[dev] = {n: p.to(dev) for n, p in params.items()}
        return TrainState(params, opt, 0)

    def forward(dev, leaves, images):
        args = {n: (t.to(dtype) if n in cast else t)
                for n, t in leaves.items()}
        return torch.func.functional_call(modules[dev], args, (images,))

    def value_and_grad(state: TrainState, images: torch.Tensor,
                       labels: torch.Tensor):
        """(loss of the whole batch, {name: gradient summed over the
        replicas, on mesh[0]}) at ``state``'s parameters."""
        n = images.shape[0]
        if n % len(mesh):
            raise ValueError(f"batch of {n} does not split over "
                             f"{len(mesh)} devices")
        k = n // len(mesh)
        leaves, feats = [], []
        for i, dev in enumerate(mesh):
            src = state.params if dev == home else replicas[dev]
            mine = {name: t.detach().requires_grad_() for name, t in
                    src.items()}
            leaves.append(mine)
            feats.append(forward(dev, mine, images[i * k:(i + 1) * k].to(
                dev, non_blocking=True)).to(home))
        loss = batch_hard_triplet_loss(torch.cat(feats),
                                       labels.to(home, non_blocking=True))
        loss.backward()
        grads = {}
        for name in state.params:
            grad = leaves[0][name].grad
            for mine in leaves[1:]:
                grad = grad + mine[name].grad.to(home)
            grads[name] = grad
        return loss.detach(), grads

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        loss, grads = value_and_grad(state, images, labels)
        for name, p in state.params.items():
            p.grad = grads[name]
        state.opt_state.step()
        for p in state.params.values():
            p.grad = None
        for rep in replicas.values():
            for name, t in rep.items():
                t.copy_(state.params[name], non_blocking=True)
        return TrainState(state.params, state.opt_state,
                          state.step + 1), loss

    # The gradient half of the step, for callers that check it apart from
    # the optimiser.
    train_step.value_and_grad = value_and_grad
    return init_fn, train_step
