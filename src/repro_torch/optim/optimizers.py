"""Minimal optax-style gradient-transformation optimizers — counterpart of
``repro/optim/optimizers.py``.

An ``Optimizer`` is (init, update):
    state          = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params         = apply_updates(params, updates)

Parameters, gradients and states are trees (nested dicts, tuples and
NamedTuples) of tensors. The state lives on the parameters' device:
moments as tensors, the step ``count`` as an int32 0-d tensor, so a
schedule is computed from it with torch ops and ``update`` never reads a
value back to the host. The states have the reference's structure
(``chain`` a tuple, ``AdamState(count, mu, nu)``), so they flatten to the
reference's checkpoint keys (``train/checkpoint.py``).

Each element's arithmetic follows the reference's order. Where JAX
promotes a bf16 tensor against an fp32 0-d array (a clip factor, a
scheduled learning rate) to fp32 and torch would keep bf16, the product
is taken in the promoted dtype (:func:`_scaled`), as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.utils import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]],
                     tuple[PyTree, PyTree]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(
        lambda p, u: (p + u.to(p.dtype)) if u is not None else p,
        params, updates)


def _scaled(g: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """g · factor (a 0-d tensor) in JAX's promoted dtype."""
    return g.to(torch.promote_types(g.dtype, factor.dtype)) * factor


# ---------------------------------------------------------------------------
# Primitive transforms
# ---------------------------------------------------------------------------

def scale(factor) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: g * factor, grads), state

    return Optimizer(init, update)


def _count(params: PyTree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Optimizer:
    def init(params):
        return _count(params)

    def update(grads, count, params=None):
        lr = schedule(count)
        return tree_map(lambda g: _scaled(g, -lr), grads), count + 1

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        leaves = [torch.sum(torch.square(g.to(torch.float32)))
                  for g in tree_leaves(grads)]
        gnorm = torch.sqrt(torch.sum(torch.stack(leaves)))
        factor = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
        return tree_map(lambda g: _scaled(g, factor), grads), state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: PyTree
    nu: PyTree


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return AdamState(_count(params), tree_map(zeros, params),
                         tree_map(zeros, params))

    def update(grads, state, params=None):
        count = state.count + 1
        grads32 = tree_map(lambda g: g.to(moment_dtype), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state.nu, grads32)
        bc1 = 1 - torch.pow(b1, count.to(moment_dtype))
        bc2 = 1 - torch.pow(b2, count.to(moment_dtype))
        updates = tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    """AdamW-style decoupled weight decay; only tensors with ndim >= 2
    decay."""
    def init(params):
        return ()

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")

        def add_wd(g, p):
            if p.ndim >= 2:
                return g + weight_decay * p.to(g.dtype)
            return g

        return tree_map(add_wd, grads, params), state

    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Canonical recipes
# ---------------------------------------------------------------------------

def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    if momentum == 0.0:
        return scale(-lr)

    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, vel, params=None):
        vel = tree_map(lambda v, g: momentum * v + g, vel, grads)
        return tree_map(lambda v: -lr * v, vel), vel

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return chain(scale_by_adam(b1, b2, eps), scale(-lr))


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: Optional[float] = 1.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """LM-training default: clip → adam → weight decay → lr.

    ``lr`` may be a float or a schedule ``count tensor -> lr tensor``.
    """
    parts = []
    if max_grad_norm is not None:
        parts.append(clip_by_global_norm(max_grad_norm))
    parts.append(scale_by_adam(b1, b2, eps, moment_dtype))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if callable(lr):
        parts.append(scale_by_schedule(lr))
    else:
        parts.append(scale(-lr))
    return chain(*parts)


# ---------------------------------------------------------------------------
# Schedules: a step count tensor (int32) in, an fp32 0-d tensor out
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, total_steps: int,
                    min_frac: float = 0.1) -> Callable:
    def schedule(step):
        frac = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.05) -> Callable:
    def schedule(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
