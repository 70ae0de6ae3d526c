"""AdamW and SGD over tensor trees (PyTorch port of ``repro.optim.adamw``).

The optax-style convention of the JAX package, on the port's nested dict /
tuple trees:

    opt = adamw(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The update is the JAX package's to the operation: f32 moments, bias
correction ``1 - b**step``, ``eps`` added to ``sqrt(v̂)``, and decoupled
weight decay inside the step.  ``torch.optim.AdamW`` puts ``eps`` and the
weight decay elsewhere, so it is not used.  Gradients that are ``None``
(a frozen leaf) count as zeros.

``stacked=True`` updates a stacked client state (every leaf with a leading
client axis m) as ``jax.vmap`` of the per-client update would: the moments
are elementwise anyway, the step count is shared, and ``grad_clip`` clips
each client by its own global norm (one norm over all clients would mix
them).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

LR = Union[float, Callable[[int], float]]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _lr_at(lr: LR, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _g(g, p):
    return torch.zeros_like(p, dtype=torch.float32) if g is None \
        else g.float()


def _f32(x: float) -> float:
    """Round a Python float to float32, as the JAX package's f32 scalars
    (on the host: no tensor op in the optimizer's step)."""
    return float(np.float32(x))


def adamw(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: float = 0.0, stacked: bool = False) -> Optimizer:
    def init(params):
        return {"step": 0,
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "nu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    def update(grads, state, params):
        step = state["step"] + 1
        grads = tree_map(lambda p, g: _g(g, p), params, grads)
        if grad_clip:
            gnorm = client_norms(grads) if stacked else global_norm(grads)
            scale = torch.clamp(grad_clip / gnorm.clamp_min(1e-12), max=1.0)
            grads = tree_map(lambda g: g * scale.reshape(
                scale.shape + (1,) * (g.dim() - scale.dim())), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                      grads)
        lr_t = _f32(_lr_at(lr, step))
        bc1 = _f32(1 - _f32(b1) ** step)
        bc2 = _f32(1 - _f32(b2) ** step)

        def upd(m, v, p):
            u = -lr_t * (m / bc1 / (torch.sqrt(v / bc2) + eps)
                         + weight_decay * p.float())
            return u.to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def sgd(lr: LR = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"step": 0, "mom": tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)}
        return {"step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _f32(_lr_at(lr, step))
        grads = tree_map(lambda p, g: _g(g, p), params, grads)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
            updates = tree_map(lambda m, p: (-lr_t * m).to(p.dtype), mom,
                               params)
            return updates, {"step": step, "mom": mom}
        updates = tree_map(lambda g, p: (-lr_t * g).to(p.dtype), grads,
                           params)
        return updates, {"step": step}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = [x for x in tree_leaves(tree) if x is not None]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def client_norms(tree) -> torch.Tensor:
    """(m,) global norm of each client's slice of a stacked tree."""
    leaves = [x for x in tree_leaves(tree) if x is not None]
    return torch.sqrt(sum(torch.square(x.float()).reshape(x.shape[0], -1)
                          .sum(-1) for x in leaves))
