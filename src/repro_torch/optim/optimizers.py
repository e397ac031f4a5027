"""Functional optimizers over parameter trees, with the JAX package's
update formulas (so a step matches it to fp32 rounding): SGD (with and
without momentum), AdamW, clipping by the global norm, and chaining a
clip before an optimizer.

An :class:`Optimizer` is an (init, update) pair; ``update(grads,
state, params)`` returns (new_params, new_state) as fresh tensors
outside autograd.  A learning rate is a float or a schedule
(``optim.schedules``): a function of the step, 1 at the first update.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_map

Tree = Any
Schedule = Union[float, Callable[[int], float]]


def _lr_at(lr: Schedule, step: int) -> float:
    """The rate at ``step``, rounded to fp32 as the reference holds it."""
    return float(np.float32(lr(step) if callable(lr) else lr))


class Optimizer(NamedTuple):
    init: Callable[[Tree], dict]
    update: Callable[[Tree, dict, Tree], tuple]


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        state = {"step": 0}
        if momentum:
            state["mom"] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
            return (tree_map(lambda p, m: p - lr_t * m, params, mom),
                    {"step": step, "mom": mom})
        return (tree_map(lambda p, g: p - lr_t * g, params, grads),
                {"step": step})

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"step": 0, "mu": z, "nu": tree_map(torch.zeros_like, z)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        # scalars in fp32, as the reference computes b ** step in fp32
        f = np.float32
        bc1 = float(f(1) - f(b1) ** f(step))
        bc2 = float(f(1) - f(b2) ** f(step))
        lr_t = _lr_at(lr, step)

        def upd(p, m, v):
            step_size = lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step_size = step_size + lr_t * weight_decay * p.float()
            return (p.float() - step_size).to(p.dtype)

        return (tree_map(upd, params, mu, nu),
                {"step": step, "mu": mu, "nu": nu})

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Callable[[Tree], Tree]:
    """Scales every gradient by min(1, max_norm / ||g||), the norm taken
    in fp32 over all leaves; the scaled gradients are fp32, as the
    reference's product with its fp32 scale promotes them."""
    @torch.no_grad()
    def clip(grads):
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
        return tree_map(lambda g: g.float() * scale, grads)
    return clip


def chain(clip: Optional[Callable[[Tree], Tree]], opt: Optimizer) -> Optimizer:
    """``opt`` with ``clip`` applied to the gradients first."""
    if clip is None:
        return opt

    def update(grads, state, params):
        return opt.update(clip(grads), state, params)

    return Optimizer(opt.init, update)
