"""Functional AdamW over parameter trees, with the JAX package's update
formula (so one step matches it to fp32 rounding).

An :class:`Optimizer` is an (init, update) pair; ``update(grads,
state, params)`` returns (new_params, new_state) as fresh tensors
outside autograd.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.common.tree import tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], dict]
    update: Callable[[Tree, dict, Tree], tuple]


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
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
        lr_t = float(f(lr))

        def upd(p, m, v):
            step_size = lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step_size = step_size + lr_t * weight_decay * p.float()
            return (p.float() - step_size).to(p.dtype)

        return (tree_map(upd, params, mu, nu),
                {"step": step, "mu": mu, "nu": nu})

    return Optimizer(init, update)
