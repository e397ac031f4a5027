"""Train-step factories (the JAX package's ``train/trainer.py``).

``make_train_step`` builds the LoRA fine-tune step: loss → LoRA
gradients (autograd) → clip by the global norm → optimizer update
(AdamW by default).  Base parameters stay frozen and carry no optimizer
state.  ``make_full_train_step`` is the full fine-tune variant, which
differentiates the base parameters with no LoRA.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.tree import tree_leaves, tree_like, tree_map
from repro_torch.optim import Optimizer, adamw, chain, clip_by_global_norm


def _value_and_grad(loss_fn, tree):
    """(loss, gradient tree, the tree it differentiated) of
    ``loss_fn(tree)``; a leaf the loss does not reach gets a zero
    gradient, as the reference's ``jax.grad`` gives it."""
    tree = tree_map(lambda t: t.detach().requires_grad_(True), tree)
    leaves = tree_leaves(tree)
    loss = loss_fn(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_like(tree, grads), tree


def _with_clip(opt: Optional[Optimizer], grad_clip: Optional[float]):
    opt = opt or adamw(1e-4, weight_decay=0.0)
    return chain(clip_by_global_norm(grad_clip) if grad_clip else None, opt)


def make_train_step(model, opt: Optional[Optimizer] = None,
                    grad_clip: Optional[float] = 1.0):
    """Returns (train_step, opt); ``train_step(params, lora, opt_state,
    batch) -> (lora, opt_state, {"loss": loss})`` differentiates the
    LoRA tree only."""
    opt = _with_clip(opt, grad_clip)

    def train_step(params, lora, opt_state, batch):
        loss, grads, lora = _value_and_grad(
            lambda l: model.loss(params, l, batch), lora)
        lora, opt_state = opt.update(grads, opt_state, lora)
        return lora, opt_state, {"loss": loss}

    return train_step, opt


def make_full_train_step(model, opt: Optional[Optimizer] = None,
                         grad_clip: Optional[float] = 1.0):
    """Full fine-tune variant: ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss": loss})`` differentiates the base
    parameters (lora None)."""
    opt = _with_clip(opt, grad_clip)

    def train_step(params, opt_state, batch):
        loss, grads, params = _value_and_grad(
            lambda p: model.loss(p, None, batch), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step, opt
