"""Train-step factories (the JAX package's ``train/trainer.py``).

``make_train_step`` builds the LoRA fine-tune step: loss → LoRA
gradients (autograd) → clip by the global norm → optimizer update
(AdamW by default).  Base parameters stay frozen and carry no optimizer
state.  ``make_full_train_step`` is the full fine-tune variant, which
differentiates the base parameters with no LoRA.  ``make_prefill_step``
and ``make_decode_step`` wrap the model's serving steps.

Under a mesh (``nn.sharding.mesh_context``) the same steps run on
DTensor parameters, LoRA, optimizer state and batch
(``nn.sharding.distribute_tree`` with ``launch.mesh.batch_shardings`` /
``opt_state_shardings``), the twin of the reference's ``jax.jit`` with
``in_shardings``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.tree import tree_leaves, tree_like, tree_map
from repro_torch.optim import Optimizer, adamw, chain, clip_by_global_norm


def _value_and_grad(loss_fn, tree):
    """(loss, gradient tree, the tree it differentiated) of
    ``loss_fn(tree)``; a leaf the loss does not reach gets a zero
    gradient, as the reference's ``jax.grad`` gives it.  A DTensor
    leaf's gradient is placed as the leaf is (partial sums reduced), so
    the update keeps every leaf's placements from step to step."""
    from torch.distributed.tensor import DTensor
    tree = tree_map(lambda t: t.detach().requires_grad_(True), tree)
    leaves = tree_leaves(tree)
    loss = loss_fn(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    grads = [g.redistribute(t.device_mesh, t.placements)
             if isinstance(g, DTensor) and g.placements != t.placements
             else g for g, t in zip(grads, leaves)]
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


def make_prefill_step(model, impl: str = "chunked", *, mode=None):
    """Returns ``prefill_step(params, lora, batch, cache) -> (logits,
    cache)``.  The reference's ``impl`` picks the attention rule; the
    port's prefill runs the "chunked" rule, its default, and no other
    (another ``impl`` raises).  ``mode`` is the port's own: the kernels'
    route (None: the card's kernels; "ref": their plain versions)."""
    if impl != "chunked":
        raise ValueError(f"the port's prefill runs impl='chunked' only, "
                         f"got {impl!r}")

    def prefill_step(params, lora, batch, cache):
        return model.prefill_step(params, lora, batch, cache, mode=mode)
    return prefill_step


def make_decode_step(model, *, mode=None):
    """Returns ``decode_step(params, lora, batch, cache, pos) -> (logits,
    cache)``; ``mode`` as in :func:`make_prefill_step`."""
    def decode_step(params, lora, batch, cache, pos):
        return model.decode_fn(params, lora, batch, cache, pos, mode=mode)
    return decode_step
