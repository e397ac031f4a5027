"""Client-side local fine-tuning (cross-entropy, AdamW), with autograd.

Backbones exposing a :class:`~repro_torch.common.tree.TaskVectorSpace`
(``space``) and ``features_tree`` train tree-aware: AdamW runs over the
model-space LoRA delta tree, and the flat d-vector exists only at the
wire edge (unflattened once on entry, flattened once on return).  Other
backbones train over the flat vector.  Either way the contract is
``train(tv0, head0, X, Y, generator) -> (tv, head, final_loss)`` over
flat vectors of length ``backbone.d``; ``generator`` (a CPU
``torch.Generator``) draws the minibatch indices.
"""

from __future__ import annotations

import torch

from repro_torch.common.tree import tree_leaves, tree_like, tree_map
from repro_torch.optim import adamw


def make_local_trainer(backbone, *, steps: int, batch_size: int, lr: float):
    """Returns train(tv0, head0, X, Y, generator) -> (tv, head, loss)."""
    space = getattr(backbone, "space", None)
    if space is not None and hasattr(backbone, "features_tree"):
        return _make_trainer(backbone.features_tree, space.unflatten,
                             space.flatten, steps=steps,
                             batch_size=batch_size, lr=lr)
    return _make_trainer(backbone.features, lambda v: v, lambda v: v,
                         steps=steps, batch_size=batch_size, lr=lr)


def cross_entropy(feats, head, yb) -> torch.Tensor:
    """Mean softmax cross-entropy of a linear head on the features."""
    logits = feats @ head
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yb[:, None])[:, 0]
    return torch.mean(lse - gold)


def _make_trainer(features, to_model, to_flat, *, steps: int,
                  batch_size: int, lr: float):
    opt = adamw(lr)

    def train(tv0, head0, x, y, generator):
        params = (tree_map(lambda p: p.detach().clone(), to_model(tv0)),
                  head0.detach().clone())
        state = opt.init(params)
        loss = torch.zeros(())
        for _ in range(steps):
            idx = torch.randint(0, x.shape[0], (batch_size,),
                                generator=generator).to(x.device)
            params = tree_map(lambda p: p.requires_grad_(True), params)
            loss = cross_entropy(features(params[0], x[idx]), params[1],
                                 y[idx])
            grads = torch.autograd.grad(loss, tree_leaves(params))
            grads = tree_like(params, grads)
            params, state = opt.update(grads, state, params)
        return to_flat(params[0]), params[1], loss.detach()

    return train


def make_head(generator: torch.Generator, feat_out: int,
              n_classes: int) -> torch.Tensor:
    """Random linear head (CPU), scale 0.01."""
    return torch.randn((feat_out, n_classes), generator=generator) * 0.01
