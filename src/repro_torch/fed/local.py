"""Client-side local fine-tuning (cross-entropy, AdamW), with autograd.

One trainer serves every strategy:

* vanilla (FedAvg / MaTU / MaT-FL / FedPer / TIES): CE loss;
* FedProx: + (μ/2)·‖τ − τ_anchor‖² (Li et al. 2020), the anchor being
  the τ the client started the round from;
* NTK-FedAvg: trains the model linearised at the pretrained point,
  f(0) + J(0)·τ (Muhamed et al. 2024), through ``torch.func.jvp``
  (:func:`repro_torch.fed.testbed.linearized`), the gradient taken
  reverse over forward.

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
from repro_torch.fed.testbed import linearized
from repro_torch.optim import adamw


def make_local_trainer(backbone, *, steps: int, batch_size: int, lr: float,
                       prox_mu: float = 0.0, linearize: bool = False):
    """Returns train(tv0, head0, X, Y, generator) -> (tv, head, loss)."""
    loss, to_model, to_flat = local_objective(backbone, prox_mu=prox_mu,
                                              linearize=linearize)
    return _make_trainer(loss, to_model, to_flat, steps=steps,
                         batch_size=batch_size, lr=lr)


def local_objective(backbone, *, prox_mu: float = 0.0,
                    linearize: bool = False):
    """The trainer's objective and its wire edges: ``(loss, to_model,
    to_flat)`` with ``loss(params, xb, yb, anchor)`` over ``params =
    (delta, head)``, ``delta`` a model-space tree (tree-aware backbones)
    or the flat vector, ``anchor`` the round's starting ``delta``."""
    space = getattr(backbone, "space", None)
    if space is not None and hasattr(backbone, "features_tree"):
        feats = backbone.features_tree
        to_model, to_flat = space.unflatten, space.flatten
    else:
        feats = backbone.features
        to_model = to_flat = lambda v: v  # noqa: E731
    if linearize:
        feats = linearized(feats)

    def loss(params, xb, yb, anchor):
        ce = cross_entropy(feats(params[0], xb), params[1], yb)
        if prox_mu > 0.0:
            ce = ce + 0.5 * prox_mu * sum(
                torch.sum(torch.square(p.float() - a.float()))
                for p, a in zip(tree_leaves(params[0]), tree_leaves(anchor)))
        return ce

    return loss, to_model, to_flat


def cross_entropy(feats, head, yb) -> torch.Tensor:
    """Mean softmax cross-entropy of a linear head on the features."""
    logits = feats @ head
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yb[:, None])[:, 0]
    return torch.mean(lse - gold)


def _make_trainer(loss_fn, to_model, to_flat, *, steps: int,
                  batch_size: int, lr: float):
    opt = adamw(lr)

    def train(tv0, head0, x, y, generator):
        anchor = tree_map(lambda p: p.detach().clone(), to_model(tv0))
        params = (tree_map(lambda p: p.clone(), anchor),
                  head0.detach().clone())
        state = opt.init(params)
        loss = torch.zeros(())
        for _ in range(steps):
            idx = torch.randint(0, x.shape[0], (batch_size,),
                                generator=generator).to(x.device)
            params = tree_map(lambda p: p.requires_grad_(True), params)
            loss = loss_fn(params, x[idx], y[idx], anchor)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            grads = tree_like(params, grads)
            params, state = opt.update(grads, state, params)
        return to_flat(params[0]), params[1], loss.detach()

    return train


def make_head(generator: torch.Generator, feat_out: int,
              n_classes: int) -> torch.Tensor:
    """Random linear head (CPU), scale 0.01."""
    return torch.randn((feat_out, n_classes), generator=generator) * 0.01
