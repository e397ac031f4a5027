"""Aggregation math for the paper's baselines (Tables 1–2), the JAX
package's ``core/baselines.py``.

Orchestration (sampling, local training, personalisation bookkeeping)
lives in :mod:`repro_torch.fed.strategies`; this module is the merge
math:

* FedAvg / FedProx server merge (one server op; FedProx differs on the
  client, through the proximal term of :mod:`repro_torch.fed.local`).
* TIES-merging (Yadav et al. 2023): trim → elect sign → disjoint mean.
* MaT-FL dynamic grouping (Cai et al. 2023): cosine-similarity greedy
  clustering; aggregation happens within groups.
* NTK-FedAvg (Muhamed et al. 2024): FedAvg over task adapters of the
  model linearised at the pretrained point (``lin_features`` of
  :mod:`repro_torch.fed.testbed`); the server merge is the plain
  weighted average.

Every merge runs on the device of its input.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def mean_rows(x: torch.Tensor) -> torch.Tensor:
    """The mean of x's (k, d) rows as ``jnp.mean`` computes it on the
    CPU: the rows added in order, times the fp32 reciprocal of k.  Its
    elementwise ops round alike on every device, so the card and the CPU
    give the same bits (``torch.mean`` divides on the CPU and multiplies
    by the reciprocal on the card, and ``torch.sum`` may pair rows)."""
    acc = x[0].float()
    for row in x[1:]:
        acc = acc + row.float()
    return acc * (torch.ones((), dtype=torch.float32, device=x.device)
                  / x.shape[0])


def weighted_average(vectors: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """FedAvg merge: vectors (M, d), weights (M,) ∝ |D|."""
    w = weights.to(vectors.device, torch.float32)
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    return w @ vectors.float()


def ties_trim(task_vectors: torch.Tensor, keep_frac: float) -> torch.Tensor:
    """TIES's trim: each vector (row) keeps every entry whose magnitude is
    at least its k-th largest, ties included (k = max(1, int(d ·
    keep_frac))); the rest become 0."""
    _m, d = task_vectors.shape
    keep = max(1, int(d * keep_frac))
    mags = torch.abs(task_vectors)
    # the k-th largest magnitude: the same value whatever topk's tie order
    thresh = torch.topk(mags, keep, dim=-1).values[:, -1:]
    return torch.where(mags >= thresh, task_vectors, 0.0)


def ties_merge(task_vectors: torch.Tensor, *,
               keep_frac: float = 0.2) -> torch.Tensor:
    """TIES-merging: per-vector magnitude trim to ``keep_frac``
    (:func:`ties_trim`), sign election by summed magnitude, disjoint mean
    over aligned entries; ``sign(0) = 0`` drops a coordinate."""
    trimmed = ties_trim(task_vectors, keep_frac)
    sigma = torch.sign(torch.sum(trimmed, dim=0))
    aligned = (trimmed * sigma[None, :]) > 0
    count = torch.clamp(torch.sum(aligned, dim=0), min=1)
    return torch.sum(torch.where(aligned, trimmed, 0.0), dim=0) / count


def cosine_similarity_matrix(vectors: torch.Tensor,
                             eps: float = 1e-12) -> torch.Tensor:
    norms = torch.linalg.norm(vectors, dim=-1, keepdim=True)
    unit = vectors / torch.clamp(norms, min=eps)
    return unit @ unit.T


def greedy_group(sim: np.ndarray, threshold: float = 0.0) -> List[List[int]]:
    """MaT-FL grouping: greedily merge clients whose mean cosine
    similarity to an existing group exceeds ``threshold``."""
    n = sim.shape[0]
    groups: List[List[int]] = []
    for i in range(n):
        best, best_s = None, threshold
        for gi, g in enumerate(groups):
            s = float(np.mean([sim[i, j] for j in g]))
            if s > best_s:
                best, best_s = gi, s
        if best is None:
            groups.append([i])
        else:
            groups[best].append(i)
    return groups
