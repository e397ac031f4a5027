"""Backbones for federated experiments, exposing a flat LoRA task-vector
space (the d-dimensional space MaTU operates in).

:class:`MLPBackbone` is the testbed of the quickstart: a frozen 2-layer
MLP with LoRA adapters on both layers.  The task vector is the flat
delta over the standard LoRA init (A gaussian, B zero), laid out by
``space`` (:class:`~repro_torch.common.tree.TaskVectorSpace`), so τ = 0
is exactly the pretrained point.

Every backbone exposes ``d``, ``space``, ``fingerprint``, ``feat_out``,
``split_point``, ``features(tv, x)`` and ``features_tree(delta, x)``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.common.tree import TaskVectorSpace, tree_add

# the word-boundary rule: common-d padding quantum for mixed rounds
# (8 × bitpack.WORD_BITS == ref.LAMBDA_BLOCK)
D_BOUNDARY = 256


def round_up_d(d: int, boundary: int = D_BOUNDARY) -> int:
    """Round a task-vector dimension up to the wire word boundary."""
    return -(-int(d) // boundary) * boundary


class MLPBackbone(nn.Module):
    """Frozen ``x -> gelu(x W1') -> gelu(· W2')`` with W_i' = W_i + A_i B_i.

    Weights are buffers (never trained); ``features`` takes the LoRA
    delta as a flat task vector."""

    def __init__(self, feat_dim: int, hidden: int = 64, lora_rank: int = 4,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        rn = lambda *s: torch.randn(s, generator=g)  # noqa: E731
        self._install(
            rn(feat_dim, hidden) / math.sqrt(feat_dim),
            rn(hidden, hidden) / math.sqrt(hidden),
            {"l1": {"a": rn(feat_dim, lora_rank) / math.sqrt(feat_dim),
                    "b": torch.zeros(lora_rank, hidden)},
             "l2": {"a": rn(hidden, lora_rank) / math.sqrt(hidden),
                    "b": torch.zeros(lora_rank, hidden)}})

    @classmethod
    def from_numpy(cls, w1: np.ndarray, w2: np.ndarray,
                   lora0: Dict[str, Dict[str, np.ndarray]]) -> "MLPBackbone":
        """A backbone with given frozen weights (numpy arrays), e.g. the
        JAX package's ``MLPBackbone`` parameters carried across."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
        self._install(t(w1), t(w2), {layer: {k: t(v) for k, v in ab.items()}
                                     for layer, ab in lora0.items()})
        return self

    def _install(self, w1: torch.Tensor, w2: torch.Tensor, lora0) -> None:
        self.register_buffer("w1", w1.float().contiguous())
        self.register_buffer("w2", w2.float().contiguous())
        for layer in ("l1", "l2"):
            for k in ("a", "b"):
                self.register_buffer(f"{layer}_{k}",
                                     lora0[layer][k].float().contiguous())
        self.rank = int(lora0["l1"]["a"].shape[1])
        self.space = TaskVectorSpace.from_tree(self.lora0)
        self.d = self.space.d
        self.fingerprint = self.space.fingerprint
        self.feat_out = int(w2.shape[1])
        # FedPer split: layer-1 LoRA shared, layer-2 LoRA personal
        self.split_point = int(self.l1_a.numel() + self.l1_b.numel())

    @property
    def lora0(self) -> dict:
        return {"l1": {"a": self.l1_a, "b": self.l1_b},
                "l2": {"a": self.l2_a, "b": self.l2_b}}

    def features_tree(self, delta, x: torch.Tensor) -> torch.Tensor:
        l = tree_add(self.lora0, delta)
        h = x @ (self.w1 + l["l1"]["a"] @ l["l1"]["b"])
        h = nn.functional.gelu(h, approximate="tanh")
        h = h @ (self.w2 + l["l2"]["a"] @ l["l2"]["b"])
        return nn.functional.gelu(h, approximate="tanh")

    def features(self, tv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.features_tree(self.space.unflatten(tv), x)
