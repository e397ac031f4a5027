"""Task unification and task-specific modulators (paper §3.1–3.2).

All functions operate on flat task vectors.  These plain PyTorch
versions are the reference semantics; the batched wire-format version
runs through :func:`repro_torch.kernels.ops.fused_unify_packed`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import bitpack


def unify(task_vectors: torch.Tensor) -> torch.Tensor:
    """Eq. 2 on (K, d): τ = σ ⊙ μ with σ = sgn(Σ_k τ_k) and μ_j the max
    |τ_kj| over sign-aligned k."""
    sigma = torch.sign(torch.sum(task_vectors, dim=0))
    aligned = (task_vectors * sigma[None, :]) > 0
    mu = torch.amax(task_vectors.abs() * aligned, dim=0)
    return sigma * mu


def task_mask(task_vector: torch.Tensor, unified: torch.Tensor) -> torch.Tensor:
    """Binary modulator mask m^t = (τ^t ⊙ τ > 0)."""
    return (task_vector * unified) > 0


def task_scaler(task_vector: torch.Tensor, mask: torch.Tensor,
                unified: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rescaler λ^t = Σ|τ^t| / Σ|m^t ⊙ τ|."""
    num = torch.sum(task_vector.abs(), dim=-1)
    den = torch.sum(torch.where(mask, unified, 0.0).abs(), dim=-1)
    return num / torch.clamp(den, min=eps)


def modulators(task_vectors: torch.Tensor, unified: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masks (K, d) bool and scalers (K,) for stacked task vectors."""
    masks = task_mask(task_vectors, unified[None, :])
    return masks, task_scaler(task_vectors, masks, unified[None, :])


def modulate(unified: torch.Tensor, mask: torch.Tensor,
             lam: torch.Tensor) -> torch.Tensor:
    """Reconstruct a task vector: τ̇^t = λ^t · m^t ⊙ τ.

    ``mask`` may be dense bool or the packed int32 wire words a
    :class:`~repro_torch.core.client.ClientDownlink` carries (unpacked
    here, at the point of use).  A bf16 wire ``unified`` is upcast so
    the reconstruction runs in fp32."""
    if mask.dtype == torch.int32:
        mask = bitpack.unpack_bits(mask, unified.shape[-1])
    masked = torch.where(mask, unified.float(), 0.0)
    return lam[..., None] * masked if lam.dim() else lam * masked


def unify_with_modulators(task_vectors: torch.Tensor):
    """Client-side upload construction: (τ_n, masks, λs) from (K, d)."""
    tau = unify(task_vectors)
    masks, lams = modulators(task_vectors, tau)
    return tau, masks, lams


def unify_masked(task_vectors: torch.Tensor, valid: torch.Tensor
                 ) -> torch.Tensor:
    """Eq. 2 over the rows where ``valid`` (K,) holds: invalid rows are
    zeroed before the sign election, which equals dropping them."""
    return unify(task_vectors * valid.to(task_vectors.dtype)[:, None])


def unify_with_modulators_masked(task_vectors: torch.Tensor,
                                 valid: torch.Tensor):
    """Padding-aware :func:`unify_with_modulators` for one slot-packed
    client: (τ_n, masks, λs) from (K, d) and ``valid`` (K,) bool; an
    invalid slot gets an all-False mask row and λ = 0."""
    tau = unify_masked(task_vectors, valid)
    masks = task_mask(task_vectors, tau[None, :]) & valid[:, None]
    lams = task_scaler(task_vectors * valid.to(task_vectors.dtype)[:, None],
                       masks, tau[None, :])
    return tau, masks, lams
