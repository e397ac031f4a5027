"""MaTU server-side aggregation (paper §3.2, Eq. 3–7): the dense per-task
reference semantics of the round.

The server is *stateless*: each round it receives, per client n,
  • the unified task vector τ_n (d,),
  • per held task t: a binary mask m_n^t (d,) and a scalar λ_n^t,
  • metadata: the task→client allocation A and dataset sizes |D_n^t|,
and returns, per task, the new aggregated task vector τ^{t,r+1}; the
per-client unified vectors + modulators for the next round are then
re-derived with :func:`repro_torch.core.unify.unify_with_modulators`.

Reading of Eq. 4 (the JAX package's, unchanged): the server does not
possess the raw τ_n^t — clients only upload (τ_n, m_n^t, λ_n^t).  The
reconstruction of §3.2 is τ̇_n^t = λ_n^t · m_n^t ⊙ τ_n, and Eq. 4's
``λ_n^t · m̂^t ⊙ τ_n^t`` applies λ once to the masked unified vector:
τ̂^t = Σ_n γ_n^t · m̂^t ⊙ (λ_n^t · m_n^t ⊙ τ_n).

This module is plain tensor code with no kernel: the round engine
(:mod:`repro_torch.core.engine`) computes the same round through the
kernels, and the tests hold the engine's bool/fp32 layout against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import bitpack

RHO_DEFAULT = 0.4     # Eq. 3 threshold, after Tenison et al. 2023
EPS_DEFAULT = 0.5     # Eq. 6 similarity filter
KAPPA_DEFAULT = 3     # Eq. 6 top-κ


def agreement_mask(masks: torch.Tensor, unified: torch.Tensor,
                   member: torch.Tensor,
                   rho: float = RHO_DEFAULT) -> torch.Tensor:
    """Eq. 3 — averaged task mask m̂^t for ONE task.

    masks (N, d) bool m_n^t (False for non-members); unified (N, d);
    member (N,) bool — A(n, t).  Returns m̂^t (d,): 1 where the
    agreement score α ≥ ρ, else α."""
    w = member.float()
    n_t = torch.clamp(torch.sum(w), min=1.0)
    signs = torch.sign(torch.where(masks, unified, 0.0))  # sgn(m_n^t ⊙ τ_n)
    alpha = torch.abs(w @ signs) / n_t
    return torch.where(alpha >= rho, 1.0, alpha)


def reconstruct(unified: torch.Tensor, masks: torch.Tensor,
                lams: torch.Tensor) -> torch.Tensor:
    """τ̇_n^t = λ_n^t · m_n^t ⊙ τ_n for stacked clients: (N, d)."""
    return lams[:, None] * torch.where(masks, unified, 0.0)


def task_aggregate(unified: torch.Tensor, masks: torch.Tensor,
                   lams: torch.Tensor, member: torch.Tensor,
                   data_sizes: torch.Tensor, rho: float = RHO_DEFAULT):
    """Eq. 3 + Eq. 4 for ONE task.

    unified (N, d); masks (N, d) bool; lams (N,); member (N,) bool;
    data_sizes (N,) (|D_n^t|; zero for non-members).  Returns
    (τ̂^t (d,), m̂^t (d,))."""
    m_hat = agreement_mask(masks, unified, member, rho)
    gamma = data_sizes * member.to(data_sizes.dtype)
    gamma = gamma / torch.clamp(torch.sum(gamma), min=1e-12)
    return (gamma @ reconstruct(unified, masks, lams)) * m_hat, m_hat


def sign_similarity(tau_hats: torch.Tensor) -> torch.Tensor:
    """Eq. 5 — S(t, t') = ½(mean_i sgn(τ̂^t)_i · sgn(τ̂^t')_i + 1), (T, T)."""
    d = tau_hats.shape[-1]
    signs = torch.sign(tau_hats)
    return 0.5 * (signs @ signs.T / d + 1.0)


def topk_similar(sim: torch.Tensor, eps: float = EPS_DEFAULT,
                 kappa: int = KAPPA_DEFAULT) -> torch.Tensor:
    """Z^t as a weight matrix: (T, T) with S(t, t') kept for the top-κ
    t' ≠ t having S > ε, zero elsewhere."""
    t = sim.shape[0]
    offdiag = sim * (1.0 - torch.eye(t, dtype=sim.dtype, device=sim.device))
    eligible = torch.where(offdiag > eps, offdiag, 0.0)
    k = min(kappa, t - 1) if t > 1 else 0
    if k == 0:
        return torch.zeros_like(sim)
    thresh = torch.topk(eligible, k, dim=-1).values[:, -1:]   # κ-th largest
    keep = (eligible >= thresh) & (eligible > 0)
    return torch.where(keep, eligible, 0.0)


def transfer_weights(sim: torch.Tensor, held: torch.Tensor, *,
                     eps: float = EPS_DEFAULT, kappa: int = KAPPA_DEFAULT,
                     cross_task: bool = True,
                     uniform_cross: bool = False) -> torch.Tensor:
    """Eq. 6 neighbourhood weights from the held-masked similarity: the
    cross-task / uniform / off ablation switch of Fig. 6b."""
    heldf = held.to(sim.dtype)
    if not cross_task:
        return torch.zeros_like(sim)
    if uniform_cross:
        t = sim.shape[0]
        eye = torch.eye(t, dtype=sim.dtype, device=sim.device)
        w = (1.0 - eye) * heldf[None, :] * heldf[:, None]
        return w / torch.clamp(torch.sum(w, 1, keepdim=True), min=1.0)
    return topk_similar(sim, eps, kappa)


def cross_task_aggregate(tau_hats: torch.Tensor, m_hats: torch.Tensor,
                         sim_weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6 — τ̃^t = m̂^t ⊙ Σ_{t'∈Z^t} S(t, t') τ̂^{t'}, normalised over
    Z^t (Σ S as the partition) so that ‖τ̃‖ ≈ ‖τ̂‖: the §3.2 overview's
    "averaging", which keeps task-vector norms stable over rounds."""
    total = torch.sum(sim_weights, dim=1, keepdim=True)
    norm_w = sim_weights / torch.clamp(total, min=1e-12)
    return m_hats * (norm_w @ tau_hats)


def combine_round(tau_hats: torch.Tensor, tau_tildes: torch.Tensor,
                  sim_weights: torch.Tensor) -> torch.Tensor:
    """Eq. 7 with the overview's averaging: τ = (τ̂ + τ̃)/2 for tasks with
    cross-task donors, τ = τ̂ otherwise."""
    has = (torch.sum(sim_weights, dim=1, keepdim=True) > 0).to(
        tau_hats.dtype)
    return (tau_hats + tau_tildes * has) / (1.0 + has)


class RoundOutput(NamedTuple):
    task_vectors: torch.Tensor   # (T, d) τ^{t,r+1}
    tau_hats: torch.Tensor       # (T, d) same-task component
    tau_tildes: torch.Tensor     # (T, d) cross-task component
    m_hats: torch.Tensor         # (T, d)
    similarity: torch.Tensor     # (T, T)


def matu_round(unified: torch.Tensor, masks: torch.Tensor,
               lams: torch.Tensor, allocation: torch.Tensor,
               data_sizes: torch.Tensor, *, rho: float = RHO_DEFAULT,
               eps: float = EPS_DEFAULT, kappa: int = KAPPA_DEFAULT,
               cross_task: bool = True,
               uniform_cross: bool = False) -> RoundOutput:
    """One stateless MaTU server round over ALL tasks (Eq. 3–7).

    unified (N, d); masks (N, T, d) bool (False where A(n, t) = 0);
    lams (N, T); allocation (N, T) bool; data_sizes (N, T).

    Tasks with no member this round are masked out of the similarity and
    the cross-task weights, so transfer never mixes in their zero task
    vectors under partial participation.  ``cross_task=False`` and
    ``uniform_cross=True`` give the two ablation variants of Fig. 6b.
    """
    per_task = [task_aggregate(unified, masks[:, t], lams[:, t],
                               allocation[:, t], data_sizes[:, t], rho)
                for t in range(masks.shape[1])]
    tau_hats = torch.stack([p[0] for p in per_task])
    m_hats = torch.stack([p[1] for p in per_task])
    held = torch.any(allocation, dim=0)
    heldf = held.to(tau_hats.dtype)
    sim = sign_similarity(tau_hats) * heldf[None, :] * heldf[:, None]
    weights = transfer_weights(sim, held, eps=eps, kappa=kappa,
                               cross_task=cross_task,
                               uniform_cross=uniform_cross)
    tau_tildes = cross_task_aggregate(tau_hats, m_hats, weights)
    return RoundOutput(combine_round(tau_hats, tau_tildes, weights),
                       tau_hats, tau_tildes, m_hats, sim)


def matu_round_packed(unified: torch.Tensor, mask_words: torch.Tensor,
                      lams: torch.Tensor, allocation: torch.Tensor,
                      data_sizes: torch.Tensor, d: int, **kw) -> RoundOutput:
    """Wire-format adapter for :func:`matu_round`: bf16 ``unified``
    (N, d) and packed ``mask_words`` (N, T, ceil(d/32)) int32 are
    unpacked and run through the dense fp32 reference."""
    return matu_round(unified.float(), bitpack.unpack_bits(mask_words, d),
                      lams, allocation, data_sizes, **kw)
