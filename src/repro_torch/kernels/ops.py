"""Dispatch layer over the port's kernels — the only entry point the
round engine (``repro_torch.core.engine``) uses for Eq. 2–7 math, and
the serving path's fused LoRA matmul (``modulated_matmul``).  The xLSTM
prefill's ``mlstm_chunkwise`` dispatches in its own module
(``kernels.mlstm_chunk``), as the JAX package's ``ops`` has no mLSTM
entry; its kernel is listed in ``KERNELS`` with the others.

Dispatch follows the tensors' device: CPU tensors take each kernel's
plain PyTorch version, CUDA tensors take the hand-written kernel (or
raise).  ``mode="ref"`` runs the plain versions on any device; it exists
so that tests and ``chip_smoke.py`` can hold the kernels against them.
No environment variable changes what the main path runs.

Under a taskvec mesh (``core.engine``, "Sharding contract") the round's
functions take ``group`` / ``axis_sizes`` / ``d_norm``, the counterparts
of the JAX package's ``axis_name`` / ``axis_sizes`` / ``d_norm``: the
rank's process group of taskvec shards, the taskvec axis sizes and the
global d.  The tensors are then the rank's d-slice, the kernels run on
it, and exactly the JAX package's reductions cross ranks: the Eq. 5
dots as one integer :func:`~repro_torch.nn.sharding.psum` (kernel 3 on
the sign planes in both layouts), and the λ tree roots through
``ref._lam_totals``.

The (T, T)-sized Eq. 6–7 ops (top-κ filter, cross-task combine) have no
kernel in either package: a (T, T) top-k and a (T, T)·(T, d) product
stay plain PyTorch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import bitpack, ref
from repro_torch.kernels import fused_unify as _fu
from repro_torch.kernels import masked_agg as _ma
from repro_torch.kernels import mlstm_chunk as _ml
from repro_torch.kernels import modulated_matmul as _mm
from repro_torch.kernels import sign_sim as _ss
from repro_torch.nn.sharding import psum

MODES = (None, "ref")
KERNELS = (_fu.KERNEL, _ma.KERNEL, _ss.KERNEL,
           _fu.KERNEL_BOOL, _ma.KERNEL_BOOL,
           _ss.KERNEL_DENSE, _fu.KERNEL_UNIFY,
           _ma.KERNEL_SINGLE, _mm.KERNEL, _ml.KERNEL)
# the kernels the packed round launches, by name
PACKED_ROUND_KERNELS = tuple(k.name for k in KERNELS[:3])
# the kernels the multi-tenant decode launches, by name (the mLSTM
# prefill's only for the ssm family)
SERVE_KERNELS = (_mm.KERNEL.name, _ml.KERNEL.name)


def _plain(mode: Optional[str]) -> bool:
    if mode not in MODES:
        raise ValueError(f"unknown dispatch mode {mode!r}; expected one of "
                         f"{MODES} (None = by device)")
    return mode == "ref"


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset, by kernel name."""
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def unify(task_vectors: torch.Tensor, *,
          mode: Optional[str] = None) -> torch.Tensor:
    """(K, d) -> (d,) fp32 task unification (Eq. 2)."""
    if _plain(mode):
        return _fu.plain_unify(task_vectors)
    return _fu.unify(task_vectors)


def fused_unify_raw(task_vectors: torch.Tensor, valid: torch.Tensor, *,
                    packed: bool = True, mode: Optional[str] = None):
    """Division-free fused unify: (unified, masks, num, den) — bf16
    unified and int32 mask words when ``packed``, else fp32 unified and
    bool masks."""
    if packed:
        if _plain(mode):
            return _fu.plain(task_vectors, valid)
        return _fu.fused_unify_packed(task_vectors, valid)
    if _plain(mode):
        return _fu.plain_bool(task_vectors, valid)
    return _fu.fused_unify(task_vectors, valid)


def fused_unify(task_vectors: torch.Tensor, valid: torch.Tensor, *,
                eps: float = 1e-12, mode: Optional[str] = None):
    """Batched unify + task masks + λ in the bool/fp32 layout:
    task_vectors (B, K, d) fp32/bf16, valid (B, K) bool -> (unified
    (B, d) fp32, masks (B, K, d) bool, lams (B, K) fp32).  Row b equals
    ``unify_with_modulators`` on the valid slots of client b; invalid
    slots give zero mask rows and λ = 0."""
    uni, masks, num, den = fused_unify_raw(task_vectors, valid, packed=False,
                                           mode=mode)
    return uni, masks, num / torch.clamp(den, min=eps)


def fused_unify_packed(task_vectors: torch.Tensor, valid: torch.Tensor, *,
                       eps: float = 1e-12, mode: Optional[str] = None):
    """Batched unify + task masks + λ in the wire format: task_vectors
    (B, K, d) fp32/bf16, valid (B, K) bool -> (unified (B, d) bf16,
    mask_words (B, K, ceil(d/32)) int32, lams (B, K) fp32).  Mask bits
    and λ are decided on fp32 values before the bf16 rounding."""
    uni, words, num, den = fused_unify_raw(task_vectors, valid, mode=mode)
    return uni, words, num / torch.clamp(den, min=eps)


def masked_agg(unified, masks, lams, gammas, *, rho: float = 0.4,
               mode: Optional[str] = None):
    """Single-task Eq. 3 + Eq. 4 (membership inferred from gammas > 0):
    unified (N, d), masks (N, d) bool or {0, 1}, lams / gammas (N,) ->
    (tau_hat (d,) fp32, m_hat (d,) fp32)."""
    if _plain(mode):
        return _ma.plain_single(unified, masks, lams, gammas, rho)
    return _ma.masked_agg(unified, masks, lams, gammas, rho)


def modulated_matmul(x: torch.Tensor, base: torch.Tensor, tau: torch.Tensor,
                     words: torch.Tensor, lam: torch.Tensor, *,
                     mode: Optional[str] = None) -> torch.Tensor:
    """Serving: per-request modulated LoRA matmul ``y_b = x_b @ (base +
    λ_b · m_b ⊙ τ)`` with the modulator mask kept packed until the
    kernel builds its weight tile.  x (B, S, K) fp32; base (K, N) fp32;
    tau (K, N) fp32/bf16; words (B, K·N/32) int32 row-major over the
    (K, N) leaf; lam (B,) fp32 -> (B, S, N) fp32.  ``K · N`` must be
    word-aligned (% 32 == 0): the serve router only routes such leaves
    here."""
    _mm.check_aligned(*base.shape)
    if _plain(mode):
        return _mm.plain(x, base, tau, words, lam)
    return _mm.modulated_matmul(x, base, tau, words, lam)


def masked_agg_batched_packed(unified, mask_words, lams, gammas, members,
                              d: int, *, rho: float = 0.4,
                              mode: Optional[str] = None):
    """Whole-round Eq. 3 + Eq. 4 over packed (N, T, ceil(d/32)) words:
    returns (tau_hats (T, d) fp32, alpha_num (T, d) fp32)."""
    if _plain(mode):
        return _ma.plain(unified, mask_words, lams, gammas, members, d, rho)
    return _ma.masked_agg_batched_packed(unified, mask_words, lams, gammas,
                                         members, d, rho)


def masked_agg_batched(unified, masks, lams, gammas, members, *,
                       rho: float = 0.4, mode: Optional[str] = None):
    """Whole-round Eq. 3 + Eq. 4 over dense (N, T, d) bool masks:
    returns (tau_hats (T, d) fp32, m_hats (T, d) fp32)."""
    if _plain(mode):
        return _ma.plain_bool(unified, masks, lams, gammas, members, rho)
    return _ma.masked_agg_batched(unified, masks, lams, gammas, members, rho)


def sign_sim(tau_hats: torch.Tensor, *,
             mode: Optional[str] = None) -> torch.Tensor:
    """Eq. 5 similarity S = ½(sgn(τ̂)·sgn(τ̂)ᵀ/d + 1) from dense (T, d)."""
    if _plain(mode):
        return _ss.plain_dense(tau_hats)
    return _ss.sign_sim(tau_hats)


def sign_dots_packed(pos: torch.Tensor, nz: torch.Tensor, *,
                     mode: Optional[str] = None) -> torch.Tensor:
    """Eq. 5 raw sign dots (T, T) fp32, exact integers, from packed sign
    planes (kernel 3)."""
    if _plain(mode):
        return _ss.plain(pos, nz)
    return _ss.sign_sim_packed(pos, nz)


def sign_sim_packed(pos: torch.Tensor, nz: torch.Tensor, d: int, *,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Eq. 5 similarity S = ½(dots/d + 1) from packed sign planes; ``d``
    is the unpacked feature count."""
    return ref.sim_from_dots(sign_dots_packed(pos, nz, mode=mode), d)


def topk_weights(sim: torch.Tensor, *, eps: float = 0.5,
                 kappa: int = 3) -> torch.Tensor:
    """Eq. 6 top-κ neighbourhood weights."""
    return ref.topk_weights_ref(sim, eps, kappa)


def cross_task_combine(tau_hats: torch.Tensor, m_hats: torch.Tensor,
                       sim_weights: torch.Tensor):
    """Eq. 6 + Eq. 7: returns (task_vectors, tau_tildes)."""
    return ref.cross_task_combine_ref(tau_hats, m_hats, sim_weights)


def pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """(..., d) bool -> (..., ceil(d/32)) int32 words, LSB-first: the wire
    layout of ``repro_torch.kernels.bitpack``."""
    return bitpack.pack_bits(masks)


def unpack_masks(words: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_masks`: (..., ceil(d/32)) words -> (..., d)
    bool."""
    return bitpack.unpack_bits(words, d)


def _scatter_slots(values: torch.Tensor, slot_tasks: torch.Tensor,
                   n_tasks: int) -> torch.Tensor:
    """(N, K, ...) slot values -> contiguous (N, T, ...) by slot task
    id; ids >= ``n_tasks`` (the sentinel) land in one extra trailing row
    that is dropped."""
    n, k = slot_tasks.shape
    tail = tuple(values.shape[2:])
    flat = torch.zeros((n * n_tasks + 1,) + tail, dtype=values.dtype,
                       device=values.device)
    tasks = slot_tasks.long()
    rows = torch.arange(n, device=values.device)[:, None]
    idx = torch.where(tasks < n_tasks, rows * n_tasks + tasks, n * n_tasks)
    flat[idx.reshape(-1)] = values.reshape((n * k,) + tail)
    return flat[:n * n_tasks].reshape((n, n_tasks) + tail)


def _slot_scalars_to_dense(slot_lams, slot_sizes, slot_valid, slot_tasks,
                           n_tasks: int):
    """Scatter the per-slot scalars to the dense (N, T) layout: (lams,
    members, sizes)."""
    lams_d = _scatter_slots(torch.where(slot_valid, slot_lams.float(), 0.0),
                            slot_tasks, n_tasks)
    member_d = _scatter_slots(slot_valid, slot_tasks, n_tasks)
    sizes_d = _scatter_slots(torch.where(slot_valid, slot_sizes.float(), 0.0),
                             slot_tasks, n_tasks)
    return lams_d, member_d, sizes_d


def slots_to_dense(slot_masks, slot_lams, slot_sizes, slot_valid,
                   slot_tasks, n_tasks: int):
    """Scatter slot round tensors to the dense per-task layout of the
    bool/fp32 kernels: ((N, T, d) bool masks, (N, T) lams / members /
    sizes).  Sentinel task ids (== n_tasks) are dropped."""
    masks = slot_masks & slot_valid[:, :, None]
    masks_d = _scatter_slots(masks, slot_tasks, n_tasks)
    lams_d, member_d, sizes_d = _slot_scalars_to_dense(
        slot_lams, slot_sizes, slot_valid, slot_tasks, n_tasks)
    return masks_d, lams_d, member_d, sizes_d


def slots_to_dense_packed(slot_mask_words, slot_lams, slot_sizes, slot_valid,
                          slot_tasks, n_tasks: int):
    """Scatter slot-packed round tensors to the dense per-task layout the
    kernels consume: ((N, T, ceil(d/32)) int32 words, (N, T) lams /
    members / sizes).  Sentinel task ids (== n_tasks) are dropped."""
    words = torch.where(slot_valid[:, :, None], slot_mask_words,
                        torch.zeros((), dtype=torch.int32,
                                    device=slot_mask_words.device))
    words_d = _scatter_slots(words, slot_tasks, n_tasks)
    lams_d, member_d, sizes_d = _slot_scalars_to_dense(
        slot_lams, slot_sizes, slot_valid, slot_tasks, n_tasks)
    return words_d, lams_d, member_d, sizes_d


def _gammas(member_d: torch.Tensor, sizes_d: torch.Tensor):
    """Eq. 4 data weights γ (N, T): member sizes normalised per task,
    the totals summed by ``torch.sum`` over the whole client axis.
    Returns (members as fp32, γ)."""
    memf = member_d.float()
    gam = sizes_d * memf
    return memf, gam / torch.clamp(torch.sum(gam, dim=0, keepdim=True),
                                   min=1e-12)


def _m_hats(a_num: torch.Tensor, n_t: torch.Tensor, rho: float):
    """Eq. 3 averaged masks m̂ (T, d) from the agreement numerator and
    the member counts: the fp32 division of the round's kernels."""
    alpha = a_num / torch.clamp(n_t, min=1.0)[:, None]
    return torch.where(alpha >= rho, 1.0, alpha)


def _finish(tau_hats, m_hats, n_t, d: int, *, packed: bool, eps: float,
            kappa: int, cross_task: bool, uniform_cross: bool,
            mode: Optional[str], group=None, d_norm: int = 0):
    """The round's tail after Eq. 3+4, shared by the monolithic round
    and the chunked finish: Eq. 5 (kernel 3 on the sign planes when
    ``packed``, kernel 6 on the dense rows otherwise), masked to the
    held tasks, then Eq. 6 + 7 in plain torch.  Under a taskvec
    ``group`` both layouts take kernel 3 on the local d-slice, whose
    dots cross ranks as one int32 psum and are normalised by the global
    ``d_norm`` (the JAX package's kernel path).  Returns (task_vectors
    (T, d), similarity (T, T))."""
    held = n_t > 0
    heldf = held.float()
    if group is not None:
        pos, nz = bitpack.sign_planes(tau_hats)
        dots = psum(sign_dots_packed(pos, nz, mode=mode).to(torch.int32),
                    group)
        sim = ref.sim_from_dots(dots, d_norm)
    elif packed:
        pos, nz = bitpack.sign_planes(tau_hats)
        sim = sign_sim_packed(pos, nz, d, mode=mode)
    else:
        sim = sign_sim(tau_hats, mode=mode)
    sim = sim * heldf[None, :] * heldf[:, None]
    weights = ref.cross_weights_ref(sim, held, eps=eps, kappa=kappa,
                                    cross_task=cross_task,
                                    uniform_cross=uniform_cross)
    task_vectors, _tau_tildes = ref.cross_task_combine_ref(tau_hats, m_hats,
                                                           weights)
    return task_vectors, sim


def _downlink(task_vectors, slot_valid, slot_tasks, n_tasks: int, *,
              packed: bool, lam_eps: float, mode: Optional[str],
              group=None, axis_sizes=(), num_t=None):
    """The downlink re-unification of a block of clients, shared by the
    monolithic round and the chunked round's phase C: gather each slot's
    fresh task vector (sentinel ids clamped; the valid mask zeroes their
    output), then kernel 1 (``packed``) or kernel 4.  Each client's row
    depends on its own slots only.  Under a taskvec ``group`` the λ num
    and den roots of the local slice cross ranks in one psum
    (``ref._lam_totals``); with ``num_t`` (the chunked round's global
    per-task numerators, :func:`matu_lam_num`) only the den roots do, and
    a valid slot's numerator is its task's.  Returns (down_unified,
    down_masks, down_lams)."""
    clamped = torch.clamp(slot_tasks.long(), max=n_tasks - 1)
    tvs = task_vectors[clamped]
    uni, dmasks, num, den = fused_unify_raw(tvs, slot_valid, packed=packed,
                                            mode=mode)
    if group is not None and num_t is None:
        num, den = ref._lam_totals((num, den), group, axis_sizes)
    elif group is not None:
        (den,) = ref._lam_totals((den,), group, axis_sizes)
        num = torch.where(slot_valid.bool(), num_t[clamped], 0.0)
    return uni, dmasks, num / torch.clamp(den, min=lam_eps)


def _alpha_num(a_num: torch.Tensor, n_clients: int) -> torch.Tensor:
    """The agreement numerator in the JAX package's wire dtype, keyed,
    as there, on the round's padded client count next_pow2(N)."""
    return a_num.to(ref.alpha_dtype(ref.next_pow2(n_clients)))


def _apply_slot_weights(slot_lams, slot_sizes, slot_weights):
    """The async staleness discount: per-slot weights w in (0, 1] scale
    the modulator λ (the slot's reconstructed vector shrinks) and the
    size (the slot's share of the Eq. 4 γ shrinks) in fp32 before the
    slot scatter, so no kernel takes a new operand.  ``w = 1`` is
    bitwise ``None`` (an IEEE multiply by 1.0)."""
    if slot_weights is None:
        return slot_lams, slot_sizes
    w = slot_weights.float()
    return tuple(None if x is None else x.float() * w
                 for x in (slot_lams, slot_sizes))


def matu_round_slots(unified, slot_masks, slot_lams, slot_sizes, slot_valid,
                     slot_tasks, n_tasks: int, *, rho: float = 0.4,
                     eps: float = 0.5, kappa: int = 3,
                     cross_task: bool = True, uniform_cross: bool = False,
                     lam_eps: float = 1e-12, mode: Optional[str] = None,
                     slot_weights: Optional[torch.Tensor] = None,
                     group=None, axis_sizes=(), d_norm: int = 0):
    """The full MaTU server round in the bool/fp32 A/B layout.

    Layout: ``unified`` (N, d) fp32; ``slot_masks`` (N, K, d) bool;
    ``slot_lams`` / ``slot_sizes`` / ``slot_valid`` (N, K);
    ``slot_tasks`` (N, K) with the sentinel ``n_tasks`` in invalid
    slots.  The composition is the JAX package's dense kernel path:
    scatter to the dense (N, T, d) layout, Eq. 3+4 masked aggregation,
    Eq. 5 dense sign dots, Eq. 6+7 in plain torch, then the downlink
    re-unification of every client's fresh task vectors.

    Returns (task_vectors (T, d) fp32, tau_hats (T, d) fp32, m_hats
    (T, d) fp32, similarity (T, T), down_unified (N, d) fp32, down_masks
    (N, K, d) bool, down_lams (N, K)).  Tasks nobody holds give
    τ̂ = m̂ = 0 and are masked out of the similarity.  On the same mask
    bits and bf16-representable unified values every output equals the
    packed round's bit for bit (the bf16 downlink as the rounding of the
    fp32 one).

    ``slot_weights`` (optional (N, K) fp32) is the async staleness
    discount (:func:`_apply_slot_weights`).  ``group`` / ``axis_sizes``
    / ``d_norm``: the taskvec-sharded round on this rank's d-slice
    (module docstring); Eq. 5 then runs kernel 3 on the sign planes.
    """
    slot_lams, slot_sizes = _apply_slot_weights(slot_lams, slot_sizes,
                                                slot_weights)
    masks_d, lams_d, member_d, sizes_d = slots_to_dense(
        slot_masks, slot_lams, slot_sizes, slot_valid, slot_tasks, n_tasks)
    memf, gam = _gammas(member_d, sizes_d)
    tau_hats, m_hats = masked_agg_batched(unified, masks_d, lams_d, gam,
                                          member_d, rho=rho, mode=mode)
    n_t = torch.sum(memf, dim=0)
    task_vectors, sim = _finish(
        tau_hats, m_hats, n_t, tau_hats.shape[-1], packed=False, eps=eps,
        kappa=kappa, cross_task=cross_task, uniform_cross=uniform_cross,
        mode=mode, group=group, d_norm=d_norm)
    return (task_vectors, tau_hats, m_hats, sim) + _downlink(
        task_vectors, slot_valid, slot_tasks, n_tasks, packed=False,
        lam_eps=lam_eps, mode=mode, group=group, axis_sizes=axis_sizes)


def matu_round_slots_packed(unified, slot_mask_words, slot_lams, slot_sizes,
                            slot_valid, slot_tasks, n_tasks: int, d: int, *,
                            rho: float = 0.4, eps: float = 0.5,
                            kappa: int = 3, cross_task: bool = True,
                            uniform_cross: bool = False,
                            lam_eps: float = 1e-12,
                            mode: Optional[str] = None,
                            slot_weights: Optional[torch.Tensor] = None,
                            group=None, axis_sizes=(), d_norm: int = 0):
    """The full MaTU server round over wire-format slot uploads.

    Layout: ``unified`` (N, d) bf16; ``slot_mask_words`` (N, K,
    ceil(d/32)) int32 packed masks; ``slot_lams`` / ``slot_sizes`` /
    ``slot_valid`` (N, K); ``slot_tasks`` (N, K) with the sentinel
    ``n_tasks`` in invalid slots.  The composition is the JAX package's
    packed kernel path: scatter to the dense layout, Eq. 3+4 masked
    aggregation, Eq. 5 popcount dots, Eq. 6+7 in plain torch, then the
    downlink re-unification of every client's fresh task vectors.

    Returns (task_vectors (T, d) fp32, tau_hats (T, d) fp32, alpha_num
    (T, d) uint8, int32 when next_pow2(N) > 255, n_held (T,) fp32,
    similarity (T, T), down_unified (N, d) bf16, down_mask_words (N, K,
    ceil(d/32)) int32, down_lams (N, K)).  Tasks nobody holds give τ̂ =
    0, alpha_num = 0 and are masked out of the similarity.
    ``slot_weights`` as in :func:`matu_round_slots`.  ``group`` /
    ``axis_sizes`` / ``d_norm``: the taskvec-sharded round, ``d`` then
    being this rank's slice width and ``d_norm`` the global d.
    """
    if unified.shape[-1] != d:
        raise ValueError(f"unified width {unified.shape[-1]} != d={d}")
    slot_lams, slot_sizes = _apply_slot_weights(slot_lams, slot_sizes,
                                                slot_weights)
    words_d, lams_d, member_d, sizes_d = slots_to_dense_packed(
        slot_mask_words, slot_lams, slot_sizes, slot_valid, slot_tasks,
        n_tasks)
    memf, gam = _gammas(member_d, sizes_d)
    tau_hats, a_num = masked_agg_batched_packed(
        unified, words_d, lams_d, gam, member_d, d, rho=rho, mode=mode)
    n_t = torch.sum(memf, dim=0)
    task_vectors, sim = _finish(
        tau_hats, _m_hats(a_num, n_t, rho), n_t, d, packed=True, eps=eps,
        kappa=kappa, cross_task=cross_task, uniform_cross=uniform_cross,
        mode=mode, group=group, d_norm=d_norm)
    uni, dwords, lams = _downlink(task_vectors, slot_valid, slot_tasks,
                                  n_tasks, packed=True, lam_eps=lam_eps,
                                  mode=mode, group=group,
                                  axis_sizes=axis_sizes)
    return (task_vectors, tau_hats, _alpha_num(a_num, slot_valid.shape[0]),
            n_t, sim, uni, dwords, lams)


# ---------------------------------------------------------------------------
# The chunked round (``RoundEngine.round_chunked``): the monolithic round's
# operations split into per-chunk folds over carried accumulators.  As in
# the JAX package, no kernel folds the chunks: phases A and B are plain
# torch on any device.  The finish and phase C are the monolithic round's
# own tail (:func:`_finish`, :func:`_downlink`), kernels 3 / 6 and 1 / 4
# included, so chunked ≡ monolithic bit for bit on the card as on the CPU.
# ---------------------------------------------------------------------------


def matu_chunk_scalars(slot_sizes, slot_valid, slot_tasks, n_tasks: int, *,
                       slot_weights: Optional[torch.Tensor] = None,
                       mode: Optional[str] = None):
    """Phase A of the chunked round: one chunk's rows of the monolithic
    round's dense scalar tables, (members (C, T) bool, sizes (C, T)
    fp32), the sizes discounted by ``slot_weights`` as the monolithic
    round does (:func:`_apply_slot_weights`).  The engine stacks the
    chunks' rows and hands the round's tables to :func:`matu_gammas`."""
    _plain(mode)
    _, slot_sizes = _apply_slot_weights(None, slot_sizes, slot_weights)
    member_d = _scatter_slots(slot_valid, slot_tasks, n_tasks)
    sizes_d = _scatter_slots(torch.where(slot_valid, slot_sizes.float(), 0.0),
                             slot_tasks, n_tasks)
    return member_d, sizes_d


def matu_gammas(member_rows: torch.Tensor, size_rows: torch.Tensor):
    """The end of phase A, on the whole round's (N, T) tables: (member
    counts n_t (T,) fp32, Eq. 4 data weights γ (N, T)).  The γ
    normaliser is the monolithic round's ``torch.sum`` over the client
    axis, whose rounding only the whole column fixes: this is why phase
    A keeps the round's O(N·T) scalars rather than a (T,) running sum."""
    memf, gam = _gammas(member_rows, size_rows)
    return torch.sum(memf, dim=0), gam


def _slot_fold_args(slot_lams, slot_valid, slot_tasks, gammas, n_rows: int,
                    slot_weights):
    """Per-slot Eq. 4 weights γλ (C, K) fp32, 0 on invalid slots (γ of the
    slot's task times the discounted λ, the monolithic round's dense
    product), and each slot's accumulator row (C, K) int64: its task id,
    the sentinel row ``n_rows - 1`` for an invalid slot."""
    slot_lams, _ = _apply_slot_weights(slot_lams, None, slot_weights)
    valid = slot_valid.bool()
    rows = torch.where(valid, slot_tasks.long(), n_rows - 1)
    gam_ext = torch.nn.functional.pad(gammas.float(), (0, 1))
    gl = (torch.gather(gam_ext, 1, rows)
          * torch.where(valid, slot_lams.float(), 0.0))
    return gl, rows


def matu_merge_chunk_packed(unified, slot_mask_words, slot_lams, slot_valid,
                            slot_tasks, gammas, a_acc, tau_acc, d: int, *,
                            slot_weights: Optional[torch.Tensor] = None,
                            mode: Optional[str] = None):
    """Phase B, wire layout: fold one chunk's Eq. 3 sign votes into
    ``a_acc`` (T+1, d) int32 and its Eq. 4 partials into ``tau_acc``
    (T+1, d) fp32, in place, in ascending (client, slot) order
    (:func:`ref.matu_merge_chunk_ref`).  ``gammas`` are the chunk's rows
    of :func:`matu_gammas`.  Row T swallows the invalid slots.  Returns
    (a_acc, tau_acc)."""
    _plain(mode)
    gl, rows = _slot_fold_args(slot_lams, slot_valid, slot_tasks, gammas,
                               a_acc.shape[0], slot_weights)
    words = torch.where(slot_valid.bool()[:, :, None], slot_mask_words,
                        torch.zeros((), dtype=torch.int32,
                                    device=slot_mask_words.device))
    return ref.matu_merge_chunk_ref(
        unified, lambda i: bitpack.unpack_bits(words[i], d), gl, rows,
        a_acc, tau_acc)


def matu_merge_chunk(unified, slot_masks, slot_lams, slot_valid, slot_tasks,
                     gammas, a_acc, tau_acc, *,
                     slot_weights: Optional[torch.Tensor] = None,
                     mode: Optional[str] = None):
    """Phase B, bool/fp32 layout: :func:`matu_merge_chunk_packed` over
    dense (C, K, d) bool masks, the votes in an fp32 ``a_acc`` (exact
    small integers, the monolithic bool round's dtype)."""
    _plain(mode)
    gl, rows = _slot_fold_args(slot_lams, slot_valid, slot_tasks, gammas,
                               a_acc.shape[0], slot_weights)
    masks = slot_masks & slot_valid.bool()[:, :, None]
    return ref.matu_merge_chunk_ref(unified, lambda i: masks[i], gl, rows,
                                    a_acc, tau_acc)


def matu_finish_packed(a_acc, tau_acc, n_t, n_clients: int, *, d: int,
                       rho: float = 0.4, eps: float = 0.5, kappa: int = 3,
                       cross_task: bool = True, uniform_cross: bool = False,
                       mode: Optional[str] = None, group=None,
                       d_norm: int = 0):
    """Finish the chunked packed round from the accumulators: Eq. 3 m̂,
    τ̂ = partials ⊙ m̂ (the last step of kernel 2), then the monolithic
    tail :func:`_finish` (kernel 3).  ``n_clients`` is the round's
    client count (it picks the ``alpha_num`` dtype).  Under a taskvec
    ``group`` the accumulators are this rank's d-slice (``d`` its width,
    ``d_norm`` the global d) and the Eq. 5 dots take one psum.  Returns
    (task_vectors, tau_hats, alpha_num, n_t, similarity)."""
    t = n_t.shape[0]
    a_num = a_acc[:t].abs().float()
    m_hats = _m_hats(a_num, n_t, rho)
    tau_hats = tau_acc[:t] * m_hats
    task_vectors, sim = _finish(
        tau_hats, m_hats, n_t, d, packed=True, eps=eps, kappa=kappa,
        cross_task=cross_task, uniform_cross=uniform_cross, mode=mode,
        group=group, d_norm=d_norm)
    return task_vectors, tau_hats, _alpha_num(a_num, n_clients), n_t, sim


def matu_finish(a_acc, tau_acc, n_t, *, rho: float = 0.4, eps: float = 0.5,
                kappa: int = 3, cross_task: bool = True,
                uniform_cross: bool = False, mode: Optional[str] = None,
                group=None, d_norm: int = 0):
    """Finish the chunked bool-layout round (kernel 6 for Eq. 5; kernel 3
    and one psum under a taskvec ``group``, as
    :func:`matu_finish_packed`).  Returns (task_vectors, tau_hats,
    m_hats, n_t, similarity)."""
    t = n_t.shape[0]
    m_hats = _m_hats(a_acc[:t].abs(), n_t, rho)
    tau_hats = tau_acc[:t] * m_hats
    task_vectors, sim = _finish(
        tau_hats, m_hats, n_t, tau_hats.shape[-1], packed=False, eps=eps,
        kappa=kappa, cross_task=cross_task, uniform_cross=uniform_cross,
        mode=mode, group=group, d_norm=d_norm)
    return task_vectors, tau_hats, m_hats, n_t, sim


def matu_lam_num(task_vectors, *, group, axis_sizes):
    """The chunked round's λ numerators under a taskvec mesh: each task's
    Σ|τ_t| tree over this rank's d-slice, finished across ranks in one
    psum (``ref._lam_totals``), (T,) fp32.  Bitwise the numerator the
    fused unify gives a valid slot holding that task, so phase C psums
    only the denominators (the JAX package's budget)."""
    (num_t,) = ref._lam_totals((ref.lam_num_roots(task_vectors),), group,
                               axis_sizes)
    return num_t


def matu_downlink_chunk_packed(task_vectors, slot_valid, slot_tasks, *,
                               lam_eps: float = 1e-12,
                               mode: Optional[str] = None, num_t=None,
                               group=None, axis_sizes=()):
    """Phase C, wire layout: the monolithic downlink step
    (:func:`_downlink`, kernel 1) on one chunk's rows; under a taskvec
    ``group``, on this rank's d-slice with the global numerators
    ``num_t`` (:func:`matu_lam_num`) and one psum of the denominators.
    Returns (down_unified (C, d) bf16, down_mask_words (C, K,
    ceil(d/32)) int32, down_lams (C, K))."""
    return _downlink(task_vectors, slot_valid, slot_tasks,
                     task_vectors.shape[0], packed=True, lam_eps=lam_eps,
                     mode=mode, group=group, axis_sizes=axis_sizes,
                     num_t=num_t)


def matu_downlink_chunk(task_vectors, slot_valid, slot_tasks, *,
                        lam_eps: float = 1e-12, mode: Optional[str] = None,
                        num_t=None, group=None, axis_sizes=()):
    """Phase C, bool layout (kernel 4): (down_unified (C, d) fp32,
    down_masks (C, K, d) bool, down_lams (C, K)); ``num_t`` / ``group``
    as in :func:`matu_downlink_chunk_packed`."""
    return _downlink(task_vectors, slot_valid, slot_tasks,
                     task_vectors.shape[0], packed=False, lam_eps=lam_eps,
                     mode=mode, group=group, axis_sizes=axis_sizes,
                     num_t=num_t)
