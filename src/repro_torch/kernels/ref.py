"""Plain PyTorch versions of the round's kernels (the reference semantics).

Each hand-written CUDA kernel in this package computes one of the
functions below; the kernel module names its plain version, the CPU
path runs it, and ``chip_smoke.py`` holds the kernel against it on the
card.  The plain versions fix the same summation order as their kernels
(the λ block tree, ascending client order in Eq. 4), so kernel and
plain version agree bit for bit on the same device.

Against the JAX package (``repro.kernels.ref`` and the Pallas kernels):
mask words, sign votes and Eq. 5 dots are bit-identical; λ and the fp32
vectors agree to fp32 accumulation tolerance, because the in-block and
client-axis summation orders differ.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.kernels import bitpack
from repro_torch.nn import sharding

# Fixed block grid of the λ numerator/denominator reductions over d: one
# partial sum per LAMBDA_BLOCK consecutive coordinates, combined by a
# power-of-two binary tree over the block index (``_tree_total``).  One
# block is 8 packed words, so block alignment implies word alignment.
LAMBDA_BLOCK = 256
_WARP = 32
assert LAMBDA_BLOCK % bitpack.WORD_BITS == 0


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _halve(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum a power-of-two axis by repeated halving: element i pairs with
    i + n/2 — the order of a CUDA ``__shfl_down_sync`` tree."""
    while p.shape[dim] > 1:
        half = p.shape[dim] // 2
        p = p.narrow(dim, 0, half) + p.narrow(dim, half, half)
    return p.squeeze(dim)


def _block_partials(x: torch.Tensor) -> torch.Tensor:
    """(..., c) -> (..., c // LAMBDA_BLOCK) per-block partial sums (c a
    multiple of LAMBDA_BLOCK).  In-block order is the fused-unify
    kernel's: a shuffle tree over the 32 lanes of each warp, then a
    halving tree over the block's 8 warps."""
    s = x.shape
    p = x.reshape(s[:-1] + (s[-1] // LAMBDA_BLOCK, LAMBDA_BLOCK // _WARP,
                            _WARP))
    return _halve(_halve(p, -1), -1)


def _tree_total(p: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (...,): canonical binary-tree sum pairing (2i, 2i+1)
    at every level after zero-padding L to a power of two."""
    L = p.shape[-1]
    Lp = next_pow2(L)
    if Lp != L:
        p = torch.nn.functional.pad(p, (0, Lp - L))
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _shard_offset(group, axis_sizes) -> int:
    """This rank's taskvec shard index: its rank in ``group``, whose
    ranks ascend in shard order (``nn.sharding.TaskvecLayout``)."""
    n = math.prod(axis_sizes)
    if dist.get_world_size(group) != n:
        raise ValueError(f"group of {dist.get_world_size(group)} ranks for "
                         f"{n} taskvec shards")
    return dist.get_rank(group)


def _lam_totals(parts, group=None, axis_sizes=()):
    """Finish the λ reductions from this shard's tree roots.

    Each ``parts`` entry holds the roots (…) of a λ numerator or
    denominator tree over this rank's d-slice, a power-of-two number of
    whole LAMBDA_BLOCKs (``core.engine.pad_d_for_shards``).  Without a
    group they are the totals.  Under one, the roots of every entry are
    scattered into this shard's column of one (…, n_shards) tensor
    (a single nonzero contributor per element, so the sum is exact), ONE
    :func:`~repro_torch.nn.sharding.psum` carries them all, and
    :func:`_tree_total` finishes over the shards.  Since the tree pairs
    (2i, 2i+1), contiguous power-of-two shard subtrees compose into the
    canonical tree over the global block grid, whose zero-padded tail
    adds exact zeros: the totals are bitwise the unsharded ones."""
    if group is None:
        return tuple(parts)
    n_sh = math.prod(axis_sizes)
    off = _shard_offset(group, axis_sizes)
    flat = torch.cat([p.reshape(-1) for p in parts])
    scat = torch.zeros((flat.shape[0], n_sh), dtype=flat.dtype,
                       device=flat.device)
    scat[:, off] = flat
    total = _tree_total(sharding.psum(scat, group))
    out, at = [], 0
    for p in parts:
        out.append(total[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return tuple(out)


def lam_num_roots(task_vectors: torch.Tensor) -> torch.Tensor:
    """(T, c) -> (T,): the λ numerator tree of each row, Σ|τ_t| on the
    λ block grid (c a multiple of LAMBDA_BLOCK): the fused-unify
    numerator of a valid slot holding task t."""
    return _tree_total(_block_partials(task_vectors.float().abs()))


def _elect(xm: torch.Tensor) -> torch.Tensor:
    """Eq. 2 on (…, K, c) with invalid slots already zeroed: σ = sgn of
    the slot sum (k = 0, 1, … in order, as in the kernels), μ = max |x|
    over the slots aligned with σ; returns τ = σ·μ (…, c)."""
    s = xm[..., 0, :]
    for k in range(1, xm.shape[-2]):
        s = s + xm[..., k, :]
    sigma = torch.sign(s)
    aligned = (xm * sigma[..., None, :]) > 0
    mu = torch.amax(torch.where(aligned, xm.abs(), 0.0), dim=-2)
    return sigma * mu


def _unify_block(x: torch.Tensor, vf: torch.Tensor):
    """Eq. 2 + modulators on a (…, K, c) block; vf (…, K) float {0, 1};
    c a multiple of LAMBDA_BLOCK.  Returns (tau (…, c), mask (…, K, c)
    bool, num partials, den partials) with the partials on the λ grid."""
    xm = x * vf[..., None]
    tau = _elect(xm)
    mask = ((x * tau[..., None, :]) > 0) & (vf[..., None] > 0)
    num = _block_partials(xm.abs())
    den = _block_partials(torch.where(mask, tau.abs()[..., None, :], 0.0))
    return tau, mask, num, den


def unify_ref(task_vectors: torch.Tensor) -> torch.Tensor:
    """Eq. 2 for one client: (K, d) -> (d,) fp32, any K >= 1."""
    return _elect(task_vectors.float())


def fused_unify_ref(task_vectors: torch.Tensor, valid: torch.Tensor):
    """Fused unify + task masks + λ num/den in the bool/fp32 layout.

    task_vectors (B, K, d) fp32/bf16; valid (B, K) bool.  Returns
    (unified (B, d) fp32, masks (B, K, d) bool, num (B, K), den (B, K));
    invalid slots give zero mask rows and num = den = 0.  Both layouts
    share this fp32 core, so masks and λ are bitwise the same in both.
    """
    b, k, d = task_vectors.shape
    pad = (-d) % LAMBDA_BLOCK
    x = task_vectors.float()
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    tau, mask, num_p, den_p = _unify_block(x, valid.float())
    return (tau[:, :d], mask[..., :d], _tree_total(num_p),
            _tree_total(den_p))


def fused_unify_packed_ref(task_vectors: torch.Tensor, valid: torch.Tensor):
    """Fused unify + task masks + λ num/den, batched over clients, in the
    uplink wire format.

    task_vectors (B, K, d) fp32/bf16; valid (B, K) bool.  Compute is
    fp32; mask bits and λ num/den are decided on the fp32 values before
    the unified vector is rounded to bf16.  Returns (unified (B, d)
    bf16, mask_words (B, K, ceil(d/32)) int32, num (B, K), den (B, K));
    invalid slots give zero mask rows and num = den = 0.
    """
    tau, mask, num, den = fused_unify_ref(task_vectors, valid)
    return tau.to(torch.bfloat16), bitpack.pack_bits(mask), num, den


def alpha_dtype(n: int) -> torch.dtype:
    """Narrowest dtype holding the Eq. 3 agreement numerator
    |Σ_n sgn(m ⊙ τ_n)| ≤ n (an exact small integer)."""
    return torch.uint8 if n <= 255 else torch.int32


def _masked_agg(unified: torch.Tensor, mask_row, lams: torch.Tensor,
                gammas: torch.Tensor, members: torch.Tensor, rho: float):
    """Eq. 3 + Eq. 4 over all tasks, ``mask_row(n)`` giving client n's
    (T, d) bool masks.  Sign votes are m&pos − m&neg with (pos, neg) the
    sign of ``unified``; the client sum runs in ascending n with one
    fp32 rounding per product and per add — the order of the CUDA
    kernels.  Returns (tau_hats, alpha_num, m_hats), each (T, d) fp32."""
    n, t = members.shape
    u = unified.float()
    mem = members.float()
    gl = gammas.float() * lams.float()
    votes = torch.zeros((t, u.shape[-1]), dtype=torch.float32,
                        device=u.device)
    acc = torch.zeros_like(votes)
    for i in range(n):
        m = mask_row(i)                                     # (T, d)
        sp = (m & (u[i] > 0)).float()
        sn = (m & (u[i] < 0)).float()
        votes = votes + mem[i, :, None] * (sp - sn)
        acc = acc + gl[i, :, None] * (u[i] * (sp + sn))
    a_num = votes.abs()
    alpha = a_num / torch.clamp(mem.sum(0), min=1.0)[:, None]
    m_hat = torch.where(alpha >= rho, 1.0, alpha)
    return acc * m_hat, a_num, m_hat


def matu_merge_chunk_ref(unified: torch.Tensor, mask_row, gl: torch.Tensor,
                         rows: torch.Tensor, a_acc: torch.Tensor,
                         tau_acc: torch.Tensor):
    """Phase B of the chunked round: :func:`_masked_agg`'s client loop on
    one chunk, each client's adds landing in the accumulator rows of its
    slots.  unified (C, d); ``mask_row(i)`` client i's (K, d) bool slot
    masks (zero rows for invalid slots); gl (C, K) fp32 γλ a slot; rows
    (C, K) int64 its task id (distinct within a client; invalid slots
    share the sentinel row, whose sums are never read).  a_acc (T+1, d)
    int32 or fp32 sign votes and tau_acc (T+1, d) fp32 Eq. 4 partials are
    updated in place and returned.

    The adds are :func:`_masked_agg`'s, one rounding per product and per
    add, in ascending client order; a non-member's add there is a signed
    zero, which leaves the sum as it is.  So folding every chunk of a
    round in client order gives the monolithic partials bit for bit, for
    any chunking.  Each client's update is one gather and one write of
    its K distinct rows: never an unordered scatter-add (atomics on CUDA)
    nor a ``+=`` through repeated indices."""
    u = unified.float()
    for i in range(u.shape[0]):
        m = mask_row(i)                                     # (K, d)
        sp = m & (u[i] > 0)
        sn = m & (u[i] < 0)
        r = rows[i]
        a_acc[r] = a_acc[r] + (sp.to(a_acc.dtype) - sn.to(a_acc.dtype))
        tau_acc[r] = tau_acc[r] + gl[i, :, None] * (u[i] * (sp.float()
                                                          + sn.float()))
    return a_acc, tau_acc


def masked_agg_batched_ref(unified: torch.Tensor, masks: torch.Tensor,
                           lams: torch.Tensor, gammas: torch.Tensor,
                           members: torch.Tensor, rho: float):
    """Whole-round Eq. 3 + Eq. 4 over dense (N, T, d) bool masks.

    unified (N, d) fp32/bf16; lams/gammas/members (N, T); non-member
    rows carry zero masks and zero gamma.  m̂ = 1 if a_num/N_t ≥ ρ else
    a_num/N_t, with N_t the member count (a member with zero data weight
    still counts).  Returns (tau_hats (T, d) fp32, m_hats (T, d) fp32);
    τ̂ is bitwise :func:`masked_agg_batched_packed_ref`'s on the same
    masks."""
    tau, _, m_hat = _masked_agg(unified, lambda i: masks[i].bool(), lams,
                                gammas, members, rho)
    return tau, m_hat


def masked_agg_batched_packed_ref(unified: torch.Tensor,
                                  mask_words: torch.Tensor,
                                  lams: torch.Tensor, gammas: torch.Tensor,
                                  members: torch.Tensor, d: int,
                                  rho: float):
    """Whole-round Eq. 3 + Eq. 4 over packed (N, T, ceil(d/32)) mask
    words: :func:`masked_agg_batched_ref` on the unpacked rows.  Returns
    (tau_hats (T, d) fp32, alpha_num (T, d) fp32)."""
    tau, a_num, _ = _masked_agg(
        unified, lambda i: bitpack.unpack_bits(mask_words[i], d), lams,
        gammas, members, rho)
    return tau, a_num


def masked_agg_ref(unified: torch.Tensor, masks: torch.Tensor,
                   lams: torch.Tensor, gammas: torch.Tensor, rho: float):
    """Single-task Eq. 3 + Eq. 4 with membership from γ > 0.

    unified (N, d) fp32/bf16; masks (N, d) bool or {0, 1}; lams, gammas
    (N,), gammas the normalised data weights (0 for non-members).  N_t
    is the count of γ > 0, at least 1; rows with γ = 0 add nothing,
    whatever their mask.  Returns (tau_hat (d,) fp32, m_hat (d,) fp32),
    bitwise the batched :func:`_masked_agg`'s row for this task."""
    members = gammas > 0
    m = (masks != 0) & members[:, None]
    tau, _, m_hat = _masked_agg(unified, lambda i: m[i:i + 1],
                                lams[:, None], gammas[:, None],
                                members[:, None], rho)
    return tau[0], m_hat[0]


def modulated_weight_ref(base: torch.Tensor, tau: torch.Tensor,
                         words: torch.Tensor, lam: torch.Tensor
                         ) -> torch.Tensor:
    """Per-request effective weights ``base + (λ_b · m_b) · τ``: base
    (K, N) fp32, tau (K, N) fp32/bf16, words (B, ceil(K·N/32)) int32
    over the row-major (K, N) leaf, lam (B,).  Returns (B, K, N) fp32,
    one rounding per product and per add: for bits in {0, 1} this is
    bitwise the materialised adapter ``base + λ·where(m, τ, 0)``."""
    k, n = base.shape
    bits = bitpack.unpack_bits(words, k * n, torch.float32).reshape(
        (-1, k, n))
    return (base.float()[None]
            + (lam.float()[:, None, None] * bits) * tau.float()[None])


def modulated_matmul_ref(x: torch.Tensor, base: torch.Tensor,
                         tau: torch.Tensor, words: torch.Tensor,
                         lam: torch.Tensor) -> torch.Tensor:
    """The unpack-then-matmul oracle of the fused serving matmul:
    x (B, S, K) -> (B, S, N) fp32, ``y_b = x_b @ w_eff_b`` with
    :func:`modulated_weight_ref`'s weights, the product in fp32."""
    w_eff = modulated_weight_ref(base, tau, words, lam)
    return torch.einsum("bsk,bkn->bsn", x.float(), w_eff)


def logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """log σ(x) = -softplus(-x), with JAX's softplus ``logaddexp(y, 0)``
    (torch's ``softplus`` returns y itself above its threshold of 20)."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor, state, *,
                        chunk: int):
    """Chunkwise-parallel stabilised mLSTM (the JAX package's
    ``nn/ssm.py::mlstm_chunkwise``): q, k (B, H, S, Dk) — q pre-scaled —
    v (B, H, S, Dv) in the model dtype; i_pre, f_pre (B, H, S); state
    (C (B, H, Dk, Dv), n (B, H, Dk), m (B, H)) fp32.  Returns (h
    (B, H, S, Dv) in v's dtype, (C, n, m)).

    S is padded to a chunk multiple with identity steps (q = k = v = 0,
    i = -1e30, f = +40) exactly as the JAX package pads: they still
    decay the final state by exp(-softplus(-40)) per step.  The model
    dtype's rounding points are the JAX package's: the q·k scores, w
    before w @ v, and that product, round to v's dtype (the identity in
    fp32); everything else is fp32.  One departure, shared with the
    kernel: the log-forget-gate cumsum is summed in fp64 and rounded
    once, so any summation order gives the same fp32 ``bcum``."""
    s = q.shape[2]
    nc = -(-s // chunk)
    q, k, v = (_pad_steps(x, chunk) for x in (q, k, v))
    i_pre = _pad_steps(i_pre, chunk, -1e30)
    f_pre = _pad_steps(f_pre, chunk, 40.0)
    C, n, m = state
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()
    hs = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        ic = i_pre[:, :, sl].float()
        log_f = logsigmoid(f_pre[:, :, sl].float())
        bcum = torch.cumsum(log_f.double(), dim=-1).float()
        c = ic - bcum
        cmax = torch.cummax(c, dim=-1).values
        m_t = bcum + torch.maximum(m[..., None], cmax)

        scale_inter = torch.exp(bcum + m[..., None] - m_t)
        h_inter = (qc.float() @ C) * scale_inter[..., None]
        qn_inter = (qc.float() @ n[..., None])[..., 0] * scale_inter

        d_log = bcum[..., :, None] - bcum[..., None, :] + ic[..., None, :]
        d_mat = torch.where(causal, torch.exp(d_log - m_t[..., None]), 0.0)
        scores = (qc @ kc.transpose(-1, -2)).float()
        w = d_mat * scores
        h_intra = w.to(vc.dtype) @ vc
        qn_intra = torch.sum(w, dim=-1)

        qn = qn_inter + qn_intra
        denom = torch.maximum(qn.abs(), torch.exp(-m_t))[..., None]
        hs.append(((h_inter + h_intra.float()) / denom).to(v.dtype))

        total = bcum[..., -1]
        m_next = torch.maximum(m + total, total + torch.amax(c, dim=-1))
        wgt = torch.exp(total[..., None] - bcum + ic - m_next[..., None])
        decay = torch.exp(m + total - m_next)
        kw = wgt[..., None] * kc.float()
        C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vc.float()
        n = decay[..., None] * n + torch.sum(kw, dim=-2)
        m = m_next
    h = torch.cat(hs, dim=2)[:, :, :s]
    return h, (C, n, m)


def _pad_steps(x: torch.Tensor, chunk: int, value: float = 0.0):
    """Pad the step axis (dim 2) of x to a chunk multiple with ``value``:
    the mLSTM's identity steps are q = k = v = 0, i = -1e30, f = +40."""
    pad = -x.shape[2] % chunk
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, pad),
                                   value=value)


def mlstm_chunk_prepass_ref(q: torch.Tensor, k: torch.Tensor,
                            i_pre: torch.Tensor, f_pre: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor, *,
                            chunk: int):
    """The part of :func:`mlstm_chunkwise_ref` that depends on all of Dk
    and on no value column: kernel 10's pre-pass.  q, k (B, H, S, Dk) in
    the model dtype T; i_pre, f_pre (B, H, S); n0 (B, H, Dk), m0 (B, H)
    fp32.  Returns a dict, nc = ceil(S / chunk), L = chunk:

    * per step (B, H, nc, L), fp32: ``bcum``, ``i`` (padded), ``m_t``,
      ``scale_inter``, ``wgt``, ``qn_intra`` (the row sum of the
      unrounded w) and ``den`` (the divisor of h);
    * per chunk: ``decay``, ``m`` (m at the chunk's start) (B, H, nc) and
      ``n`` (n at the chunk's start) (B, H, nc, Dk), fp32;
    * ``w`` (B, H, nc, L, L) in T: the causal decay-weighted scores;
    * ``n_final``, ``m_final``: the state's n and m after the last chunk.

    Same ops in the same order as :func:`mlstm_chunkwise_ref`."""
    q, k = _pad_steps(q, chunk), _pad_steps(k, chunk)
    i_pre = _pad_steps(i_pre, chunk, -1e30)
    f_pre = _pad_steps(f_pre, chunk, 40.0)
    nc = q.shape[2] // chunk
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()
    out = {key: [] for key in ("bcum", "i", "m_t", "scale_inter", "wgt",
                               "qn_intra", "den", "decay", "m", "n", "w")}
    n, m = n0, m0
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qc, kc = q[:, :, sl], k[:, :, sl]
        ic = i_pre[:, :, sl].float()
        bcum = torch.cumsum(logsigmoid(f_pre[:, :, sl].float()).double(),
                            dim=-1).float()
        c = ic - bcum
        m_t = bcum + torch.maximum(m[..., None],
                                   torch.cummax(c, dim=-1).values)
        scale_inter = torch.exp(bcum + m[..., None] - m_t)
        qn_inter = (qc.float() @ n[..., None])[..., 0] * scale_inter
        d_log = bcum[..., :, None] - bcum[..., None, :] + ic[..., None, :]
        d_mat = torch.where(causal, torch.exp(d_log - m_t[..., None]), 0.0)
        w = d_mat * (qc @ kc.transpose(-1, -2)).float()
        qn_intra = torch.sum(w, dim=-1)
        den = torch.maximum((qn_inter + qn_intra).abs(), torch.exp(-m_t))
        total = bcum[..., -1]
        m_next = torch.maximum(m + total, total + torch.amax(c, dim=-1))
        wgt = torch.exp(total[..., None] - bcum + ic - m_next[..., None])
        decay = torch.exp(m + total - m_next)
        for key, val in (("bcum", bcum), ("i", ic), ("m_t", m_t),
                         ("scale_inter", scale_inter), ("wgt", wgt),
                         ("qn_intra", qn_intra), ("den", den),
                         ("decay", decay), ("m", m), ("n", n),
                         ("w", w.to(q.dtype))):
            out[key].append(val)
        n = decay[..., None] * n + torch.sum(wgt[..., None] * kc.float(),
                                             dim=-2)
        m = m_next
    res = {key: torch.stack(val, dim=2) for key, val in out.items()}
    res["n_final"], res["m_final"] = n, m
    return res


def mlstm_chunk_main_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         C0: torch.Tensor, pre, *, chunk: int):
    """The part of :func:`mlstm_chunkwise_ref` that depends on C and the
    value columns: kernel 10's main kernel, from the pre-pass's outputs
    ``pre`` (:func:`mlstm_chunk_prepass_ref`).  Returns (h (B, H, S, Dv)
    in v's dtype, C (B, H, Dk, Dv) fp32)."""
    s = q.shape[2]
    q, k, v = (_pad_steps(x, chunk) for x in (q, k, v))
    C, hs = C0, []
    for ci in range(q.shape[2] // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        h_inter = (qc.float() @ C) * pre["scale_inter"][:, :, ci, :, None]
        h_intra = pre["w"][:, :, ci] @ vc
        hs.append(((h_inter + h_intra.float())
                   / pre["den"][:, :, ci, :, None]).to(v.dtype))
        kw = pre["wgt"][:, :, ci, :, None] * kc.float()
        C = (pre["decay"][:, :, ci, None, None] * C
             + kw.transpose(-1, -2) @ vc.float())
    return torch.cat(hs, dim=2)[:, :, :s], C


def sign_sim_ref(tau_hats: torch.Tensor) -> torch.Tensor:
    """Eq. 5 over dense (T, d): S = ½(sgn(τ̂)·sgn(τ̂)ᵀ/d + 1), (T, T)
    fp32.  The dots are integers below 2^24, exact in fp32 whatever the
    summation order."""
    s = torch.sign(tau_hats.float())
    return sim_from_dots(s @ s.T, tau_hats.shape[-1])


def sim_from_dots(dots: torch.Tensor, d: int) -> torch.Tensor:
    """S = ½(dots/d + 1) from raw (T, T) sign dots."""
    return 0.5 * (dots.float() / d + 1.0)


def sign_sim_packed_ref(pos: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """Eq. 5 raw sign dots (T, T) fp32 (exact integers) from (pos, nz)
    bit-planes; the caller normalises by the unpacked d."""
    return bitpack.packed_sign_dots(pos, nz).float()


def cross_weights_ref(sim: torch.Tensor, held: torch.Tensor, *, eps: float,
                      kappa: int, cross_task: bool,
                      uniform_cross: bool) -> torch.Tensor:
    """Eq. 6 neighbourhood weights from the held-masked similarity."""
    heldf = held.to(sim.dtype)
    if not cross_task:
        return torch.zeros_like(sim)
    if uniform_cross:
        t = sim.shape[0]
        eye = torch.eye(t, dtype=sim.dtype, device=sim.device)
        w = (1.0 - eye) * heldf[None, :] * heldf[:, None]
        return w / torch.clamp(torch.sum(w, 1, keepdim=True), min=1.0)
    return topk_weights_ref(sim, eps, kappa)


def topk_weights_ref(sim: torch.Tensor, eps: float, kappa: int) -> torch.Tensor:
    """Eq. 6 top-κ neighbourhood Z^t as a (T, T) weight matrix.  Only the
    κ-th value is used (as a threshold), so tie order never matters."""
    t = sim.shape[0]
    eye = torch.eye(t, dtype=sim.dtype, device=sim.device)
    offdiag = sim * (1.0 - eye)
    eligible = torch.where(offdiag > eps, offdiag, 0.0)
    k = min(kappa, t - 1) if t > 1 else 0
    if k == 0:
        return torch.zeros_like(sim)
    vals, _ = torch.topk(eligible, k, dim=-1)
    thresh = vals[:, -1:]
    keep = (eligible >= thresh) & (eligible > 0)
    return torch.where(keep, eligible, 0.0)


# Eq. 7's (T, T)·(T, d) product on a CUDA tensor runs in contiguous column
# blocks of this width, the last one zero-padded: one GEMM shape whatever
# d, so a column's bits do not depend on the width a round, or a shard of
# one, holds.  cuBLAS picks split-K for some widths (1,048,576 at T 30 on
# the H100), which changes the rounding.
MIX_BLOCK = 65_536


def _mix(norm_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``norm_w @ x`` for (T, T) weights and (T, d) rows, its bits
    independent of d: on the CPU one product (its rounding does not
    depend on d), on a CUDA device :data:`MIX_BLOCK`-wide blocks written
    into one (T, d) output, only the last partial block zero-padded."""
    if x.device.type != "cuda":
        return norm_w @ x
    d = x.shape[-1]
    out = torch.empty((norm_w.shape[0], d), dtype=torch.result_type(
        norm_w, x), device=x.device)
    for s in range(0, d, MIX_BLOCK):
        blk = x[:, s:s + MIX_BLOCK]
        w = blk.shape[-1]
        if w < MIX_BLOCK:
            blk = torch.nn.functional.pad(blk, (0, MIX_BLOCK - w))
        out[:, s:s + w] = (norm_w @ blk.contiguous())[:, :w]
    return out


def cross_task_combine_ref(tau_hats: torch.Tensor, m_hats: torch.Tensor,
                           sim_weights: torch.Tensor):
    """Eq. 6 + Eq. 7: normalised cross-task mix, then the overview's
    averaging.  Returns (task_vectors (T, d), tau_tildes (T, d))."""
    total = torch.sum(sim_weights, dim=1, keepdim=True)
    norm_w = sim_weights / torch.clamp(total, min=1e-12)
    tau_tildes = m_hats * _mix(norm_w, tau_hats)
    has = (total > 0).to(tau_hats.dtype)
    task_vectors = (tau_hats + tau_tildes * has) / (1.0 + has)
    return task_vectors, tau_tildes
