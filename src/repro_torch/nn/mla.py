"""Multi-head Latent Attention (DeepSeek-V2), the JAX package's
``nn/mla.py::MLAttention`` op for op.

Two execution regimes, as in the JAX package:

* ``__call__`` / ``prefill`` — the naive expansion: the normed latent
  c_kv is decompressed through ``wkv_b`` to per-head keys (nope part,
  then the one shared roped key broadcast over heads) and values, and
  attended as standard attention; ``impl`` picks materialised scores
  ("full") or a loop over query chunks of ``q_chunk`` rows ("chunked";
  "auto": full only when the queries fit one chunk).
* ``decode_step`` — the absorbed form: the cache holds only the normed
  latent c_kv (B, S, kv_lora) and the roped key k_rope (B, S, rope) a
  slot; the query's nope part is taken into latent space through
  ``wkv_b``'s key half and scored against c_kv directly, and the context
  leaves latent space through its value half.  It is not bitwise the
  naive form: the products sum in another order.

The cache is preallocated (``c_kv``, ``k_rope`` and ``kpos``, the
position held in each slot, -1 when empty) and updated in place: a ring
buffer when a sliding window is set.  Softmax math is fp32 whatever the
activation dtype, with a -1e30 mask; scores scale by 1/sqrt(nope +
rope).  LoRA attaches to ``wq_a`` and ``wo``; ``mode`` reaches their
``Dense`` so the fused route runs kernel 9 there.  Under a mesh q keeps
its heads over ``model`` (each query chunk too) and the output joins the
sequence-parallel residual, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.nn.attention import sharded_sdpa
from repro_torch.nn.module import Dense, Module, RMSNorm
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.sharding import constrain, split_last

Tree = Any
NEG_INF = -1e30


class MLAttention(Module):
    def __init__(self, d_model: int, n_heads: int, *,
                 q_lora_rank: int = 1536, kv_lora_rank: int = 512,
                 qk_nope_dim: int = 128, qk_rope_dim: int = 64,
                 v_head_dim: int = 128, rope_base: float = 10000.0,
                 window: Optional[int] = None, q_chunk: int = 512,
                 dtype=torch.float32):
        self.d_model, self.n_heads = d_model, n_heads
        self.q_lora_rank, self.kv_lora_rank = q_lora_rank, kv_lora_rank
        self.nope, self.rope_dim, self.v_dim = (qk_nope_dim, qk_rope_dim,
                                                v_head_dim)
        self.qk_dim = qk_nope_dim + qk_rope_dim
        self.rope_base = rope_base
        self.window = window
        self.q_chunk = q_chunk
        self.dtype = dtype
        self.scale = 1.0 / math.sqrt(self.qk_dim)
        self.wq_a = Dense(d_model, q_lora_rank, axes=("embed", None),
                          dtype=dtype)
        self.q_norm = RMSNorm(q_lora_rank, dtype=dtype)
        self.wq_b = Dense(q_lora_rank, n_heads * self.qk_dim,
                          axes=(None, "heads"), dtype=dtype)
        self.wkv_a = Dense(d_model, kv_lora_rank + qk_rope_dim,
                           axes=("embed", None), dtype=dtype)
        self.kv_norm = RMSNorm(kv_lora_rank, dtype=dtype)
        self.wkv_b = Dense(kv_lora_rank, n_heads * (qk_nope_dim + v_head_dim),
                           axes=(None, "heads"), dtype=dtype)
        self.wo = Dense(n_heads * v_head_dim, d_model, axes=("heads", "embed"),
                        dtype=dtype,
                        scale=1.0 / math.sqrt(n_heads * v_head_dim))

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"wq_a": self.wq_a.init(generator, device, lead),
                "q_norm": self.q_norm.init(None, device, lead),
                "wq_b": self.wq_b.init(generator, device, lead),
                "wkv_a": self.wkv_a.init(generator, device, lead),
                "kv_norm": self.kv_norm.init(None, device, lead),
                "wkv_b": self.wkv_b.init(generator, device, lead),
                "wo": self.wo.init(generator, device, lead)}

    def axes(self):
        return {"wq_a": self.wq_a.axes(), "q_norm": self.q_norm.axes(),
                "wq_b": self.wq_b.axes(), "wkv_a": self.wkv_a.axes(),
                "kv_norm": self.kv_norm.axes(), "wkv_b": self.wkv_b.axes(),
                "wo": self.wo.axes()}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"wq_a": self.wq_a.lora_init(generator, rank, device, lead),
                "wo": self.wo.lora_init(generator, rank, device, lead)}

    def lora_axes(self):
        return {"wq_a": self.wq_a.lora_axes(), "wo": self.wo.lora_axes()}

    def cache_axes(self):
        return {"c_kv": ("batch", "cache_seq", None),
                "k_rope": ("batch", "cache_seq", None),
                "kpos": ("cache_seq",)}

    # -- shared projections ------------------------------------------------
    def _q(self, params, x, positions, lora, mode):
        """-> (q_nope (B, S, H, nope), q_rope (B, S, H, rope) roped)."""
        lora = lora or {}
        b, s = x.shape[0], x.shape[1]
        q = self.wq_b(params["wq_b"], self.q_norm(
            params["q_norm"], self.wq_a(params["wq_a"], x, lora.get("wq_a"),
                                        mode=mode)))
        q = constrain(split_last(q, self.n_heads),
                      ("batch", None, "heads", None))
        q_nope, q_rope = q[..., :self.nope], q[..., self.nope:]
        if positions is not None:
            q_rope = apply_rope(q_rope, positions, base=self.rope_base)
        return q_nope, q_rope

    def _latent(self, params, x, positions):
        """-> (c_kv normed (B, S, kv_lora), k_rope (B, S, rope) roped as
        one head); ``wkv_a`` carries no LoRA."""
        kv_a = self.wkv_a(params["wkv_a"], x)
        c_kv = self.kv_norm(params["kv_norm"], kv_a[..., :self.kv_lora_rank])
        k_rope = kv_a[..., self.kv_lora_rank:][:, :, None, :]
        if positions is not None:
            k_rope = apply_rope(k_rope, positions, base=self.rope_base)
        return c_kv, k_rope[:, :, 0, :]

    def _wkv_b_split(self, params):
        """``wkv_b`` (kv_lora, H·(nope + v)) as (kv_lora, H, nope) keys and
        (kv_lora, H, v) values: head-major, each head's nope columns
        first, then its v columns."""
        w = params["wkv_b"]["w"].reshape(self.kv_lora_rank, self.n_heads,
                                         self.nope + self.v_dim)
        return w[..., :self.nope], w[..., self.nope:]

    def _out(self, params, ctx, lora, mode):
        lora = lora or {}
        b, s = ctx.shape[0], ctx.shape[1]
        y = self.wo(params["wo"], ctx.reshape(b, s, self.n_heads * self.v_dim),
                    lora.get("wo"), mode=mode)
        return constrain(y, ("batch", "act_seq", "embed"))

    # -- full sequence (the naive expansion) ---------------------------------
    def _mask(self, q_pos, k_pos):
        """q_pos (Q,), k_pos (K,) -> bool (Q, K); True = attend."""
        ok = k_pos[None, :] <= q_pos[:, None]
        if self.window is not None:
            ok &= (q_pos[:, None] - k_pos[None, :]) < self.window
        return ok

    def _sdpa(self, q, k, v, mask):
        """:meth:`_sdpa_block`, or on each rank's blocks for a DTensor q
        (``attention.sharded_sdpa``)."""
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor):
            return sharded_sdpa(self._sdpa_block, q, k, v, mask)
        return self._sdpa_block(q, k, v, mask)

    def _sdpa_block(self, q, k, v, mask):
        """q / k (B, S, H, nope + rope), v (B, S, H, v), mask (Q, S):
        scores in the activation dtype, fp32 scale, mask and softmax,
        probabilities in v's dtype."""
        scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() * self.scale
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhqs,bshd->bqhd", probs, v)

    def _chunked(self, q, k, v, pos, q_chunk: int):
        """The JAX package's scan over query chunks as a loop: the queries
        padded to whole chunks at position -1, padded rows masked out
        and cut off after."""
        s = q.shape[1]
        n_chunks = -(-s // q_chunk)
        pad = n_chunks * q_chunk - s
        pos_p = pos
        if pad:
            q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
            pos_p = torch.cat([pos, torch.full((pad,), -1, dtype=pos.dtype,
                                               device=pos.device)])
        out = []
        for c0 in range(0, n_chunks * q_chunk, q_chunk):
            qp = pos_p[c0:c0 + q_chunk]
            mask = self._mask(qp, pos) & (qp >= 0)[:, None]
            qc = constrain(q[:, c0:c0 + q_chunk],
                           ("batch", None, "heads", None))
            out.append(self._sdpa(qc, k, v, mask))
        return torch.cat(out, dim=1)[:, :s]

    def _forward(self, params, x, positions, lora, impl: str, mode):
        """The naive expansion -> (y (B, S, d), c_kv, k_rope)."""
        if impl not in ("full", "chunked", "auto"):
            raise ValueError(f"impl must be full, chunked or auto, got "
                             f"{impl!r}")
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q_nope, q_rope = self._q(params, x, positions, lora, mode)
        c_kv, k_rope = self._latent(params, x, positions)
        wk, wv = self._wkv_b_split(params)
        k_nope = torch.einsum("bsc,chd->bshd", c_kv, wk)
        v = torch.einsum("bsc,chd->bshd", c_kv, wv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, self.n_heads, self.rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        pos = positions[0]
        if impl == "full" or s <= self.q_chunk:
            ctx = self._sdpa(q, k, v, self._mask(pos, pos))
        else:
            ctx = self._chunked(q, k, v, pos, self.q_chunk)
        return self._out(params, ctx, lora, mode), c_kv, k_rope

    def __call__(self, params, x, *, positions=None, lora=None,
                 impl: str = "full", mode: Optional[str] = None):
        """x (B, S, d) -> (B, S, d); positions (B, S), 0..S-1 by default;
        the mask reads ``positions[0]``."""
        return self._forward(params, x, positions, lora, impl, mode)[0]

    # -- serving: the compressed-latent cache ----------------------------------
    def cache_len(self, max_len: int) -> int:
        return min(max_len, self.window) if self.window is not None \
            else max_len

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   lead: Sequence[int] = ()):
        dtype = dtype or self.dtype
        s = self.cache_len(max_len)
        lead = tuple(lead)
        return {"c_kv": torch.zeros(lead + (batch, s, self.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros(lead + (batch, s, self.rope_dim),
                                      dtype=dtype, device=device),
                "kpos": torch.full(lead + (s,), -1, dtype=torch.int32,
                                   device=device)}

    def prefill(self, params, x, cache, *, positions=None, lora=None,
                mode: Optional[str] = None):
        """The naive expansion by the "chunked" rule, and the latent cache
        filled in place (the trailing window, slot = pos % length, when
        the prompt is at least as long as the cache).  The latent is
        computed once: ``wkv_a`` has no LoRA, so the JAX package's second
        ``_latent`` gives the same values."""
        y, c_kv, k_rope = self._forward(params, x, positions, lora,
                                        "chunked", mode)
        s = x.shape[1]
        s_cache = cache["c_kv"].shape[1]
        if s >= s_cache:
            start = s - s_cache
            kpos = torch.arange(start, s, device=x.device)
            slots = kpos % s_cache
            cache["c_kv"][:, slots] = c_kv[:, start:].to(cache["c_kv"].dtype)
            cache["k_rope"][:, slots] = k_rope[:, start:].to(
                cache["k_rope"].dtype)
            cache["kpos"][slots] = kpos.to(torch.int32)
        else:
            cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
            cache["k_rope"][:, :s] = k_rope.to(cache["k_rope"].dtype)
            cache["kpos"][:s] = torch.arange(s, dtype=torch.int32,
                                             device=x.device)
        return y, cache

    def decode_step(self, params, x, cache, pos: int, *, lora=None,
                    mode: Optional[str] = None):
        """The absorbed decode: x (B, 1, d) at position ``pos`` (an int)
        scored against the latent cache directly, which is updated in
        place.  Rounding points as the JAX package writes them: q_c, each
        score product and their sum in the activation dtype before the
        fp32 scale; probabilities and ctx_c in the cache's dtype."""
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        q_nope, q_rope = self._q(params, x, positions, lora, mode)
        c_kv, k_rope = self._latent(params, x, positions)
        cc, cr, kpos = cache["c_kv"], cache["k_rope"], cache["kpos"]
        slot = pos % cc.shape[1]
        cc[:, slot] = c_kv[:, 0].to(cc.dtype)
        cr[:, slot] = k_rope[:, 0].to(cr.dtype)
        kpos[slot] = pos
        wk, wv = self._wkv_b_split(params)
        q_c = torch.einsum("bqhd,chd->bqhc", q_nope, wk)
        scores = (torch.einsum("bqhc,bsc->bhqs", q_c, cc)
                  + torch.einsum("bqhr,bsr->bhqs", q_rope, cr)).float() \
            * self.scale
        valid = (kpos >= 0) & (kpos <= pos)
        if self.window is not None:
            valid &= (pos - kpos) < self.window
        scores = torch.where(valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cc.dtype)
        ctx_c = torch.einsum("bhqs,bsc->bqhc", probs, cc)
        ctx = torch.einsum("bqhc,chd->bqhd", ctx_c, wv)
        return self._out(params, ctx, lora, mode), cache
