"""Grouped-query attention with RoPE (or Qwen2-VL's M-RoPE), sliding
windows, a KV cache and cross-attention (whisper's decoder).

Three execution paths, as in the JAX package:

* ``__call__``     full-sequence; ``impl`` picks materialised scores
                   ("full") or a loop over query chunks of ``q_chunk``
                   rows ("chunked"; "auto": full only when the queries
                   fit one chunk), which bounds the scores' memory;
* ``prefill``      full-sequence, and writes the KV cache;
* ``decode_step``  one token against the cache; a ring buffer when a
                   sliding window is configured.

Cross-attention (``cross=True``: no rope, not causal) takes its keys and
values from ``kv_input``; at serving time ``init_cross_cache`` projects
them once and ``cross_decode_step`` attends the decoder's queries to
them.

The cache is preallocated ((B, S_cache, KV, D) keys and values plus
``kpos``, the position held in each slot, -1 when empty) and updated in
place: PyTorch's idiom, where the JAX package returns a new cache.
Softmax math is fp32 whatever the activation dtype, with a -1e30 mask.
Heads are grouped as ``h = kv · group + g``, so query head h reads KV
head h // group.

Under a mesh (``nn.sharding.mesh_context``) q is pinned to its heads
over ``model`` and the output to the sequence-parallel residual; when
the head count does not divide ``model`` the chunked path shards each
query chunk's rows over ``model`` instead (:meth:`_seq_parallel`), as
the JAX package does.

Positions are (B, S), or (B, S, 3) (t, h, w) coordinates when
``mrope_sections`` is set.  They rotate q and k; the causal and window
masks read ``positions[0]`` only when positions are (B, S), and 0..S-1
otherwise, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.nn.module import Dense, Module
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.sharding import (constrain, current_mesh, from_block,
                                     mesh_axis_sizes, split_last, to_block)

Tree = Any
NEG_INF = -1e30


def _split_heads(x, n_heads, head_dim):
    return split_last(x, n_heads)


def sharded_sdpa(core, q, k, v, mask):
    """``core(q, k, v, mask)`` on each rank's blocks, for a DTensor q (B,
    Q, H, D) against k / v (B, S, KV, ·), the split GSPMD gives attention
    made explicit (DTensor would fold a split heads dim into the batch of
    its products, which it cannot do while another dim is split):

    * batch over every mesh dim but ``model`` that divides B;
    * on ``model``: the query heads when it divides H, with the KV heads
      when it divides KV too (else each rank takes the KV heads its query
      heads read, from whole K / V); else the query rows when it divides
      Q (the mask's rows with them; K / V whole); else whole.

    Each block's gradient is declared where it lies: partial over
    ``model`` for a K / V a rank reads whole but only in part.  Returns
    the DTensor (B, Q, H, ·) placed as its query blocks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    if isinstance(mask, DTensor):
        mask = mask.full_tensor()
    b, qlen, h = q.shape[0], q.shape[1], q.shape[2]
    kvh = k.shape[2]
    pl_q, pl_kv, grad_kv = [], [], []
    head_split = row_split = kv_split = False
    n_model = 1
    for name, n in zip(mesh.mesh_dim_names, (int(x) for x in mesh.shape)):
        if n == 1:
            pl_q.append(Replicate()), pl_kv.append(Replicate())
            grad_kv.append(Replicate())
        elif name == "model":
            n_model = n
            if h % n == 0:
                head_split, kv_split = True, kvh % n == 0
                pl_q.append(Shard(2))
                pl_kv.append(Shard(2) if kv_split else Replicate())
                grad_kv.append(Shard(2) if kv_split else Partial())
            elif qlen % n == 0:
                row_split = True
                pl_q.append(Shard(1)), pl_kv.append(Replicate())
                grad_kv.append(Partial())
            else:
                pl_q.append(Replicate()), pl_kv.append(Replicate())
                grad_kv.append(Replicate())
        else:
            pl = Shard(0) if b % n == 0 else Replicate()
            pl_q.append(pl), pl_kv.append(pl), grad_kv.append(pl)
    ql = to_block(q, mesh, pl_q)
    kl = to_block(k, mesh, pl_kv, grad_kv)
    vl = to_block(v, mesh, pl_kv, grad_kv)
    m = mesh.get_local_rank("model") if n_model > 1 else 0
    if head_split and not kv_split:
        hl = h // n_model
        idx = torch.arange(m * hl, (m + 1) * hl, device=ql.device) // (h // kvh)
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    if row_split and mask is not None:
        rows = qlen // n_model
        mask = mask[m * rows:(m + 1) * rows]
    out = core(ql, kl, vl, mask).contiguous()
    return from_block(out, mesh, pl_q, (b, qlen, h, out.shape[-1]))


class Attention(Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, *,
                 head_dim: Optional[int] = None, qkv_bias: bool = False,
                 out_bias: bool = False, rope: bool = True,
                 rope_base: float = 10000.0,
                 mrope_sections: Optional[Sequence[int]] = None,
                 window: Optional[int] = None,
                 causal: bool = True, cross: bool = False,
                 q_chunk: int = 512, dtype=torch.float32):
        if n_heads % n_kv_heads:
            raise ValueError(f"{n_heads} heads do not group over "
                             f"{n_kv_heads} KV heads")
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_kv = n_kv_heads
        self.head_dim = head_dim or d_model // n_heads
        self.group = n_heads // n_kv_heads
        self.rope = rope and not cross
        self.rope_base = rope_base
        self.mrope_sections = (tuple(mrope_sections)
                               if mrope_sections is not None else None)
        self.window = window
        self.causal = causal and not cross
        self.q_chunk = q_chunk
        self.dtype = dtype
        hd = self.head_dim
        self.wq = Dense(d_model, n_heads * hd, bias=qkv_bias,
                        axes=("embed", "heads"), dtype=dtype)
        self.wk = Dense(d_model, n_kv_heads * hd, bias=qkv_bias,
                        axes=("embed", "kv_heads"), dtype=dtype)
        self.wv = Dense(d_model, n_kv_heads * hd, bias=qkv_bias,
                        axes=("embed", "kv_heads"), dtype=dtype)
        self.wo = Dense(n_heads * hd, d_model, bias=out_bias,
                        axes=("heads", "embed"), dtype=dtype,
                        scale=1.0 / math.sqrt(n_heads * hd))

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"wq": self.wq.init(generator, device, lead),
                "wk": self.wk.init(generator, device, lead),
                "wv": self.wv.init(generator, device, lead),
                "wo": self.wo.init(generator, device, lead)}

    def axes(self):
        return {"wq": self.wq.axes(), "wk": self.wk.axes(),
                "wv": self.wv.axes(), "wo": self.wo.axes()}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"wq": self.wq.lora_init(generator, rank, device, lead),
                "wo": self.wo.lora_init(generator, rank, device, lead)}

    def lora_axes(self):
        return {"wq": self.wq.lora_axes(), "wo": self.wo.lora_axes()}

    def cache_axes(self):
        return {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
                "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
                "kpos": ("cache_seq",)}

    # -- projections -----------------------------------------------------
    def _q(self, params, x, lora, mode):
        lora = lora or {}
        return _split_heads(self.wq(params["wq"], x, lora.get("wq"),
                                    mode=mode), self.n_heads, self.head_dim)

    def _kv(self, params, kv_input):
        return (_split_heads(self.wk(params["wk"], kv_input), self.n_kv,
                             self.head_dim),
                _split_heads(self.wv(params["wv"], kv_input), self.n_kv,
                             self.head_dim))

    def _qkv(self, params, x, positions, lora, mode, kv_input=None):
        q = constrain(self._q(params, x, lora, mode),
                      ("batch", None, "heads", None))
        k, v = self._kv(params, x if kv_input is None else kv_input)
        if self.rope and positions is not None:
            q = apply_rope(q, positions, base=self.rope_base,
                           mrope_sections=self.mrope_sections)
            k = apply_rope(k, positions, base=self.rope_base,
                           mrope_sections=self.mrope_sections)
        return q, k, v

    def _out(self, params, ctx, lora, mode):
        lora = lora or {}
        b, s = ctx.shape[0], ctx.shape[1]
        y = self.wo(params["wo"],
                    ctx.reshape(b, s, self.n_heads * self.head_dim),
                    lora.get("wo"), mode=mode)
        return constrain(y, ("batch", "act_seq", "embed"))

    def _mask(self, q_pos, k_pos):
        """q_pos (Q,), k_pos (K,) -> bool (Q, K); True = attend."""
        ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                        device=q_pos.device)
        if self.causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if self.window is not None:
            ok &= (q_pos[:, None] - k_pos[None, :]) < self.window
        return ok

    def _sdpa(self, q, k, v, mask):
        """q (B, Q, H, D), k/v (B, S, KV, D), mask (Q, S) bool or None.
        Scores in the activation dtype, then fp32 scaling, mask and
        softmax; probabilities back in v's dtype.  A DTensor q runs
        :func:`sharded_sdpa`."""
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor):
            return sharded_sdpa(self._sdpa_block, q, k, v, mask)
        return self._sdpa_block(q, k, v, mask)

    def _sdpa_block(self, q, k, v, mask):
        """The attention core on plain tensors; head counts from the
        shapes (a rank's block holds some of the heads)."""
        b, qlen, h, hd = q.shape
        n_kv = k.shape[2]
        qg = q.reshape(b, qlen, n_kv, h // n_kv, hd)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
        scores = scores * (1.0 / math.sqrt(self.head_dim))
        if mask is not None:
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
        return ctx.reshape(b, qlen, h, hd)

    # -- full sequence -----------------------------------------------------
    def _attend(self, q, k, v, positions, cross: bool, impl: str):
        """The context of q against k/v by ``impl``'s rule: materialised
        scores when impl is "full" or the queries fit one chunk, else
        :meth:`_chunked`.  Query positions are ``positions[0]`` for (B,
        S) positions and 0..S-1 otherwise (none, or M-RoPE's (B, S, 3));
        key positions equal them for self-attention and are 0..S_kv-1
        for cross-attention."""
        if impl not in ("full", "chunked", "auto"):
            raise ValueError(f"impl must be full, chunked or auto, got "
                             f"{impl!r}")
        q_chunk = self.q_chunk
        s_q, s_k = q.shape[1], k.shape[1]
        q_pos = (positions[0] if positions is not None
                 and positions.dim() == 2
                 else torch.arange(s_q, device=q.device))
        k_pos = torch.arange(s_k, device=q.device) if cross else q_pos
        if impl == "full" or s_q <= q_chunk:
            mask = (self._mask(q_pos, k_pos)
                    if (self.causal or self.window) else None)
            return self._sdpa(q, k, v, mask)
        return self._chunked(q, k, v, q_pos, k_pos, q_chunk)

    def _seq_parallel(self) -> bool:
        """Whether the chunked path shards each query chunk's rows over
        ``model``: under a mesh whose ``model`` axis the head count does
        not divide (heads replicated there would multiply the score
        blocks)."""
        mesh = current_mesh()
        if mesh is None:
            return False
        n_model = mesh_axis_sizes(mesh).get("model")
        return n_model is not None and self.n_heads % n_model != 0

    def _chunked(self, q, k, v, q_pos, k_pos, q_chunk: int):
        """The JAX package's scan over query chunks as a loop: scores
        (B, KV, G, q_chunk, S_kv) a chunk.  The reference pads the last
        chunk with masked rows and slices them away; here the last chunk
        is just shorter, and the rows kept are the same.  Under a mesh
        each chunk keeps its heads over ``model``, or its rows under
        :meth:`_seq_parallel`, as the reference pins its chunk stack."""
        seq_par = self._seq_parallel()
        qc_axes = (("batch", "act_seq", None, None) if seq_par
                   else ("batch", None, "heads", None))
        out = []
        for c0 in range(0, q.shape[1], q_chunk):
            qp = q_pos[c0:c0 + q_chunk]
            mask = (self._mask(qp, k_pos)
                    if (self.causal or self.window) else None)
            qc = constrain(q[:, c0:c0 + q_chunk], qc_axes)
            o = self._sdpa(qc, k, v, mask)
            out.append(constrain(o, ("batch", "act_seq", None, None))
                       if seq_par else o)
        return torch.cat(out, dim=1)

    def __call__(self, params, x, *, positions=None, lora=None,
                 kv_input=None, impl: str = "full",
                 mode: Optional[str] = None):
        """x (B, S, d) -> (B, S, d); cross-attention reads its keys and
        values from ``kv_input`` (B, S_kv, d)."""
        q, k, v = self._qkv(params, x, positions, lora, mode, kv_input)
        ctx = self._attend(q, k, v, positions, kv_input is not None, impl)
        return self._out(params, ctx, lora, mode)

    # -- serving -----------------------------------------------------------
    def cache_len(self, max_len: int) -> int:
        return min(max_len, self.window) if self.window is not None \
            else max_len

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   lead: Sequence[int] = ()):
        dtype = dtype or self.dtype
        s = self.cache_len(max_len)
        shape = tuple(lead) + (batch, s, self.n_kv, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "kpos": torch.full(tuple(lead) + (s,), -1, dtype=torch.int32,
                                   device=device)}

    def prefill(self, params, x, cache, *, positions=None, lora=None,
                mode: Optional[str] = None):
        """Full-sequence attention by the "chunked" rule, and the cache
        filled in place (the trailing window, slot = pos % window, when
        the prompt is longer than the cache).  q, k and v are computed
        once."""
        q, k, v = self._qkv(params, x, positions, lora, mode)
        y = self._out(params, self._attend(q, k, v, positions, False,
                                           "chunked"), lora, mode)
        s_cache = cache["k"].shape[1]
        s = k.shape[1]
        if s >= s_cache:
            start = s - s_cache
            kpos = torch.arange(start, s, device=x.device)
            slots = kpos % s_cache
            cache["k"][:, slots] = k[:, start:].to(cache["k"].dtype)
            cache["v"][:, slots] = v[:, start:].to(cache["v"].dtype)
            cache["kpos"][slots] = kpos.to(torch.int32)
        else:
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
            cache["kpos"][:s] = torch.arange(s, dtype=torch.int32,
                                             device=x.device)
        return y, cache

    def decode_step(self, params, x, cache, pos: int, *, lora=None,
                    mode: Optional[str] = None):
        """x (B, 1, d); ``pos`` the position of this token (an int), on
        all three M-RoPE coordinates when ``mrope_sections`` is set.  The
        cache is updated in place."""
        b = x.shape[0]
        shape = (b, 1) if self.mrope_sections is None else (b, 1, 3)
        positions = torch.full(shape, pos, dtype=torch.int64,
                               device=x.device)
        q, k, v = self._qkv(params, x, positions, lora, mode)
        s_cache = cache["k"].shape[1]
        slot = pos % s_cache
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["kpos"][slot] = pos
        kpos = cache["kpos"]
        valid = (kpos >= 0) & (kpos <= pos)
        if self.window is not None:
            valid &= (pos - kpos) < self.window
        ctx = self._sdpa(q, cache["k"], cache["v"], valid[None, :])
        return self._out(params, ctx, lora, mode), cache

    # -- cross-attention serving (whisper) ----------------------------------
    def init_cross_cache(self, params, enc_out):
        """Keys and values of the encoder output, projected once and read
        by every decode step: {"k", "v"} (B, S_enc, KV, D).  ``wk`` and
        ``wv`` carry no LoRA."""
        k, v = self._kv(params, enc_out)
        return {"k": k, "v": v}

    def cross_decode_step(self, params, x, cross_cache, *, lora=None,
                          mode: Optional[str] = None):
        """x (B, S, d) against the cross cache, unmasked: one token at a
        decode step, the prompt at the decoder's prefill."""
        q = self._q(params, x, lora, mode)
        ctx = self._sdpa(q, cross_cache["k"], cross_cache["v"], None)
        return self._out(params, ctx, lora, mode)
