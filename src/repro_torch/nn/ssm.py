"""Recurrent sequence mixers: the mLSTM and sLSTM blocks of xLSTM and
hymba's Mamba branch (the JAX package's ``nn/ssm.py``).

* mLSTM runs chunkwise-parallel at prefill
  (:func:`repro_torch.kernels.mlstm_chunk.mlstm_chunkwise`: the CUDA
  kernel on the card, its plain version on the CPU or with
  ``mode="ref"``) and one stabilised recurrent step per decoded token.
* sLSTM has a true hidden-to-gate recurrence: a Python loop over time
  (where the JAX package runs a ``lax.scan``).
* Mamba is a diagonal selective state-space recurrence: a Python loop
  over time as well (the JAX package's ``lax.scan``; it has no Pallas
  kernel), whose terms that do not depend on the state are computed a
  block of steps at a time; decode is the same forward at S = 1.

The blocks update the cache they are given in place (PyTorch's idiom;
the JAX blocks return a new state): after ``forward(..., state=cache)``
the cache holds the state the JAX block returns.  Where the JAX package
rounds to the model dtype, so does the port: the mLSTM q·k scores, w
and w @ v (inside ``mlstm_chunkwise``), the sLSTM recurrent product, and
Mamba's projections, conv and gates (its recurrence is fp32).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels.mlstm_chunk import mlstm_chunkwise
from repro_torch.kernels.ref import logsigmoid as _logsigmoid
from repro_torch.nn.module import Dense, Module, RMSNorm, _normal


def _headwise_rmsnorm(x, scale, eps: float = 1e-6):
    """x (..., H, D) normalised per head (GroupNorm as in xLSTM)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def mlstm_recurrent_step(state, q, k, v, i_pre, f_pre):
    """One stabilised mLSTM step.  state: C (B, H, Dk, Dv), n (B, H, Dk),
    m (B, H); q, k (B, H, Dk), v (B, H, Dv); i_pre, f_pre (B, H)
    pre-activations.  Returns ((C, n, m), h (B, H, Dv) in v's dtype)."""
    C, n, m = state
    log_f = _logsigmoid(f_pre.float())
    i32 = i_pre.float()
    m_new = torch.maximum(log_f + m, i32)
    fp = torch.exp(log_f + m - m_new)
    ip = torch.exp(i32 - m_new)
    C = (fp[..., None, None] * C
         + ip[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = fp[..., None] * n + ip[..., None] * k
    qn = torch.einsum("bhd,bhd->bh", q, n)
    num = torch.einsum("bhd,bhdv->bhv", q, C)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))[..., None]
    return (C, n, m_new), (num / denom).to(v.dtype)


def _silu(x):
    """``jax.nn.silu`` op for op: x · (1 / (1 + exp(-x))), each op
    rounding to x's dtype (torch's ``silu`` rounds a bf16 result once)."""
    return x * (1 / (1 + torch.exp(-x)))


def _softplus(x):
    """``jax.nn.softplus`` op for op: max(x, 0) + log1p(exp(-|x|)), each
    op rounding to x's dtype (torch's ``softplus`` returns x itself above
    its threshold of 20; ``logaddexp`` rounds a bf16 result once)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv1d(x, w, *, state=None):
    """x (B, S, D), w (K, D) depthwise.  Returns (y, new_state
    (B, K-1, D))."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = _depthwise(xp, w)
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _depthwise(xp, w):
    """Unrolled depthwise causal conv: xp (B, S+K-1, D), w (K, D)."""
    k = w.shape[0]
    s_out = xp.shape[1] - (k - 1)
    y = torch.zeros((xp.shape[0], s_out, xp.shape[2]), dtype=xp.dtype,
                    device=xp.device)
    for j in range(k):
        y = y + xp[:, j:j + s_out] * w[j]
    return y


class MLSTMBlock(Module):
    """Pre-norm mLSTM block: up-proj (u, z gate) -> conv -> q, k, v ->
    cell -> headwise norm -> silu(z) gate -> down-proj; proj_factor 2."""

    def __init__(self, d_model: int, n_heads: int, *, proj_factor: int = 2,
                 qk_factor: int = 4, conv_kernel: int = 4, chunk: int = 256,
                 dtype=torch.float32):
        self.d_model, self.n_heads = d_model, n_heads
        self.d_inner = d_model * proj_factor
        self.qk_dim = self.d_inner // qk_factor
        self.dk = self.qk_dim // n_heads
        self.dv = self.d_inner // n_heads
        self.conv_kernel = conv_kernel
        self.chunk = chunk
        self.dtype = dtype
        self.norm = RMSNorm(d_model, dtype=dtype)
        self.up = Dense(d_model, 2 * self.d_inner, dtype=dtype)
        self.wq = Dense(self.d_inner, self.qk_dim, dtype=dtype)
        self.wk = Dense(self.d_inner, self.qk_dim, dtype=dtype)
        self.wif = Dense(self.d_inner, 2 * n_heads, dtype=dtype)
        self.down = Dense(self.d_inner, d_model, dtype=dtype,
                          scale=1.0 / math.sqrt(self.d_inner))

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        lead = tuple(lead)
        return {
            "norm": self.norm.init(None, device, lead),
            "up": self.up.init(generator, device, lead),
            "conv": {"w": _normal(generator,
                                  lead + (self.conv_kernel, self.d_inner),
                                  device, 0.1, self.dtype)},
            "wq": self.wq.init(generator, device, lead),
            "wk": self.wk.init(generator, device, lead),
            "wif": self.wif.init(generator, device, lead),
            "hnorm": {"scale": torch.ones(lead + (self.n_heads, self.dv),
                                          dtype=self.dtype, device=device)},
            "down": self.down.init(generator, device, lead),
        }

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"up": self.up.lora_init(generator, rank, device, lead),
                "down": self.down.lora_init(generator, rank, device, lead)}

    def init_cache(self, batch: int, max_len: int = 0, dtype=None,
                   device=None, lead: Sequence[int] = ()):
        dtype = dtype or self.dtype
        lead = tuple(lead)
        hk = lead + (batch, self.n_heads)
        return {
            "C": torch.zeros(hk + (self.dk, self.dv), device=device),
            "n": torch.zeros(hk + (self.dk,), device=device),
            "m": torch.full(hk, -1e30, device=device),
            "conv": torch.zeros(lead + (batch, self.conv_kernel - 1,
                                        self.d_inner),
                                dtype=dtype, device=device),
        }

    def _project(self, params, x, lora, conv_state, mode):
        lora = lora or {}
        b, s, _ = x.shape
        xn = self.norm(params["norm"], x)
        uz = self.up(params["up"], xn, lora.get("up"), mode=mode)
        u, z = torch.chunk(uz, 2, dim=-1)
        uc, conv_state = causal_conv1d(u, params["conv"]["w"],
                                       state=conv_state)
        uc = torch.nn.functional.silu(uc)
        q = self.wq(params["wq"], uc).reshape(b, s, self.n_heads, self.dk)
        k = self.wk(params["wk"], uc).reshape(b, s, self.n_heads, self.dk)
        v = uc.reshape(b, s, self.n_heads, self.dv)
        gates = self.wif(params["wif"], uc).reshape(b, s, self.n_heads, 2)
        q = q * (self.dk ** -0.5)
        k = k * (self.dk ** -0.5)
        return q, k, v, gates[..., 0], gates[..., 1], z, conv_state

    def _finish(self, params, h, z, lora, mode):
        lora = lora or {}
        b, s = h.shape[0], h.shape[2]
        h = _headwise_rmsnorm(h.transpose(1, 2), params["hnorm"]["scale"])
        h = h.reshape(b, s, self.d_inner) * torch.nn.functional.silu(z)
        return self.down(params["down"], h, lora.get("down"), mode=mode)

    def __call__(self, params, x, *, lora=None, mode: Optional[str] = None):
        return self.forward(params, x, lora=lora, mode=mode)[0]

    def forward(self, params, x, *, lora=None, state=None,
                mode: Optional[str] = None):
        """x (B, S, d) -> (x + y, state).  A given ``state`` (the cache)
        is read and then overwritten in place with the final state."""
        b = x.shape[0]
        st = state if state is not None else self.init_cache(
            b, dtype=x.dtype, device=x.device)
        q, k, v, i_pre, f_pre, z, conv_state = self._project(
            params, x, lora, st["conv"], mode)

        def heads(t):                       # (B, S, H, ...) -> (B, H, S, ...)
            return t.transpose(1, 2).contiguous()

        h, (C, n, m) = mlstm_chunkwise(
            heads(q), heads(k), heads(v), heads(i_pre.float()),
            heads(f_pre.float()), (st["C"], st["n"], st["m"]),
            chunk=self.chunk, C_out=None if state is None else st["C"],
            mode=mode)
        y = self._finish(params, h, z, lora, mode)
        return x + y.to(x.dtype), _carry(state, C=C, n=n, m=m,
                                         conv=conv_state)

    def decode_step(self, params, x, cache, pos=None, *, lora=None,
                    mode: Optional[str] = None):
        """x (B, 1, d) -> (x + y, cache); the cache is updated in place."""
        del pos
        q, k, v, i_pre, f_pre, z, conv_state = self._project(
            params, x, lora, cache["conv"], mode)
        (C, n, m), h = mlstm_recurrent_step(
            (cache["C"], cache["n"], cache["m"]), q[:, 0].float(),
            k[:, 0].float(), v[:, 0].float(), i_pre[:, 0], f_pre[:, 0])
        y = self._finish(params, h[:, :, None, :], z, lora, mode)
        _write(cache, C=C, n=n, m=m, conv=conv_state)
        return x + y.to(x.dtype), cache


def _write(cache, **new) -> None:
    """Copy each new state tensor into the cache leaf of its name."""
    for key, val in new.items():
        cache[key].copy_(val)


def _carry(state, **new):
    """A forward's final state: written in place into a given ``state``
    (the cache; a ``C`` already written there is skipped), else the new
    tensors themselves.  A forward given no state writes nothing in
    place, so autograd (reverse, forward and reverse over forward) runs
    through its initial state."""
    if state is None:
        return new
    _write(state, **{k: v for k, v in new.items() if v is not state.get(k)})
    return state


class SLSTMBlock(Module):
    """Scalar-memory LSTM with hidden-to-gate recurrence + GeGLU FFN."""

    def __init__(self, d_model: int, n_heads: int, *,
                 ffn_factor: float = 4 / 3, dtype=torch.float32):
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} does not split over "
                             f"{n_heads} heads")
        self.d_model, self.n_heads = d_model, n_heads
        self.dh = d_model // n_heads
        self.d_ffn = int(d_model * ffn_factor)
        self.dtype = dtype
        self.norm = RMSNorm(d_model, dtype=dtype)
        self.wx = Dense(d_model, 4 * d_model, dtype=dtype)
        self.norm2 = RMSNorm(d_model, dtype=dtype)
        self.ffn_up = Dense(d_model, 2 * self.d_ffn, dtype=dtype)
        self.ffn_down = Dense(self.d_ffn, d_model, dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        lead = tuple(lead)
        return {
            "norm": self.norm.init(None, device, lead),
            "wx": self.wx.init(generator, device, lead),
            # per-head recurrent weights R: (H, 4, dh, dh)
            "r": {"w": _normal(generator,
                               lead + (self.n_heads, 4, self.dh, self.dh),
                               device, 1.0 / math.sqrt(self.dh), self.dtype)},
            "hnorm": {"scale": torch.ones(lead + (self.n_heads, self.dh),
                                          dtype=self.dtype, device=device)},
            "norm2": self.norm2.init(None, device, lead),
            "ffn_up": self.ffn_up.init(generator, device, lead),
            "ffn_down": self.ffn_down.init(generator, device, lead),
        }

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"wx": self.wx.lora_init(generator, rank, device, lead),
                "ffn_down": self.ffn_down.lora_init(generator, rank, device,
                                                    lead)}

    def init_cache(self, batch: int, max_len: int = 0, dtype=None,
                   device=None, lead: Sequence[int] = ()):
        shape = tuple(lead) + (batch, self.n_heads, self.dh)
        return {"c": torch.zeros(shape, device=device),
                "n": torch.zeros(shape, device=device),
                "h": torch.zeros(shape, device=device),
                "m": torch.full(shape, -1e30, device=device)}

    def _step(self, r, carry, gx):
        """carry: (c, n, h, m), each (B, H, dh); gx (B, H, 4, dh) fp32
        input-gate pre-activations."""
        c, n, h, m = carry
        rec = torch.einsum("bhd,hgde->bhge", h.to(self.dtype), r)
        g = gx + rec.float()
        i_pre, f_pre, z_pre, o_pre = g.unbind(2)
        log_f = _logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        fp = torch.exp(log_f + m - m_new)
        ip = torch.exp(i_pre - m_new)
        c = fp * c + ip * torch.tanh(z_pre)
        n = fp * n + ip
        h_new = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        return c, n, h_new, m_new

    def _cell(self, params, x, lora, carry, mode):
        lora = lora or {}
        b, s, _ = x.shape
        xn = self.norm(params["norm"], x)
        gx = self.wx(params["wx"], xn, lora.get("wx"), mode=mode)
        gx = gx.reshape(b, s, 4, self.n_heads, self.dh).float()
        gx = gx.permute(1, 0, 3, 2, 4)           # (S, B, H, 4, dh)
        r = params["r"]["w"]
        hs = []
        for t in range(s):
            carry = self._step(r, carry, gx[t])
            hs.append(carry[2])
        hs = _headwise_rmsnorm(torch.stack(hs, dim=1),
                               params["hnorm"]["scale"])   # (B, S, H, dh)
        return hs.reshape(b, s, self.d_model).to(x.dtype), carry

    def _ffn(self, params, x, lora, mode):
        lora = lora or {}
        xn = self.norm2(params["norm2"], x)
        u, g = torch.chunk(self.ffn_up(params["ffn_up"], xn), 2, dim=-1)
        return self.ffn_down(params["ffn_down"],
                             u * torch.nn.functional.gelu(g, approximate="tanh"),
                             lora.get("ffn_down"), mode=mode)

    def __call__(self, params, x, *, lora=None, mode: Optional[str] = None):
        return self.forward(params, x, lora=lora, mode=mode)[0]

    def forward(self, params, x, *, lora=None, state=None,
                mode: Optional[str] = None):
        """x (B, S, d) -> (y, state); a given ``state`` is overwritten in
        place with the final carry."""
        st = state if state is not None else self.init_cache(
            x.shape[0], device=x.device)
        h, (c, n, hh, m) = self._cell(params, x, lora,
                                      (st["c"], st["n"], st["h"], st["m"]),
                                      mode)
        x = x + h
        return (x + self._ffn(params, x, lora, mode),
                _carry(state, c=c, n=n, h=hh, m=m))

    def decode_step(self, params, x, cache, pos=None, *, lora=None,
                    mode: Optional[str] = None):
        del pos
        return self.forward(params, x, lora=lora, state=cache, mode=mode)


# Mamba's scan computes exp(dt·a) and (dt·x)·B for this many steps at a
# time, outside its loop over time (per element the same ops as the
# step-by-step form, so the same bits)
MAMBA_SCAN_BLOCK = 64


class Mamba(Module):
    """Selective state-space branch (hymba's): in_proj -> (x, z); x ->
    causal conv -> silu -> x_proj -> (dt_low, B, C); dt = softplus(
    dt_proj(dt_low)); per step h = exp(dt·a)·h + (dt·x)·B and y = Σ_n
    h·C in fp32, a = -exp(a_log); then (y + x·d)·silu(z) -> out_proj.
    ``a_log`` and ``d`` are fp32 whatever the model dtype."""

    def __init__(self, d_model: int, *, d_state: int = 16,
                 dtype=torch.float32):
        self.d_model = d_model
        self.d_state = d_state
        self.d_inner = 2 * d_model     # expand 2, the JAX Mamba's default
        self.conv_kernel = 4
        self.dt_rank = max(16, d_model // 16)
        self.dtype = dtype
        self.in_proj = Dense(d_model, 2 * self.d_inner, dtype=dtype)
        self.x_proj = Dense(self.d_inner, self.dt_rank + 2 * d_state,
                            dtype=dtype)
        self.dt_proj = Dense(self.dt_rank, self.d_inner, bias=True,
                             dtype=dtype)
        self.out_proj = Dense(self.d_inner, d_model, dtype=dtype,
                              scale=1.0 / math.sqrt(self.d_inner))

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        lead = tuple(lead)
        a = torch.arange(1, self.d_state + 1, dtype=torch.float32,
                         device=device)
        return {
            "in_proj": self.in_proj.init(generator, device, lead),
            "conv": {"w": _normal(generator,
                                  lead + (self.conv_kernel, self.d_inner),
                                  device, 0.1, self.dtype)},
            "x_proj": self.x_proj.init(generator, device, lead),
            "dt_proj": self.dt_proj.init(generator, device, lead),
            "a_log": torch.log(a).expand(
                lead + (self.d_inner, self.d_state)).contiguous(),
            "d": torch.ones(lead + (self.d_inner,), dtype=torch.float32,
                            device=device),
            "out_proj": self.out_proj.init(generator, device, lead),
        }

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"in_proj": self.in_proj.lora_init(generator, rank, device,
                                                  lead),
                "out_proj": self.out_proj.lora_init(generator, rank, device,
                                                    lead)}

    def init_cache(self, batch: int, max_len: int = 0, dtype=None,
                   device=None, lead: Sequence[int] = ()):
        dtype = dtype or self.dtype
        lead = tuple(lead)
        return {"ssm": torch.zeros(lead + (batch, self.d_inner,
                                           self.d_state), device=device),
                "conv": torch.zeros(lead + (batch, self.conv_kernel - 1,
                                            self.d_inner),
                                    dtype=dtype, device=device)}

    def _inputs(self, params, x, lora, conv_state, mode):
        """In the model dtype: in_proj, the conv, silu, x_proj, dt_proj
        and softplus; dt, B and C then go to fp32."""
        lora = lora or {}
        xz = self.in_proj(params["in_proj"], x, lora.get("in_proj"),
                          mode=mode)
        xi, z = torch.chunk(xz, 2, dim=-1)
        xc, conv_state = causal_conv1d(xi, params["conv"]["w"],
                                       state=conv_state)
        xc = _silu(xc)
        proj = self.x_proj(params["x_proj"], xc)
        r, n = self.dt_rank, self.d_state
        dt = _softplus(self.dt_proj(params["dt_proj"], proj[..., :r]))
        return (xc, z, dt.float(), proj[..., r:r + n].float(),
                proj[..., r + n:].float(), conv_state)

    @staticmethod
    def _scan(a, xc, dt, bmat, cmat, h):
        """The fp32 recurrence over S steps from state h (B, Din, N):
        returns (final h, ys (B, S, Din) fp32).  exp(dt·a) and (dt·x)·B
        are computed for MAMBA_SCAN_BLOCK steps at a time, time-major so
        each step reads contiguous rows."""
        dt_t = dt.transpose(0, 1).contiguous()                  # (S, B, Din)
        dx_t = (dt * xc.float()).transpose(0, 1).contiguous()   # dt·x
        b_t = bmat.transpose(0, 1).contiguous()                 # (S, B, N)
        c_t = cmat.transpose(0, 1)[..., None].contiguous()      # (S, B, N, 1)
        ys = []
        for t0 in range(0, dt_t.shape[0], MAMBA_SCAN_BLOCK):
            t1 = min(t0 + MAMBA_SCAN_BLOCK, dt_t.shape[0])
            da = torch.exp(dt_t[t0:t1, ..., None] * a)          # (L, B, Din, N)
            dbx = dx_t[t0:t1, ..., None] * b_t[t0:t1, :, None, :]
            for da_i, dbx_i, c_i in zip(da, dbx, c_t[t0:t1]):
                h = da_i * h + dbx_i
                ys.append(torch.bmm(h, c_i))                     # (B, Din, 1)
        return h, torch.stack(ys, dim=1)[..., 0]

    def forward(self, params, x, *, lora=None, state=None,
                mode: Optional[str] = None):
        """x (B, S, d) -> (y, state); a given ``state`` (the cache) is
        read and then overwritten in place with the final ssm and conv
        states."""
        lora = lora or {}
        st = state if state is not None else self.init_cache(
            x.shape[0], dtype=x.dtype, device=x.device)
        xc, z, dt, bmat, cmat, conv_state = self._inputs(
            params, x, lora, st["conv"], mode)
        a = -torch.exp(params["a_log"])                         # (Din, N)
        h, ys = self._scan(a, xc, dt, bmat, cmat, st["ssm"])
        y = ys.to(x.dtype) + xc * params["d"].to(x.dtype)
        y = y * _silu(z)
        out = self.out_proj(params["out_proj"], y, lora.get("out_proj"),
                            mode=mode)
        return out, _carry(state, ssm=h, conv=conv_state)

    prefill = forward

    def __call__(self, params, x, *, lora=None, mode: Optional[str] = None):
        return self.forward(params, x, lora=lora, mode=mode)[0]

    def decode_step(self, params, x, cache, pos=None, *, lora=None,
                    mode: Optional[str] = None):
        """x (B, 1, d) -> (y, cache): the forward at S = 1 from the cache,
        updated in place."""
        del pos
        return self.forward(params, x, lora=lora, state=cache, mode=mode)
