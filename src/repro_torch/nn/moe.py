"""Mixture-of-Experts FFN (granite-3b-moe: 40 routed experts, top-8),
the JAX package's ``nn/moe.py::MoE`` on its mesh-free path.

Experts are stacked on a leading E axis (after any layer axes); a call
routes every token of the whole (B, S) batch to its top-k experts,
fills each expert's capacity buffer of ``capacity(B·S)`` rows in
token-major order (a row past the capacity is dropped and adds
nothing), runs the experts as three batched products and combines the
k choices weighted by the renormalised gate values.  The expert
products are plain ``torch.bmm``: the JAX package computes them as
``jnp.einsum`` outside any Pallas kernel.

Routed experts are frozen under PEFT; LoRA attaches to the shared
expert's ``down`` only (none in granite; deepseek-v2-236b's two shared
experts of d_ff 1,536 are one SwiGLU of width 3,072, its LoRA site
``ffn/shared/down``).  The sharded forms (``_sharded_moe``,
``_chunked_local_moe``) and ``axes`` come with distribution.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.nn.mlp import SwiGLU
from repro_torch.nn.module import Module, _normal, _promoted

Tree = Any


def _round8(x: int) -> int:
    return max(8, ((x + 7) // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, the lower
    index first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties): a stable descending
    sort, cut to k.  Unlike ``lax.top_k`` it ranks -0.0 level with +0.0,
    which no softmax probability is."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(Module):
    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 *, n_shared: int = 0, shared_d_ff: Optional[int] = None,
                 capacity_factor: float = 1.25, dtype=torch.float32):
        self.d_model, self.d_ff = d_model, d_ff
        self.n_experts, self.top_k = n_experts, top_k
        self.n_shared = n_shared
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.shared = (SwiGLU(d_model, (shared_d_ff or d_ff) * n_shared,
                              dtype=dtype) if n_shared else None)
        self.last_aux: Optional[torch.Tensor] = None

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        """Router (d, E); experts gate / up (E, d, f) and down (E, f, d),
        each after ``lead``; the shared SwiGLU if any."""
        lead = tuple(lead)
        e, d, f = self.n_experts, self.d_model, self.d_ff

        def w(shape, fan_in):
            return _normal(generator, lead + shape, device,
                           1.0 / math.sqrt(fan_in), self.dtype)

        p = {"router": {"w": w((d, e), d)},
             "experts": {"gate": w((e, d, f), d), "up": w((e, d, f), d),
                         "down": w((e, f, d), f)}}
        if self.shared is not None:
            p["shared"] = self.shared.init(generator, device, lead)
        return p

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        if self.shared is None:
            return {}
        return {"shared": self.shared.lora_init(generator, rank, device,
                                                lead)}

    def capacity(self, n_tokens: int) -> int:
        return _round8(int(self.capacity_factor * n_tokens * self.top_k
                           / self.n_experts))

    def route(self, router_w, xt, cap: int):
        """The routing of tokens xt (T, d): (probs (T, E) fp32, gate
        values (T, k) in xt's dtype, expert ids (T, k), capacity
        positions (T, k), kept (T, k)).  A (token, choice)'s position
        counts the earlier rows of its expert in token-major order, as
        the JAX package's one-hot cumsum does; here the one-hot is laid
        out (E, T·k) so the running count is a scan along contiguous
        rows (on the card, a scan down the T·k axis of a (T·k, E) array
        runs E threads' worth of work a step: 1.5 ms a granite layer)."""
        logits = torch.matmul(*_promoted(xt, router_w)).float()
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = top_k(probs, self.top_k)
        gate_vals = (gate_vals / gate_vals.sum(-1, keepdim=True)).to(
            xt.dtype)
        flat_e = gate_idx.reshape(-1)
        onehot = torch.nn.functional.one_hot(flat_e, self.n_experts)
        count = onehot.t().contiguous().cumsum(1)                # (E, T·k)
        pos = count.gather(0, flat_e[None])[0] - 1
        pos = pos.view_as(gate_idx)
        return probs, gate_vals, gate_idx, pos, pos < cap

    def _local_moe(self, router_w, experts, xt, cap: int):
        """xt (T, d) -> (out (T, d), Switch load-balance aux).

        Dispatch: every kept (token, choice) owns one (expert, position)
        row of the capacity buffer, so the JAX package's scatter-add onto
        zeros is one assignment (``index_copy_``, no atomics).  The one
        difference is the sign of a zero: JAX's ``0 + (-0.0)`` is +0.0,
        the copy keeps -0.0, which changes no product with a nonzero
        term.  Dropped rows all write one dummy row past the buffer,
        which no product reads, so which of them lands there is moot.
        Combine: the k choices are added one by one in xt's dtype, each
        ``rows · (gate_j · keep_j)``, as JAX rounds them."""
        t, d = xt.shape
        e = self.n_experts
        probs, gate_vals, gate_idx, pos, keep = self.route(router_w, xt, cap)
        dummy = e * cap
        slot = torch.where(keep, gate_idx * cap + pos, dummy)   # (T, k)
        tok = torch.arange(t, device=xt.device).repeat_interleave(
            self.top_k)
        buf = xt.new_zeros((dummy + 1, d))
        buf.index_copy_(0, slot.reshape(-1), xt[tok])
        xe = buf[:dummy].view(e, cap, d)

        h = torch.nn.functional.silu(torch.bmm(*_promoted(xe,
                                                           experts["gate"])))
        h = h * torch.bmm(*_promoted(xe, experts["up"]))
        eout = torch.bmm(*_promoted(h, experts["down"])).reshape(dummy, d)
        eout = torch.cat([eout, eout.new_zeros((1, d))])

        w = gate_vals * keep.to(xt.dtype)
        out = xt.new_zeros((t, d))
        for j in range(self.top_k):
            out = out + eout[slot[:, j]] * w[:, j, None]

        me = torch.nn.functional.one_hot(gate_idx[:, 0], e).float().mean(0)
        aux = e * torch.sum(me * probs.mean(0))
        return out, aux

    def __call__(self, params, x, lora: Optional[Tree] = None, *,
                 mode: Optional[str] = None):
        """x (B, S, d) -> (B, S, d); the capacity is that of all B·S
        tokens of the call, so an earlier batch row wins a full expert.
        Sets ``last_aux``.  ``mode`` reaches the shared expert's LoRA."""
        lora = lora or {}
        b, s, d = x.shape
        out, aux = self._local_moe(params["router"]["w"], params["experts"],
                                   x.reshape(b * s, d), self.capacity(b * s))
        y = out.reshape(b, s, d)
        if self.shared is not None:
            y = y + self.shared(params["shared"], x, lora.get("shared"),
                                mode=mode)
        self.last_aux = aux
        return y
