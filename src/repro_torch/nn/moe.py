"""Mixture-of-Experts FFN (granite-3b-moe: 40 routed experts, top-8;
deepseek-v2: 2 shared + 160 routed, top-6), the JAX package's
``nn/moe.py::MoE``.

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
``ffn/shared/down``).

Under a mesh with a ``model`` axis (``nn.sharding.mesh_context``) the
call runs one of the JAX package's three sharded forms
(:meth:`MoE._sharded_moe`), as explicit code a rank, where JAX runs a
``shard_map``: each rank takes its local blocks of the DTensors, runs
its local MoE, and the result is wrapped back as a DTensor.

* expert-parallel, when the expert count divides ``model``: the tokens
  are replicated over ``model``, each rank runs its E / n_model experts
  on them (capacity per batch shard, by token chunks:
  :meth:`MoE._chunked_local_moe`), and one counted ``sharding.psum``
  over ``model`` combines the partial outputs;
* token-parallel, when it does not and S divides ``model``: the
  sequence is split over ``model`` and each rank runs every expert on
  its tokens, capacity per (batch, sequence) shard;
* replicated (decode steps, tiny S): each rank runs every expert on its
  batch shard.

The load-balance aux is the mean of every rank's (one counted psum over
the mesh).  Capacity is per shard, so with a batch split over ``data``
or with drops the sharded call is JAX's sharded call, not the unsharded
one.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import sharding
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

    def axes(self):
        """Expert-parallel (the expert count divides ``model``): experts
        over ``model`` and, at rest, their embed dim over ``data``
        (``expert_embed``; each call gathers a layer's blocks, ZeRO-3
        style).  Otherwise each expert's ffn dim over ``model``."""
        ep = self._expert_parallel()
        e_ax = "experts" if ep else None
        emb_ax = "expert_embed" if ep else "embed"
        f_ax = None if ep else "moe_mlp"
        a = {"router": {"w": ("embed", None)},
             "experts": {"gate": (e_ax, emb_ax, f_ax),
                         "up": (e_ax, emb_ax, f_ax),
                         "down": (e_ax, f_ax, emb_ax)}}
        if self.shared is not None:
            a["shared"] = self.shared.axes()
        return a

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        if self.shared is None:
            return {}
        return {"shared": self.shared.lora_init(generator, rank, device,
                                                lead)}

    def lora_axes(self):
        return ({"shared": self.shared.lora_axes()}
                if self.shared is not None else {})

    # -- mesh helpers ------------------------------------------------------
    def _mesh_info(self):
        """The active mesh when it has a ``model`` axis, else None."""
        mesh = sharding.current_mesh()
        if mesh is None or "model" not in sharding.mesh_axis_sizes(mesh):
            return None
        return mesh

    def _expert_parallel(self, mesh=None) -> bool:
        mesh = mesh or self._mesh_info()
        if mesh is None:
            return False
        return self.n_experts % sharding.mesh_axis_sizes(mesh)["model"] == 0

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

    def _local_moe(self, router_w, experts, xt, cap: int, e0: int = 0,
                   n_local: Optional[int] = None):
        """xt (T, d) -> (out (T, d), Switch load-balance aux), through the
        experts [e0, e0 + n_local) that ``experts`` holds (all of them by
        default); a choice of another expert adds nothing here.  Routing
        and the aux read all E experts, and an expert's capacity
        positions count its own rows only, so they are the same on every
        shard.

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
        n_local = e if n_local is None else n_local
        probs, gate_vals, gate_idx, pos, keep = self.route(router_w, xt, cap)
        if n_local != e:
            keep = keep & (gate_idx >= e0) & (gate_idx < e0 + n_local)
        dummy = n_local * cap
        slot = torch.where(keep, (gate_idx - e0) * cap + pos, dummy)  # (T, k)
        tok = torch.arange(t, device=xt.device).repeat_interleave(
            self.top_k)
        buf = xt.new_zeros((dummy + 1, d))
        buf.index_copy_(0, slot.reshape(-1), xt[tok])
        xe = buf[:dummy].view(n_local, cap, d)

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

    def _chunked_local_moe(self, router_w, experts, xt, e0: int,
                           n_local: int, token_chunk: int = 8192):
        """:meth:`_local_moe` over chunks of ``token_chunk`` tokens, each
        with the capacity of a chunk, so the dispatch buffers scale with
        the chunk; the aux is the chunks' mean.  T that is no longer
        than a chunk, or no whole number of chunks, runs as one call at
        the capacity of T.  Each chunk runs under
        ``torch.utils.checkpoint`` while gradients are recorded (the
        reference's ``jax.checkpoint``), which changes no number."""
        t, d = xt.shape
        if t <= token_chunk or t % token_chunk != 0:
            return self._local_moe(router_w, experts, xt, self.capacity(t),
                                   e0, n_local)
        cap = self.capacity(token_chunk)
        remat = torch.is_grad_enabled() and xt.requires_grad
        outs, auxs = [], []
        for c0 in range(0, t, token_chunk):
            args = (router_w, experts, xt[c0:c0 + token_chunk], cap, e0,
                    n_local)
            out, aux = (checkpoint(self._local_moe, *args, use_reentrant=False)
                        if remat else self._local_moe(*args))
            outs.append(out)
            auxs.append(aux)
        return torch.cat(outs), torch.stack(auxs).mean()

    def __call__(self, params, x, lora: Optional[Tree] = None, *,
                 mode: Optional[str] = None):
        """x (B, S, d) -> (B, S, d).  Without a mesh the capacity is that
        of all B·S tokens of the call, so an earlier batch row wins a
        full expert; under one, :meth:`_sharded_moe`.  Sets
        ``last_aux``.  ``mode`` reaches the shared expert's LoRA."""
        lora = lora or {}
        b, s, d = x.shape
        mesh = self._mesh_info()
        if mesh is None:
            out, aux = self._local_moe(params["router"]["w"],
                                       params["experts"], x.reshape(b * s, d),
                                       self.capacity(b * s))
            y = out.reshape(b, s, d)
        else:
            y, aux = self._sharded_moe(params, x, mesh)
        if self.shared is not None:
            y = y + self.shared(params["shared"], x, lora.get("shared"),
                                mode=mode)
        self.last_aux = aux
        return y

    def forms(self, b: int, s: int, mesh) -> dict:
        """The sharded form of a (B, S) call on ``mesh`` and what it reads:
        {"form": "expert_parallel" | "token_parallel" | "replicated",
        "batch_axes", "b_shard", "b_loc", "cap"} (``cap`` None for the
        expert-parallel form, whose capacity :meth:`_chunked_local_moe`
        sets)."""
        sizes = sharding.mesh_axis_sizes(mesh)
        n_model = sizes["model"]
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
        n_data = math.prod(sizes[a] for a in batch_axes)
        b_shard = n_data > 1 and b % n_data == 0
        b_loc = b // n_data if b_shard else b
        if self._expert_parallel(mesh):
            form, cap = "expert_parallel", None
        elif s % n_model == 0 and s > 1:
            form, cap = "token_parallel", self.capacity(b_loc * (s // n_model))
        else:
            form, cap = "replicated", self.capacity(b_loc * s)
        return {"form": form, "batch_axes": batch_axes, "b_shard": b_shard,
                "b_loc": b_loc, "cap": cap}

    def _sharded_moe(self, params, x, mesh):
        """x (B, S, d), a DTensor (a plain tensor is taken as replicated
        and the result returned plain) -> (y, aux) by the form of
        :meth:`forms`.  Gradients: each rank's local gradient of x is
        declared by where its work lies (partial over ``model`` in the
        expert-parallel form, whose ranks split the experts; sharded
        with the sequence in the token-parallel form; replicated in the
        replicated form), and the aux's backward scales by the ranks
        that hold a replicated copy of the same work."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        b, s, d = x.shape
        f = self.forms(b, s, mesh)
        names = list(mesh.mesh_dim_names)
        sizes = sharding.mesh_axis_sizes(mesh)
        plain = not isinstance(x, DTensor)
        x = sharding.replicated(x, mesh)
        ep = f["form"] == "expert_parallel"
        tp = f["form"] == "token_parallel"
        x_spec = (f["batch_axes"] if f["b_shard"] else None,
                  "model" if tp else None, None)
        x_pl = sharding.spec_placements(x_spec, mesh, 3)
        # the gradient of x each rank holds, and of a replicated input
        x_grad = tuple(Partial() if (n == "model" and ep) else p
                       for n, p in zip(names, x_pl))
        rep_grad = tuple(Replicate() if g == Replicate() else Partial()
                         for g in x_grad)
        rep = (Replicate(),) * len(names)

        xl = sharding.to_block(x, mesh, x_pl, x_grad)
        rw = sharding.to_block(params["router"]["w"], mesh, rep, rep_grad)
        if ep:
            m = names.index("model")
            e_pl = tuple(Shard(0) if i == m else Replicate()
                         for i in range(len(names)))
            e_grad = tuple(Shard(0) if i == m else g
                           for i, g in enumerate(rep_grad))
            experts = {k: sharding.to_block(v, mesh, e_pl, e_grad)
                       for k, v in params["experts"].items()}
            n_local = self.n_experts // sizes["model"]
            e0 = mesh.get_local_rank("model") * n_local
            out, aux = self._chunked_local_moe(rw, experts,
                                               xl.reshape(-1, d), e0, n_local)
            out = _ReplicatedSum.apply(out, mesh.get_group("model"), 1.0)
        else:
            experts = {k: sharding.to_block(v, mesh, rep, rep_grad)
                       for k, v in params["experts"].items()}
            out, aux = self._local_moe(rw, experts, xl.reshape(-1, d),
                                       f["cap"])
        n_all = math.prod(sizes.values())
        n_rep = math.prod(sizes[n] for n, g in zip(names, x_grad)
                          if g == Replicate())
        aux = _mesh_mean(aux, mesh, n_all, n_rep / n_all)
        y = sharding.from_block(out.reshape(xl.shape), mesh, x_pl, x.shape)
        aux = sharding.from_block(aux, mesh, rep, ())
        if plain:
            return y.full_tensor(), aux.full_tensor()
        return y, aux


class _ReplicatedSum(torch.autograd.Function):
    """The counted ``sharding.psum`` of x over ``group`` divided by
    ``div``, a value every rank of the group then holds whole; the
    backward passes the (replicated) gradient on times ``grad_scale``:
    each rank's x contributed once to a total that is counted once."""

    @staticmethod
    def forward(ctx, x, group, grad_scale: float, div: int = 1):
        ctx.grad_scale = grad_scale
        y = sharding.psum(x.detach().clone().contiguous(), group)
        return y / div if div != 1 else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.grad_scale if ctx.grad_scale != 1.0 else g,
                None, None, None)


def _mesh_mean(x, mesh, n_all: int, grad_scale: float):
    """The mean of every mesh rank's x (JAX's ``pmean`` over all axes):
    one counted psum over the default group when the mesh spans it,
    else one a mesh dim; the backward scales the gradient by
    ``grad_scale``."""
    import torch.distributed as dist
    if mesh.size() == dist.get_world_size():
        return _ReplicatedSum.apply(x, None, grad_scale, n_all)
    for i, name in enumerate(mesh.mesh_dim_names):
        last = i == len(mesh.mesh_dim_names) - 1
        x = _ReplicatedSum.apply(x, mesh.get_group(name),
                                 grad_scale if last else 1.0,
                                 n_all if last else 1)
    return x
