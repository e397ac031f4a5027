"""Per-request task routing: one decode batch, many tasks.

``route_batch`` turns a per-request task-id list into the *routed*
LoRA tree the model consumes, in one of two forms (``Dense`` tells them
apart):

dense-routed (``fused=False``)
    Each request's adapter (``store.adapter``, LRU-cached ``lora0 +
    unflatten(λ·m⊙τ)``) is stacked along a new per-request axis at
    position 1: leaves go (L, ...) -> (L, B, ...), so layer l sees
    per-request (B, in, r) factors.

fused (``fused=True``)
    No adapter is materialised.  Every Dense LoRA site carries
    ``{"base", "tau", "words"}`` per factor — the shared base leaf in
    fp32, the unified vector's slice of that leaf, and each request's
    packed mask bits of the leaf, re-aligned per layer out of the
    whole-d row with ``bitpack.slice_bits`` — plus per-request ``lam``
    and the densely rebuilt per-request ``alpha``.  The weight
    ``base + (λ·m)·τ`` is built inside the ``ops.modulated_matmul``
    kernel.  A site whose per-layer factor size is not word-aligned
    (% 32 != 0) takes dense-routed leaves for that site only.

In fp32 the fused kernel's weight is bitwise the dense-routed adapter
leaf: the kernel rounds the product and the add one at a time, where
XLA fuses them into an fma (the JAX package's one-rounding caveat).  At
bf16 the adapter rounds to bf16 while the fused route keeps fp32
weights, so the two may differ by bf16 roundings.

``MultiTenantDecoder`` is the serving front end: it routes a batch and
runs :func:`repro_torch.serve.generate.generate` over it.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.kernels import bitpack
from repro_torch.serve.generate import GenerationConfig, generate
from repro_torch.serve.store import ModulatorStore

Tree = Any


def _is_site(node) -> bool:
    return (isinstance(node, dict) and "a" in node and "b" in node
            and not isinstance(node["a"], dict))


def _stack_requests(adapters: Sequence[Tree]) -> Tree:
    """Stack per-request adapter trees along a new axis 1, after the
    layers axis."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=1), *adapters)


def _layer_words(rows: torch.Tensor, offset: int, per_layer: int,
                 n_layers: int) -> torch.Tensor:
    """(B, W) whole-d packed rows -> (L, B, ceil(per_layer/32)) mask
    words of one manifest leaf, re-aligned per layer (layer l owns bits
    ``[offset + l·per_layer, offset + (l+1)·per_layer)``)."""
    return torch.stack([bitpack.slice_bits(rows, offset + l * per_layer,
                                           per_layer)
                        for l in range(n_layers)], dim=0)


def _site_dense_routed(site0, tau_site, rows, lam, space, prefix):
    """Dense-routed leaves of one site: each request's ``leaf0 + λ·m⊙τ``
    rebuilt densely and laid out (L, B, ...)."""
    out = {}
    for key, leaf0 in site0.items():
        spec = space.by_path(f"{prefix}/{key}")
        bits = bitpack.unpack_bits(
            bitpack.slice_bits(rows, spec.offset, spec.size), spec.size,
            torch.float32).reshape((rows.shape[0],) + spec.shape)
        lam_b = lam.reshape((-1,) + (1,) * len(spec.shape))
        val = leaf0.float()[None] + lam_b * bits * tau_site[key][None]
        out[key] = val.movedim(0, 1)
    return out


def route_batch(store: ModulatorStore, task_ids: Sequence[int], *,
                fused: bool = False) -> Tree:
    """Routed LoRA tree for one batch of per-request task ids (see the
    module docstring for the two forms)."""
    ids = [int(t) for t in task_ids]
    if not ids:
        raise ValueError("route_batch needs at least one request")
    if not fused:
        return _stack_requests([store.adapter(t) for t in ids])

    space = store.space
    tau_tree = store.tau_tree()
    rows = torch.stack([store.mask_words(t) for t in ids])    # (B, W)
    lam = torch.stack([store.lam(t) for t in ids])            # (B,)

    def build(node0, tau_node, prefix=""):
        if _is_site(node0):
            return build_site(node0, tau_node, prefix)
        return {k: build(node0[k], tau_node[k],
                         f"{prefix}/{k}" if prefix else str(k))
                for k in node0}

    def build_site(site0, tau_site, prefix):
        a_spec = space.by_path(f"{prefix}/a")
        b_spec = space.by_path(f"{prefix}/b")
        n_layers = a_spec.shape[0]
        a_sz = a_spec.size // n_layers
        b_sz = b_spec.size // n_layers
        if a_sz % bitpack.WORD_BITS or b_sz % bitpack.WORD_BITS:
            return _site_dense_routed(site0, tau_site, rows, lam, space,
                                      prefix)
        site = {
            "a": {"base": site0["a"].float(), "tau": tau_site["a"],
                  "words": _layer_words(rows, a_spec.offset, a_sz,
                                        n_layers)},
            "b": {"base": site0["b"].float(), "tau": tau_site["b"],
                  "words": _layer_words(rows, b_spec.offset, b_sz,
                                        n_layers)},
            "lam": lam[None, :].expand(n_layers, len(ids)).contiguous(),
        }
        if "alpha" in site0:
            al_spec = space.by_path(f"{prefix}/alpha")
            bits = bitpack.unpack_bits(
                bitpack.slice_bits(rows, al_spec.offset, al_spec.size),
                al_spec.size, torch.float32)                  # (B, L)
            alpha_eff = (site0["alpha"].float()[None, :]
                         + lam[:, None] * bits * tau_site["alpha"][None, :])
            site["alpha"] = alpha_eff.t().contiguous()        # (L, B)
        return site

    return build(store.lora0, tau_tree)


class MultiTenantDecoder:
    """Batched multi-tenant decode front end over one backbone: routes
    each batch's task ids (:func:`route_batch`) and generates through
    the routed tree.  ``mode="ref"`` runs every kernel's plain version.

    The JAX package compiles one decode program per (batch, prompt)
    shape and exposes ``compile_count()``; eager PyTorch compiles
    nothing, so there is no such count here (its later counterpart is a
    CUDA graph captured per shape).  Task ids are data either way.
    """

    def __init__(self, model, params, store: ModulatorStore, *,
                 fused: bool = False,
                 cfg: GenerationConfig = GenerationConfig(),
                 mode: Optional[str] = None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.store = store
        self.fused = fused
        self.cfg = cfg
        self.mode = mode

    def route(self, task_ids: Sequence[int]) -> Tree:
        return route_batch(self.store, task_ids, fused=self.fused)

    def generate(self, prompts: torch.Tensor, task_ids: Sequence[int], *,
                 rng: Optional[torch.Generator] = None,
                 max_len: Optional[int] = None) -> torch.Tensor:
        """prompts (B, S) + per-request task ids (len B) ->
        (B, S + max_new_tokens) int32."""
        b = int(prompts.shape[0])
        if len(task_ids) != b:
            raise ValueError(f"{len(task_ids)} task ids for batch {b}")
        lora = self.route(task_ids)
        return generate(self.model, self.params, lora,
                        prompts.to(self.device), self.cfg, rng=rng,
                        max_len=max_len, mode=self.mode)
