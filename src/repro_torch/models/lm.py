"""Decoder-only language model over stacked block units.

A "unit" is an ordered list of named blocks applied in turn; the model
stacks ``n_units`` copies of every parameter leaf along a leading layers
axis, as the JAX package does, and runs the layers as a Python loop
(where the JAX package runs one ``lax.scan``): each layer takes the
``[l]`` view of every parameter, LoRA and cache leaf.  A routed LoRA
leaf (L, B, ...) thus reaches layer l as its (B, ...) per-request form.

Entry points:

* ``forward(params, tokens, ...)``              full-sequence logits
* ``prefill(params, lora, batch, cache)``       fills the caches, last-token logits
* ``decode_step(params, lora, tokens, cache, pos)``  one token with the cache
* ``loss(params, lora, batch)``                 next-token CE (+ the MoE aux)

A vision-language model (``mrope=True``) prepends ``extra_embeds`` (B,
S_img, d_model) to the token embeddings in ``forward`` and ``prefill``,
and its default positions are (B, S, 3), three equal coordinates; its
decode steps take tokens alone.

``mode`` ("ref" or None) reaches every ``Dense`` and from there
``ops``, so a whole forward can run through the kernels' plain
versions.  With ``remat`` (the config's, as in the JAX package) a
forward that records gradients runs each layer under
``torch.utils.checkpoint``: only the layer inputs are kept, and the
backward recomputes the rest.  It changes no number.  ``loss`` runs the
attention by the reference's training rule, "auto" (query chunks once
S passes a chunk).

``axes`` / ``lora_axes`` / ``cache_axes`` are the JAX package's
logical-axes trees (each leaf with ``"layers"`` first), and under a mesh
(``nn.sharding.mesh_context``) the embeddings, each layer's input and
output, and the logits are pinned as the reference pins them.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_leaves
from repro_torch.nn.module import (Dense, Embedding, Module, RMSNorm,
                                   stack_axes)
from repro_torch.nn.sharding import constrain

Tree = Any
IGNORE_INDEX = -100


def needs_grad(*trees: Tree) -> bool:
    """Whether autograd records a function of ``trees``' tensors now."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees if tree is not None
        for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def remat_call(on: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``on``: the
    twin of the JAX package's ``jax.checkpoint``, a memory rule that
    changes no number."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean next-token CE in fp32; labels equal to ``ignore_index`` are
    masked."""
    nll, count = _chunk_nll(lambda z: z, logits, labels, ignore_index)
    return nll / torch.clamp(count, min=1.0)


def _chunk_nll(head_fn, xc, lc, ignore_index: int):
    """(sum of the masked NLL, count of scored labels) of one chunk.
    Under a mesh the chunk's logits are gathered over the vocab first:
    DTensor has no rule for a gather from vocab-sharded logits."""
    logits = constrain(head_fn(xc).float(), ("batch", None, None))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None])[..., 0]
    mask = (lc != ignore_index).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_cross_entropy(x: torch.Tensor, head_fn, labels: torch.Tensor, *,
                          chunk: int = 512,
                          ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Fused head + CE over sequence chunks, as the JAX package's.

    The (B, S, V) logits never exist whole: each chunk projects one (B,
    chunk, d) slice and reduces it to (NLL sum, count).  S is padded to
    a whole number of chunks with ignored labels.  While gradients of
    ``x`` are recorded, each chunk runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of the chunk body), so the backward
    too holds one chunk's logits at a time."""
    b, s, d = x.shape
    # under a mesh the padding and the chunks cut S, which stays whole
    x = constrain(x, ("batch", None, "embed"))
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad),
                                         value=ignore_index)
    remat = needs_grad(x)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        n, c = remat_call(remat, _chunk_nll, head_fn, x[:, sl], labels[:, sl],
                          ignore_index)
        nll_sum, count = nll_sum + n, count + c
    return nll_sum / torch.clamp(count, min=1.0)


def _ffn_aux(blk) -> Optional[torch.Tensor]:
    """The load-balance aux a block's MoE recorded in its last call
    (None for every other block)."""
    return getattr(getattr(blk, "ffn", None), "last_aux", None)


def layer_views(tree: Tree, n: int) -> List[Tree]:
    """n trees; tree l holds the ``[l]`` view of every leaf of ``tree``
    (one ``unbind`` per leaf; writes into a view land in the stack)."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        subs = {k: layer_views(v, n) for k, v in tree.items()}
        return [{k: subs[k][l] for k in tree} for l in range(n)]
    return list(tree.unbind(0))


def as_generator(seed_or_gen, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: the one given, or a new one
    seeded with the given int."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


class LM(Module):
    def __init__(self, *, vocab: int, d_model: int, n_units: int,
                 unit_blocks: List[Tuple[str, Module]],
                 tie_embeddings: bool = False, mrope: bool = False,
                 remat: bool = True, aux_loss_coef: float = 0.01,
                 dtype=torch.float32, device: DeviceLike = "cuda"):
        self.vocab, self.d_model, self.n_units = vocab, d_model, n_units
        self.unit_blocks = unit_blocks
        self.tie = tie_embeddings
        self.mrope = mrope
        self.remat = remat
        self.aux_loss_coef = aux_loss_coef
        self.dtype = dtype
        self.device = resolve_device(device)
        self.embed = Embedding(vocab, d_model, dtype=dtype)
        self.final_norm = RMSNorm(d_model, dtype=dtype)
        if not tie_embeddings:
            self.lm_head = Dense(d_model, vocab, axes=("embed", "vocab"),
                                 dtype=dtype)

    # -- params ------------------------------------------------------------
    def init(self, generator=0, *, device=None) -> Tree:
        """Random parameters on the model's device (``device="meta"``
        gives the shapes alone); ``generator`` is a ``torch.Generator``
        or an int seed."""
        dev = torch.device(device) if device is not None else self.device
        g = None if dev.type == "meta" else as_generator(generator, dev)
        p = {"embed": self.embed.init(g, dev)}
        p["units"] = {name: blk.init_stacked(g, self.n_units, dev)
                      for name, blk in self.unit_blocks}
        p["final_norm"] = self.final_norm.init(None, dev)
        if not self.tie:
            p["lm_head"] = self.lm_head.init(g, dev)
        return p

    def axes(self) -> Tree:
        a = {"embed": self.embed.axes(),
             "units": {name: blk.stacked_axes()
                       for name, blk in self.unit_blocks},
             "final_norm": self.final_norm.axes()}
        if not self.tie:
            a["lm_head"] = self.lm_head.axes()
        return a

    def lora_init(self, generator, rank: int, *, device=None) -> Tree:
        dev = torch.device(device) if device is not None else self.device
        g = None if dev.type == "meta" else as_generator(generator, dev)
        return {"units": {name: blk.lora_init(g, rank, dev, (self.n_units,))
                          for name, blk in self.unit_blocks}}

    def lora_axes(self) -> Tree:
        return {"units": {name: stack_axes(blk.lora_axes())
                          for name, blk in self.unit_blocks}}

    def cache_axes(self) -> Tree:
        return {name: stack_axes(blk.cache_axes())
                for name, blk in self.unit_blocks}

    # -- shared pieces -------------------------------------------------------
    def _embed_in(self, params, tokens, extra_embeds=None):
        """Token embeddings (B, S, d), with ``extra_embeds`` (B, S_img,
        d), cast to the model dtype, prepended."""
        x = self.embed(params["embed"], tokens).to(self.dtype)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(self.dtype), x], dim=1)
        return constrain(x, ("batch", None, "embed"))

    def _head(self, params, x):
        x = self.final_norm(params["final_norm"], x)
        if self.tie:
            logits = self.embed.attend(params["embed"], x)
        else:
            logits = self.lm_head(params["lm_head"], x)
        return constrain(logits, ("batch", None, "vocab"))

    def _default_positions(self, b: int, s: int, offset: int = 0):
        pos = torch.arange(offset, offset + s, device=self.device)
        pos = pos[None].expand(b, s)
        return torch.stack([pos, pos, pos], dim=-1) if self.mrope else pos

    def _layers(self, params, lora, cache=None):
        """Per layer, per unit block: (name, block, params, lora, cache)
        views."""
        units = lora["units"] if lora is not None else {}
        per = {name: (layer_views(params["units"][name], self.n_units),
                      layer_views(units.get(name), self.n_units),
                      layer_views(None if cache is None else cache[name],
                                  self.n_units))
               for name, _ in self.unit_blocks}
        for l in range(self.n_units):
            yield [(name, blk, per[name][0][l], per[name][1][l],
                    per[name][2][l]) for name, blk in self.unit_blocks]

    # -- full-sequence forward -----------------------------------------------
    @staticmethod
    def _unit_forward(unit, x, positions, mode, with_aux, impl):
        """One layer's blocks in turn -> (x, the layer's summed MoE aux,
        None without ``with_aux`` or an MoE)."""
        aux = None
        x = constrain(x, ("batch", "act_seq", "embed"))
        for _name, blk, p, l, _c in unit:
            x = blk(p, x, positions=positions, lora=l, mode=mode, impl=impl)
            a = _ffn_aux(blk) if with_aux else None
            if a is not None:
                aux = a if aux is None else aux + a
        return constrain(x, ("batch", "act_seq", "embed")), aux

    def forward(self, params, tokens, *, lora=None, positions=None,
                extra_embeds=None, mode: Optional[str] = None,
                return_hidden: bool = False, return_aux: bool = False,
                impl: str = "full"):
        """tokens (B, S_txt) -> logits (B, S, V) (or the final hidden
        state); S = S_img + S_txt with ``extra_embeds`` (B, S_img, d).
        With ``return_aux`` also the MoE load-balance aux summed over
        the layers (0 without an MoE), as the reference returns it.
        ``impl`` is the attention's rule (full, chunked or auto)."""
        x = self._embed_in(params, tokens, extra_embeds)
        b, s = x.shape[0], x.shape[1]
        if positions is None:
            positions = self._default_positions(b, s)
        remat = self.remat and needs_grad(x, lora, params)
        aux = (torch.zeros((), dtype=torch.float32, device=x.device)
               if return_aux else None)
        # the reference fences each layer's input with grad_safe_barrier,
        # an XLA scheduling fence that is the identity in value and
        # gradient; eager PyTorch has nothing to fence, so no twin here
        for unit in self._layers(params, lora):
            x, a = remat_call(remat, self._unit_forward, unit, x, positions,
                              mode, return_aux, impl)
            if a is not None:
                aux = aux + a
        out = x if return_hidden else self._head(params, x)
        return (out, aux) if return_aux else out

    def loss(self, params, lora, batch) -> torch.Tensor:
        """batch {"tokens" (B, S_txt), "labels" (B, S_txt)}, optionally
        "positions" and "extra_embeds" -> chunked next-token CE over the
        text tail (a vlm scores no image position) plus
        ``aux_loss_coef`` times the MoE aux."""
        hidden, aux = self.forward(
            params, batch["tokens"], lora=lora,
            positions=batch.get("positions"),
            extra_embeds=batch.get("extra_embeds"), return_hidden=True,
            return_aux=True, impl="auto")
        labels = batch["labels"]
        if hidden.shape[1] != labels.shape[1]:   # vlm: the text tail only
            hidden = hidden[:, -labels.shape[1]:]
        return (chunked_cross_entropy(hidden,
                                      lambda xc: self._head(params, xc),
                                      labels)
                + self.aux_loss_coef * aux)

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None) -> Tree:
        dtype = dtype or self.dtype
        return {name: blk.init_cache(batch, max_len, dtype, self.device,
                                     (self.n_units,))
                for name, blk in self.unit_blocks}

    def prefill(self, params, lora, batch, cache, *,
                mode: Optional[str] = None):
        """batch {"tokens": (B, S_txt)}, optionally "extra_embeds" (B,
        S_img, d) and "positions" (B, S) or (B, S, 3), S = S_img + S_txt
        -> (last-token logits (B, V), cache); the cache is filled in
        place."""
        x = self._embed_in(params, batch["tokens"], batch.get("extra_embeds"))
        b, s = x.shape[0], x.shape[1]
        positions = batch.get("positions")
        if positions is None:
            positions = self._default_positions(b, s)
        for unit in self._layers(params, lora, cache):
            for _name, blk, p, l, c in unit:
                x, _ = blk.prefill(p, x, c, positions=positions, lora=l,
                                   mode=mode)
        return self._head(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, lora, tokens, cache, pos: int, *,
                    mode: Optional[str] = None):
        """tokens (B, 1) at position ``pos`` -> (logits (B, V), cache);
        the cache is updated in place."""
        x = self._embed_in(params, tokens)
        for unit in self._layers(params, lora, cache):
            for _name, blk, p, l, c in unit:
                x, _ = blk.decode_step(p, x, c, pos, lora=l, mode=mode)
        return self._head(params, x)[:, 0], cache
