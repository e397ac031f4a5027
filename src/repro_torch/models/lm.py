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

A vision-language model (``mrope=True``) prepends ``extra_embeds`` (B,
S_img, d_model) to the token embeddings in ``forward`` and ``prefill``,
and its default positions are (B, S, 3), three equal coordinates; its
decode steps take tokens alone.

``mode`` ("ref" or None) reaches every ``Dense`` and from there
``ops``, so a whole forward can run through the kernels' plain
versions.  Loss and training (chunked cross-entropy) are not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.nn.module import Dense, Embedding, Module, RMSNorm

Tree = Any


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
                 dtype=torch.float32, device: DeviceLike = "cuda"):
        self.vocab, self.d_model, self.n_units = vocab, d_model, n_units
        self.unit_blocks = unit_blocks
        self.tie = tie_embeddings
        self.mrope = mrope
        self.dtype = dtype
        self.device = resolve_device(device)
        self.embed = Embedding(vocab, d_model, dtype=dtype)
        self.final_norm = RMSNorm(d_model, dtype=dtype)
        if not tie_embeddings:
            self.lm_head = Dense(d_model, vocab, dtype=dtype)

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

    def lora_init(self, generator, rank: int, *, device=None) -> Tree:
        dev = torch.device(device) if device is not None else self.device
        g = None if dev.type == "meta" else as_generator(generator, dev)
        return {"units": {name: blk.lora_init(g, rank, dev, (self.n_units,))
                          for name, blk in self.unit_blocks}}

    # -- shared pieces -------------------------------------------------------
    def _embed_in(self, params, tokens, extra_embeds=None):
        """Token embeddings (B, S, d), with ``extra_embeds`` (B, S_img,
        d), cast to the model dtype, prepended."""
        x = self.embed(params["embed"], tokens).to(self.dtype)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(self.dtype), x], dim=1)
        return x

    def _head(self, params, x):
        x = self.final_norm(params["final_norm"], x)
        if self.tie:
            return self.embed.attend(params["embed"], x)
        return self.lm_head(params["lm_head"], x)

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
    def forward(self, params, tokens, *, lora=None, positions=None,
                extra_embeds=None, mode: Optional[str] = None,
                return_hidden: bool = False):
        """tokens (B, S_txt) -> logits (B, S, V) (or the final hidden
        state); S = S_img + S_txt with ``extra_embeds`` (B, S_img, d)."""
        x = self._embed_in(params, tokens, extra_embeds)
        b, s = x.shape[0], x.shape[1]
        if positions is None:
            positions = self._default_positions(b, s)
        for unit in self._layers(params, lora):
            for _name, blk, p, l, _c in unit:
                x = blk(p, x, positions=positions, lora=l, mode=mode)
        return x if return_hidden else self._head(params, x)

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
