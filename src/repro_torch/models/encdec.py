"""Encoder-decoder LM (whisper-large-v3 backbone), the JAX package's
``models/encdec.py``.

The mel-spectrogram and conv front end is a stub in both packages: the
encoder takes precomputed frame embeddings (B, T_enc, d).  The
transformer encoder runs over them, and the decoder (self-attention,
cross-attention to the encoder output, GELU MLP) generates with two
caches: its own keys and values, and the encoder output's, projected
once at prefill.

Layers run as Python loops over the ``[l]`` views of the stacked
parameter, LoRA and cache leaves (``lm.layer_views``), where the JAX
package scans; the cache is preallocated and filled in place.  Cache:
``{"self": {k, v (n_dec, B, S, KV, D), kpos (n_dec, S)}, "cross": {k, v
(n_dec, B, enc_frames, KV, D)}}``.  ``mode`` ("ref" or None) reaches
every Dense that carries LoRA.  ``loss`` is the chunked next-token CE
through ``dec_ln`` and the tied head; with ``remat`` (the config's) a
forward that records gradients runs each encoder and decoder layer under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models.lm import (as_generator, chunked_cross_entropy,
                                   layer_views, needs_grad, remat_call)
from repro_torch.nn.attention import Attention
from repro_torch.nn.mlp import GeluMLP
from repro_torch.nn.module import (Embedding, LayerNorm, Module, _normal,
                                   stack_axes)
from repro_torch.nn.sharding import constrain

Tree = Any


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """(length, dim) fp32: sin at even columns, cos at odd ones, computed
    in fp32 as the reference computes it."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class EncoderBlock(Module):
    """x + attn(ln1(x)) (bidirectional, biased), then x + mlp(ln2(x))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, *,
                 dtype=torch.float32):
        self.attn = Attention(d_model, n_heads, n_heads, qkv_bias=True,
                              out_bias=True, rope=False, causal=False,
                              dtype=dtype)
        self.mlp = GeluMLP(d_model, d_ff, dtype=dtype)
        self.ln1 = LayerNorm(d_model, dtype=dtype)
        self.ln2 = LayerNorm(d_model, dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"ln1": self.ln1.init(None, device, lead),
                "attn": self.attn.init(generator, device, lead),
                "ln2": self.ln2.init(None, device, lead),
                "mlp": self.mlp.init(generator, device, lead)}

    def axes(self):
        return {"ln1": self.ln1.axes(), "attn": self.attn.axes(),
                "ln2": self.ln2.axes(), "mlp": self.mlp.axes()}

    def lora_axes(self):
        return {"attn": self.attn.lora_axes(), "mlp": self.mlp.lora_axes()}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"attn": self.attn.lora_init(generator, rank, device, lead),
                "mlp": self.mlp.lora_init(generator, rank, device, lead)}

    def __call__(self, params, x, *, lora=None, mode: Optional[str] = None):
        lora = lora or {}
        x = x + self.attn(params["attn"], self.ln1(params["ln1"], x),
                          lora=lora.get("attn"), impl="auto", mode=mode)
        return x + self.mlp(params["mlp"], self.ln2(params["ln2"], x),
                            lora.get("mlp"), mode=mode)


class DecoderBlock(Module):
    """x + self_attn(ln1(x)) (causal), x + cross_attn(ln2(x), enc_out),
    then x + mlp(ln3(x))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, *,
                 dtype=torch.float32):
        self.self_attn = Attention(d_model, n_heads, n_heads, qkv_bias=True,
                                   out_bias=True, rope=False, causal=True,
                                   dtype=dtype)
        self.cross_attn = Attention(d_model, n_heads, n_heads, qkv_bias=True,
                                    out_bias=True, rope=False, causal=False,
                                    cross=True, dtype=dtype)
        self.mlp = GeluMLP(d_model, d_ff, dtype=dtype)
        self.ln1 = LayerNorm(d_model, dtype=dtype)
        self.ln2 = LayerNorm(d_model, dtype=dtype)
        self.ln3 = LayerNorm(d_model, dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"ln1": self.ln1.init(None, device, lead),
                "self_attn": self.self_attn.init(generator, device, lead),
                "ln2": self.ln2.init(None, device, lead),
                "cross_attn": self.cross_attn.init(generator, device, lead),
                "ln3": self.ln3.init(None, device, lead),
                "mlp": self.mlp.init(generator, device, lead)}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"self_attn": self.self_attn.lora_init(generator, rank,
                                                      device, lead),
                "cross_attn": self.cross_attn.lora_init(generator, rank,
                                                        device, lead),
                "mlp": self.mlp.lora_init(generator, rank, device, lead)}

    def axes(self):
        return {"ln1": self.ln1.axes(), "self_attn": self.self_attn.axes(),
                "ln2": self.ln2.axes(), "cross_attn": self.cross_attn.axes(),
                "ln3": self.ln3.axes(), "mlp": self.mlp.axes()}

    def lora_axes(self):
        return {"self_attn": self.self_attn.lora_axes(),
                "cross_attn": self.cross_attn.lora_axes(),
                "mlp": self.mlp.lora_axes()}

    def cache_axes(self):
        kv = ("batch", None, "kv_heads", "head_dim")
        return {"self": self.self_attn.cache_axes(),
                "cross": {"k": kv, "v": kv}}

    def _mlp_res(self, params, x, lora, mode):
        return x + self.mlp(params["mlp"], self.ln3(params["ln3"], x),
                            lora.get("mlp"), mode=mode)

    def __call__(self, params, x, enc_out, *, lora=None,
                 mode: Optional[str] = None):
        lora = lora or {}
        x = x + self.self_attn(params["self_attn"],
                               self.ln1(params["ln1"], x),
                               lora=lora.get("self_attn"), impl="auto",
                               mode=mode)
        x = x + self.cross_attn(params["cross_attn"],
                                self.ln2(params["ln2"], x), kv_input=enc_out,
                                lora=lora.get("cross_attn"), mode=mode)
        return self._mlp_res(params, x, lora, mode)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   lead: Sequence[int] = ()):
        return {"self": self.self_attn.init_cache(batch, max_len, dtype,
                                                  device, lead)}

    def build_cross_cache(self, params, enc_out, cross):
        """The encoder output's keys and values written into ``cross``
        ({"k", "v"} (B, S_enc, KV, D)) in place; returns it."""
        kv = self.cross_attn.init_cross_cache(params["cross_attn"], enc_out)
        for name in ("k", "v"):
            cross[name].copy_(kv[name])
        return cross

    def prefill(self, params, x, enc_out, cache, *, lora=None,
                mode: Optional[str] = None):
        """Fills ``cache["self"]`` and ``cache["cross"]`` in place.  The
        reference runs cross-attention on ``enc_out`` and then projects
        the same ``enc_out`` into the cross cache; here it is projected
        once and the queries attend to the cache (equal keys and values
        in the cache's dtype, the model's by default)."""
        lora = lora or {}
        h, _ = self.self_attn.prefill(params["self_attn"],
                                      self.ln1(params["ln1"], x),
                                      cache["self"],
                                      lora=lora.get("self_attn"), mode=mode)
        x = x + h
        cross = self.build_cross_cache(params, enc_out, cache["cross"])
        x = x + self.cross_attn.cross_decode_step(
            params["cross_attn"], self.ln2(params["ln2"], x), cross,
            lora=lora.get("cross_attn"), mode=mode)
        return self._mlp_res(params, x, lora, mode), cache

    def decode_step(self, params, x, cache, pos: int, *, lora=None,
                    mode: Optional[str] = None):
        lora = lora or {}
        h, _ = self.self_attn.decode_step(params["self_attn"],
                                          self.ln1(params["ln1"], x),
                                          cache["self"], pos,
                                          lora=lora.get("self_attn"),
                                          mode=mode)
        x = x + h
        x = x + self.cross_attn.cross_decode_step(
            params["cross_attn"], self.ln2(params["ln2"], x), cache["cross"],
            lora=lora.get("cross_attn"), mode=mode)
        return self._mlp_res(params, x, lora, mode), cache


class EncDecLM(Module):
    """Whisper-style encoder-decoder over stacked layers; tied readout."""

    def __init__(self, *, vocab: int, d_model: int, n_enc_layers: int,
                 n_dec_layers: int, n_heads: int, d_ff: int,
                 max_dec_len: int = 448, enc_frames: int = 1500,
                 remat: bool = True, dtype=torch.float32,
                 device: DeviceLike = "cuda"):
        self.vocab, self.d_model = vocab, d_model
        self.n_enc, self.n_dec = n_enc_layers, n_dec_layers
        self.max_dec_len, self.enc_frames = max_dec_len, enc_frames
        self.remat = remat
        self.dtype = dtype
        self.device = resolve_device(device)
        self.enc_block = EncoderBlock(d_model, n_heads, d_ff, dtype=dtype)
        self.dec_block = DecoderBlock(d_model, n_heads, d_ff, dtype=dtype)
        self.embed = Embedding(vocab, d_model, dtype=dtype)
        self.enc_ln = LayerNorm(d_model, dtype=dtype)
        self.dec_ln = LayerNorm(d_model, dtype=dtype)

    # -- params ------------------------------------------------------------
    def init(self, generator=0, *, device=None) -> Tree:
        """Random parameters on the model's device (``device="meta"``
        gives the shapes alone)."""
        dev = torch.device(device) if device is not None else self.device
        g = None if dev.type == "meta" else as_generator(generator, dev)
        return {
            "encoder": self.enc_block.init(g, dev, (self.n_enc,)),
            "decoder": self.dec_block.init(g, dev, (self.n_dec,)),
            "embed": self.embed.init(g, dev),
            "pos_embed": {"table": _normal(g, (self.max_dec_len,
                                               self.d_model), dev, 0.01,
                                           self.dtype)},
            "enc_ln": self.enc_ln.init(None, dev),
            "dec_ln": self.dec_ln.init(None, dev),
        }

    def lora_init(self, generator, rank: int, *, device=None) -> Tree:
        dev = torch.device(device) if device is not None else self.device
        g = None if dev.type == "meta" else as_generator(generator, dev)
        return {"encoder": self.enc_block.lora_init(g, rank, dev,
                                                    (self.n_enc,)),
                "decoder": self.dec_block.lora_init(g, rank, dev,
                                                    (self.n_dec,))}

    def axes(self) -> Tree:
        return {"encoder": self.enc_block.stacked_axes(),
                "decoder": self.dec_block.stacked_axes(),
                "embed": self.embed.axes(),
                "pos_embed": {"table": (None, "embed")},
                "enc_ln": self.enc_ln.axes(), "dec_ln": self.dec_ln.axes()}

    def lora_axes(self) -> Tree:
        return {"encoder": stack_axes(self.enc_block.lora_axes()),
                "decoder": stack_axes(self.dec_block.lora_axes())}

    def cache_axes(self) -> Tree:
        return stack_axes(self.dec_block.cache_axes())

    def _stack(self, params, lora, name: str, n: int):
        return zip(layer_views(params[name], n),
                   layer_views(None if lora is None else lora[name], n))

    # -- encoder -------------------------------------------------------------
    def encode(self, params, audio_embeds, *, lora=None,
               mode: Optional[str] = None):
        """(B, T_enc, d) frame embeddings -> encoder output (B, T_enc, d).
        The embeddings are cast to the model's dtype before the cast
        sinusoids are added, as in the reference."""
        x = audio_embeds.to(self.dtype)
        x = x + sinusoidal_positions(x.shape[1], self.d_model,
                                     x.device).to(self.dtype)[None]
        x = constrain(x, ("batch", None, "embed"))
        remat = self.remat and needs_grad(x, lora, params)
        for p, l in self._stack(params, lora, "encoder", self.n_enc):
            x = remat_call(remat, self._enc_layer, p, x, l, mode)
        return self.enc_ln(params["enc_ln"], x)

    def _enc_layer(self, p, x, l, mode):
        return self.enc_block(p, x, lora=l, mode=mode)

    def _dec_layer(self, p, x, enc_out, l, mode):
        return self.dec_block(p, x, enc_out, lora=l, mode=mode)

    def _dec_embed(self, params, tokens, offset: int = 0):
        """Token embeddings plus learned positions ``offset .. offset+S-1``.
        The window's start is clamped to [0, max_dec_len - S], as
        ``lax.dynamic_slice_in_dim`` clamps it in the reference: a token
        past the table reads its last row."""
        s = tokens.shape[1]
        if s > self.max_dec_len:
            raise ValueError(f"{s} decoder tokens exceed max_dec_len "
                             f"{self.max_dec_len}")
        x = self.embed(params["embed"], tokens).to(self.dtype)
        start = min(max(int(offset), 0), self.max_dec_len - s)
        return constrain(x + params["pos_embed"]["table"][start:start + s][None],
                         ("batch", None, "embed"))

    def _head(self, params, x):
        return constrain(self.embed.attend(params["embed"],
                                           self.dec_ln(params["dec_ln"], x)),
                         ("batch", None, "vocab"))

    # -- full sequence -------------------------------------------------------
    def forward(self, params, tokens, audio_embeds, *, lora=None,
                mode: Optional[str] = None, return_hidden: bool = False):
        """tokens (B, S), audio_embeds (B, T_enc, d) -> logits (B, S, V),
        or with ``return_hidden`` the decoder stack's output before
        ``dec_ln`` (B, S, d), as the reference returns it."""
        enc_out = self.encode(params, audio_embeds, lora=lora, mode=mode)
        x = self._dec_embed(params, tokens)
        remat = self.remat and needs_grad(x, enc_out, lora, params)
        # the reference fences each decoder layer's input with
        # grad_safe_barrier, an XLA scheduling fence that is the identity
        # in value and gradient; eager PyTorch has no twin
        for p, l in self._stack(params, lora, "decoder", self.n_dec):
            x = remat_call(remat, self._dec_layer, p, x, enc_out, l, mode)
        return x if return_hidden else self._head(params, x)

    def loss(self, params, lora, batch) -> torch.Tensor:
        """batch {"tokens", "labels" (B, S), "audio_embeds" (B, T_enc,
        d)} -> chunked next-token CE through ``dec_ln`` and the tied
        head."""
        hidden = self.forward(params, batch["tokens"], batch["audio_embeds"],
                              lora=lora, return_hidden=True)
        return chunked_cross_entropy(hidden,
                                     lambda xc: self._head(params, xc),
                                     batch["labels"])

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None) -> Tree:
        dtype = dtype or self.dtype
        attn = self.dec_block.cross_attn
        shape = (self.n_dec, batch, self.enc_frames, attn.n_kv,
                 attn.head_dim)
        cache = self.dec_block.init_cache(batch, max_len, dtype, self.device,
                                          (self.n_dec,))
        cache["cross"] = {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        return cache

    def _layers(self, params, lora, cache):
        views = layer_views(cache, self.n_dec)
        return ((p, l, c) for (p, l), c in
                zip(self._stack(params, lora, "decoder", self.n_dec), views))

    def prefill(self, params, lora, batch, cache, *,
                mode: Optional[str] = None):
        """batch {"tokens": (B, S), "audio_embeds": (B, T_enc, d)} ->
        (last-token logits (B, V), cache): encodes, then fills both
        caches of every decoder layer in place."""
        enc_out = self.encode(params, batch["audio_embeds"], lora=lora,
                              mode=mode)
        x = self._dec_embed(params, batch["tokens"])
        for p, l, c in self._layers(params, lora, cache):
            x, _ = self.dec_block.prefill(p, x, enc_out, c, lora=l,
                                          mode=mode)
        return self._head(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, lora, tokens, cache, pos: int, *,
                    mode: Optional[str] = None):
        """tokens (B, 1) at position ``pos`` -> (logits (B, V), cache);
        the self-attention cache is updated in place."""
        x = self._dec_embed(params, tokens, offset=pos)
        for p, l, c in self._layers(params, lora, cache):
            x, _ = self.dec_block.decode_step(p, x, c, pos, lora=l,
                                              mode=mode)
        return self._head(params, x)[:, 0], cache
