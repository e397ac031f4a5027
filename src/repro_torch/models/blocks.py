"""Blocks with a uniform full-sequence / prefill / decode API (the JAX
package's ``models/blocks.py``): the pre-norm residual transformer
``Block``; ``SSMBlockAdapter``, which fits the xLSTM blocks (their own
norms and residuals) to the same API; and ``HybridMixer``, hymba's
parallel attention and Mamba branches, a ``Block``'s mixer."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.nn.module import Module, RMSNorm

Tree = Any


class Block(Module):
    """x + mixer(norm1(x)), then x + ffn(norm2(x))."""

    def __init__(self, d_model: int, mixer: Module, ffn: Optional[Module], *,
                 dtype=torch.float32):
        self.d_model, self.mixer, self.ffn = d_model, mixer, ffn
        self.norm1 = RMSNorm(d_model, dtype=dtype)
        self.norm2 = RMSNorm(d_model, dtype=dtype) if ffn is not None else None
        self.dtype = dtype

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        p = {"norm1": self.norm1.init(None, device, lead),
             "mixer": self.mixer.init(generator, device, lead)}
        if self.ffn is not None:
            p["norm2"] = self.norm2.init(None, device, lead)
            p["ffn"] = self.ffn.init(generator, device, lead)
        return p

    def axes(self):
        a = {"norm1": self.norm1.axes(), "mixer": self.mixer.axes()}
        if self.ffn is not None:
            a["norm2"] = self.norm2.axes()
            a["ffn"] = self.ffn.axes()
        return a

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        out = {"mixer": self.mixer.lora_init(generator, rank, device, lead)}
        if self.ffn is not None and hasattr(self.ffn, "lora_init"):
            ffn = self.ffn.lora_init(generator, rank, device, lead)
            if ffn:     # an MoE without a shared expert adapts no FFN leaf
                out["ffn"] = ffn
        return out

    def lora_axes(self):
        out = {"mixer": self.mixer.lora_axes()}
        if self.ffn is not None and hasattr(self.ffn, "lora_axes"):
            ffn = self.ffn.lora_axes()
            if ffn:
                out["ffn"] = ffn
        return out

    def cache_axes(self):
        return self.mixer.cache_axes()

    def _ffn_apply(self, params, x, lora, mode):
        y = self.ffn(params["ffn"], self.norm2(params["norm2"], x),
                     lora.get("ffn"), mode=mode)
        return x + y

    def __call__(self, params, x, *, positions=None, lora=None, mode=None,
                 impl: str = "full"):
        lora = lora or {}
        x = x + self.mixer(params["mixer"], self.norm1(params["norm1"], x),
                           positions=positions, lora=lora.get("mixer"),
                           mode=mode, impl=impl)
        return x if self.ffn is None else self._ffn_apply(params, x, lora,
                                                          mode)

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   lead: Sequence[int] = ()):
        return self.mixer.init_cache(batch, max_len, dtype, device, lead)

    def prefill(self, params, x, cache, *, positions=None, lora=None,
                mode=None):
        lora = lora or {}
        h, cache = self.mixer.prefill(params["mixer"],
                                      self.norm1(params["norm1"], x), cache,
                                      positions=positions,
                                      lora=lora.get("mixer"), mode=mode)
        x = x + h
        if self.ffn is not None:
            x = self._ffn_apply(params, x, lora, mode)
        return x, cache

    def decode_step(self, params, x, cache, pos: int, *, lora=None,
                    mode=None):
        lora = lora or {}
        h, cache = self.mixer.decode_step(params["mixer"],
                                          self.norm1(params["norm1"], x),
                                          cache, pos, lora=lora.get("mixer"),
                                          mode=mode)
        x = x + h
        if self.ffn is not None:
            x = self._ffn_apply(params, x, lora, mode)
        return x, cache


class SSMBlockAdapter(Module):
    """Adapts ``MLSTMBlock`` / ``SLSTMBlock`` (own residual and norms) to
    the ``Block`` API; prefill and decode update the cache in place."""

    def __init__(self, inner: Module):
        self.inner = inner

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return self.inner.init(generator, device, lead)

    def axes(self):
        return self.inner.axes()

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return self.inner.lora_init(generator, rank, device, lead)

    def lora_axes(self):
        return self.inner.lora_axes()

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   lead: Sequence[int] = ()):
        return self.inner.init_cache(batch, max_len, dtype, device, lead)

    def cache_axes(self):
        return self.inner.cache_axes()

    def __call__(self, params, x, *, positions=None, lora=None, mode=None,
                 impl: str = "full"):
        del positions, impl
        return self.inner(params, x, lora=lora, mode=mode)

    def prefill(self, params, x, cache, *, positions=None, lora=None,
                mode=None):
        del positions
        return self.inner.forward(params, x, lora=lora, state=cache,
                                  mode=mode)

    def decode_step(self, params, x, cache, pos: int, *, lora=None,
                    mode=None):
        return self.inner.decode_step(params, x, cache, pos, lora=lora,
                                      mode=mode)


class HybridMixer(Module):
    """Hymba-style parallel attention ‖ Mamba heads on the same input:
    each branch's output RMS-normalised, scaled by its β and the two
    averaged (arXiv:2411.13676 §2).  Its cache is {"attn", "mamba"}."""

    def __init__(self, d_model: int, attn: Module, mamba: Module, *,
                 dtype=torch.float32):
        self.d_model, self.attn, self.mamba, self.dtype = (d_model, attn,
                                                           mamba, dtype)
        self.norm_a = RMSNorm(d_model, dtype=dtype)
        self.norm_m = RMSNorm(d_model, dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"attn": self.attn.init(generator, device, lead),
                "mamba": self.mamba.init(generator, device, lead),
                "norm_a": self.norm_a.init(None, device, lead),
                "norm_m": self.norm_m.init(None, device, lead),
                "beta": torch.ones(tuple(lead) + (2,), dtype=self.dtype,
                                   device=device)}

    def axes(self):
        return {"attn": self.attn.axes(), "mamba": self.mamba.axes(),
                "norm_a": self.norm_a.axes(), "norm_m": self.norm_m.axes(),
                "beta": (None,)}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"attn": self.attn.lora_init(generator, rank, device, lead),
                "mamba": self.mamba.lora_init(generator, rank, device, lead)}

    def lora_axes(self):
        return {"attn": self.attn.lora_axes(), "mamba": self.mamba.lora_axes()}

    def cache_axes(self):
        return {"attn": self.attn.cache_axes(),
                "mamba": self.mamba.cache_axes()}

    def _fuse(self, params, ya, ym):
        """0.5·(β0·norm_a(ya) + β1·norm_m(ym)), in the model dtype."""
        ya = self.norm_a(params["norm_a"], ya)
        ym = self.norm_m(params["norm_m"], ym)
        beta = params["beta"]
        return 0.5 * (beta[0] * ya + beta[1] * ym)

    def __call__(self, params, x, *, positions=None, lora=None, mode=None,
                 impl: str = "full"):
        lora = lora or {}
        ya = self.attn(params["attn"], x, positions=positions,
                       lora=lora.get("attn"), mode=mode, impl=impl)
        ym = self.mamba(params["mamba"], x, lora=lora.get("mamba"),
                        mode=mode)
        return self._fuse(params, ya, ym)

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   lead: Sequence[int] = ()):
        return {"attn": self.attn.init_cache(batch, max_len, dtype, device,
                                             lead),
                "mamba": self.mamba.init_cache(batch, max_len, dtype, device,
                                               lead)}

    def prefill(self, params, x, cache, *, positions=None, lora=None,
                mode=None):
        """Attention by the "chunked" rule filling its cache, the Mamba
        branch continuing from the cache's state; both in place."""
        lora = lora or {}
        ya, ca = self.attn.prefill(params["attn"], x, cache["attn"],
                                   positions=positions,
                                   lora=lora.get("attn"), mode=mode)
        ym, cm = self.mamba.forward(params["mamba"], x,
                                    lora=lora.get("mamba"),
                                    state=cache["mamba"], mode=mode)
        return self._fuse(params, ya, ym), {"attn": ca, "mamba": cm}

    def decode_step(self, params, x, cache, pos: int, *, lora=None,
                    mode=None):
        lora = lora or {}
        ya, ca = self.attn.decode_step(params["attn"], x, cache["attn"], pos,
                                       lora=lora.get("attn"), mode=mode)
        ym, cm = self.mamba.decode_step(params["mamba"], x, cache["mamba"],
                                        lora=lora.get("mamba"), mode=mode)
        return self._fuse(params, ya, ym), {"attn": ca, "mamba": cm}
