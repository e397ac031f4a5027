"""Minimal functional module system, the JAX package's in PyTorch.

A module is a config-carrying object with

* ``init(generator, device, lead=()) -> params``: a nested dict of
  tensors (``lead`` prepends stacked axes, e.g. ``(n_layers,)``);
* ``axes() -> axes``: the same structure, each leaf the tuple of
  *logical* axis names of its tensor (``nn.sharding`` maps them onto a
  mesh), as the JAX package's; ``lora_axes`` / ``cache_axes`` likewise
  for the LoRA and cache trees;
* ``__call__(params, ...)``: a function of (params, inputs).

Parameters are plain nested dicts in the JAX package's layout — a
Dense weight is (in, out) — so a JAX parameter tree converts leaf for
leaf (``repro_torch.models.convert``) and task vectors, LoRA trees and
the :class:`~repro_torch.common.tree.TaskVectorSpace` manifest work on
them directly.  Random initialisation draws from a ``torch.Generator``;
it gives other numbers than ``jax.random`` from the same seed.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.nn.sharding import flat_ready

Tree = Any


def _normal(generator, shape, device, scale: float, dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in fp32, then cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def stack_axes(axes: Tree) -> Tree:
    """``axes`` with ``"layers"`` prepended to every leaf: the axes of a
    tree stacked along a leading layers axis (a None leaf, a scalar,
    becomes ``("layers",)``)."""
    if axes is None or isinstance(axes, tuple):
        return ("layers",) + tuple(axes or ())
    return {k: stack_axes(v) for k, v in axes.items()}


class Module:
    """Base class; subclasses define ``init``, ``axes`` and ``__call__``."""

    def init_stacked(self, generator, n: int, device=None) -> Tree:
        """``n`` independent inits stacked along a leading layers axis."""
        return self.init(generator, device, lead=(n,))

    def stacked_axes(self) -> Tree:
        return stack_axes(self.axes())


def _promoted(*ts):
    """``ts`` cast to their common dtype, as ``jnp.einsum`` promotes its
    operands (an fp32 activation against bf16 weights computes in fp32;
    equal dtypes are left as they are)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


class Dense(Module):
    """y = x @ W (+ b), W stored (in, out).  LoRA-aware: pass the mirrored
    ``lora`` subtree in one of four forms (see :meth:`__call__`)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 axes: Tuple[Optional[str], Optional[str]] = (None, None),
                 dtype=torch.float32, scale: Optional[float] = None):
        self.in_dim, self.out_dim, self.bias = in_dim, out_dim, bias
        self._axes, self.dtype, self.scale = tuple(axes), dtype, scale

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        scale = (self.scale if self.scale is not None
                 else 1.0 / math.sqrt(self.in_dim))
        lead = tuple(lead)
        p = {"w": _normal(generator, lead + (self.in_dim, self.out_dim),
                          device, scale, self.dtype)}
        if self.bias:
            p["b"] = torch.zeros(lead + (self.out_dim,), dtype=self.dtype,
                                 device=device)
        return p

    def axes(self):
        a = {"w": self._axes}
        if self.bias:
            a["b"] = (self._axes[1],)
        return a

    def lora_axes(self):
        return {"a": (self._axes[0], "lora"), "b": ("lora", self._axes[1]),
                "alpha": None}

    def __call__(self, params, x, lora: Optional[Tree] = None, *,
                 mode: Optional[str] = None):
        """The LoRA branches, as in the JAX package:

        * none: ``lora`` is None or carries no ``a``;
        * plain: a (in, r), b (r, out): ``y += (x @ a) @ b · α/r``;
        * dense-routed: per-request leaves a (B, in, r), b (B, r, out),
          alpha (B,);
        * fused: ``a`` / ``b`` are dicts ``{"base", "tau", "words"}`` and
          ``lam`` / ``alpha`` (B,): both LoRA products go through
          ``ops.modulated_matmul`` (``mode`` reaches it), so each
          request's modulated weight is built inside the kernel.
        """
        x = flat_ready(x)
        y = torch.matmul(*_promoted(x, params["w"]))
        if lora is not None and "a" in lora:
            a = lora["a"]
            if isinstance(a, dict):
                y = y + self._lora_routed_fused(x, lora, mode)
            elif a.dim() == 3:
                r = a.shape[-1]
                scaling = lora["alpha"].to(x.dtype) / r
                h = torch.einsum("b...i,bir->b...r", *_promoted(x, a))
                yl = torch.einsum("b...r,bro->b...o",
                                  *_promoted(h, lora["b"]))
                y = y + yl * scaling.reshape((-1,) + (1,) * (yl.dim() - 1))
            else:
                r = a.shape[-1]
                alpha = lora.get("alpha")
                scaling = (alpha if alpha is not None else float(r)) / r
                h = torch.matmul(*_promoted(x, a))
                y = y + torch.matmul(*_promoted(h, lora["b"])) * scaling
        if self.bias:
            y = y + params["b"]
        return y

    @staticmethod
    def _lora_routed_fused(x, lora, mode):
        """Fused serving branch: x (B, in) or (B, S, in); the two LoRA
        factors run through ``ops.modulated_matmul`` in fp32, scaled by
        each request's α/r, and the sum returns in x's dtype.  The
        kernel's effective weight ``base + (λ·m)·τ`` is bitwise the
        dense-routed adapter leaf in fp32."""
        from repro_torch.kernels import ops
        af, bf, lam = lora["a"], lora["b"], lora["lam"]
        r = af["base"].shape[-1]
        squeeze = x.dim() == 2
        x3 = (x[:, None, :] if squeeze else x).float().contiguous()
        h = ops.modulated_matmul(x3, af["base"], af["tau"], af["words"],
                                 lam, mode=mode)
        yl = ops.modulated_matmul(h, bf["base"], bf["tau"], bf["words"],
                                  lam, mode=mode)
        yl = yl * (lora["alpha"].float() / r)[:, None, None]
        yl = yl[:, 0] if squeeze else yl
        return yl.to(x.dtype)

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = (), *, alpha: Optional[float] = None,
                  dtype=None):
        dtype = dtype or self.dtype
        lead = tuple(lead)
        return {
            "a": _normal(generator, lead + (self.in_dim, rank), device,
                         1.0 / math.sqrt(self.in_dim), dtype),
            "b": torch.zeros(lead + (rank, self.out_dim), dtype=dtype,
                             device=device),
            "alpha": torch.full(lead, float(alpha if alpha is not None
                                            else rank),
                                dtype=dtype, device=device),
        }


class Embedding(Module):
    def __init__(self, vocab: int, dim: int, *, dtype=torch.float32,
                 axes: Tuple[str, str] = ("vocab", "embed")):
        self.vocab, self.dim, self.dtype, self._axes = vocab, dim, dtype, axes

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"table": _normal(generator, tuple(lead) + (self.vocab,
                                                           self.dim),
                                 device, 0.02, self.dtype)}

    def axes(self):
        return {"table": self._axes}

    def __call__(self, params, ids):
        """The rows of ``ids``; ``F.embedding``, whose DTensor rule reads
        a vocab-sharded table (indexing has none)."""
        return torch.nn.functional.embedding(ids, params["table"])

    def attend(self, params, x):
        """Tied readout: logits = x @ table^T."""
        return torch.matmul(x, params["table"].t())


class RMSNorm(Module):
    def __init__(self, dim: int, *, eps: float = 1e-6, dtype=torch.float32):
        self.dim, self.eps, self.dtype = dim, eps, dtype

    def init(self, generator=None, device=None, lead: Sequence[int] = ()):
        return {"scale": torch.ones(tuple(lead) + (self.dim,),
                                    dtype=self.dtype, device=device)}

    def axes(self):
        return {"scale": ("embed",)}

    def __call__(self, params, x):
        dt = x.dtype
        x32 = x.float()
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                              + self.eps)
        return (y * params["scale"].float()).to(dt)


class LayerNorm(Module):
    """The JAX package's LayerNorm: fp32 mean and ``mean((x - mu)^2)``,
    then ``(x - mu) · rsqrt(var + eps) · scale + bias`` cast back (not
    ``F.layer_norm``, whose variance is computed another way)."""

    def __init__(self, dim: int, *, eps: float = 1e-5, dtype=torch.float32):
        self.dim, self.eps, self.dtype = dim, eps, dtype

    def init(self, generator=None, device=None, lead: Sequence[int] = ()):
        shape = tuple(lead) + (self.dim,)
        return {"scale": torch.ones(shape, dtype=self.dtype, device=device),
                "bias": torch.zeros(shape, dtype=self.dtype, device=device)}

    def axes(self):
        return {"scale": ("embed",), "bias": ("embed",)}

    def __call__(self, params, x):
        dt = x.dtype
        x32 = x.float()
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * params["scale"].float()
                + params["bias"].float()).to(dt)
