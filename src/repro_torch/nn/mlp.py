"""Feed-forward blocks: SwiGLU (llama/qwen family) and GELU (whisper,
ViT).  Under a mesh the hidden layer is pinned to ``("batch", None,
"mlp")`` and the output to the sequence-parallel residual ``("batch",
"act_seq", "embed")``, as in the JAX package."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.nn.module import Dense, Module
from repro_torch.nn.sharding import constrain

Tree = Any


class SwiGLU(Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype=torch.float32):
        self.d_model, self.d_ff, self.dtype = d_model, d_ff, dtype
        self.gate = Dense(d_model, d_ff, axes=("embed", "mlp"), dtype=dtype)
        self.up = Dense(d_model, d_ff, axes=("embed", "mlp"), dtype=dtype)
        self.down = Dense(d_ff, d_model, axes=("mlp", "embed"), dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"gate": self.gate.init(generator, device, lead),
                "up": self.up.init(generator, device, lead),
                "down": self.down.init(generator, device, lead)}

    def axes(self):
        return {"gate": self.gate.axes(), "up": self.up.axes(),
                "down": self.down.axes()}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"down": self.down.lora_init(generator, rank, device, lead)}

    def lora_axes(self):
        return {"down": self.down.lora_axes()}

    def __call__(self, params, x, lora: Optional[Tree] = None, *,
                 mode: Optional[str] = None):
        lora = lora or {}
        h = (torch.nn.functional.silu(self.gate(params["gate"], x))
             * self.up(params["up"], x))
        h = constrain(h, ("batch", None, "mlp"))
        return constrain(self.down(params["down"], h, lora.get("down"),
                                   mode=mode), ("batch", "act_seq", "embed"))


class GeluMLP(Module):
    """down(gelu_tanh(up(x))); both Dense layers biased, LoRA on ``down``
    only (JAX's ``jax.nn.gelu(approximate=True)``)."""

    def __init__(self, d_model: int, d_ff: int, *, bias: bool = True,
                 dtype=torch.float32):
        self.d_model, self.d_ff, self.dtype = d_model, d_ff, dtype
        self.up = Dense(d_model, d_ff, bias=bias, axes=("embed", "mlp"),
                        dtype=dtype)
        self.down = Dense(d_ff, d_model, bias=bias, axes=("mlp", "embed"),
                          dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"up": self.up.init(generator, device, lead),
                "down": self.down.init(generator, device, lead)}

    def axes(self):
        return {"up": self.up.axes(), "down": self.down.axes()}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"down": self.down.lora_init(generator, rank, device, lead)}

    def lora_axes(self):
        return {"down": self.down.lora_axes()}

    def __call__(self, params, x, lora: Optional[Tree] = None, *,
                 mode: Optional[str] = None):
        lora = lora or {}
        h = torch.nn.functional.gelu(self.up(params["up"], x),
                                     approximate="tanh")
        h = constrain(h, ("batch", None, "mlp"))
        return constrain(self.down(params["down"], h, lora.get("down"),
                                   mode=mode), ("batch", "act_seq", "embed"))
