"""Feed-forward blocks: SwiGLU (llama/qwen family) and GELU (whisper;
ViT when it is ported)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.nn.module import Dense, Module

Tree = Any


class SwiGLU(Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype=torch.float32):
        self.d_model, self.d_ff, self.dtype = d_model, d_ff, dtype
        self.gate = Dense(d_model, d_ff, dtype=dtype)
        self.up = Dense(d_model, d_ff, dtype=dtype)
        self.down = Dense(d_ff, d_model, dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"gate": self.gate.init(generator, device, lead),
                "up": self.up.init(generator, device, lead),
                "down": self.down.init(generator, device, lead)}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"down": self.down.lora_init(generator, rank, device, lead)}

    def __call__(self, params, x, lora: Optional[Tree] = None, *,
                 mode: Optional[str] = None):
        lora = lora or {}
        h = (torch.nn.functional.silu(self.gate(params["gate"], x))
             * self.up(params["up"], x))
        return self.down(params["down"], h, lora.get("down"), mode=mode)


class GeluMLP(Module):
    """down(gelu_tanh(up(x))); both Dense layers biased, LoRA on ``down``
    only (JAX's ``jax.nn.gelu(approximate=True)``)."""

    def __init__(self, d_model: int, d_ff: int, *, bias: bool = True,
                 dtype=torch.float32):
        self.d_model, self.d_ff, self.dtype = d_model, d_ff, dtype
        self.up = Dense(d_model, d_ff, bias=bias, dtype=dtype)
        self.down = Dense(d_ff, d_model, bias=bias, dtype=dtype)

    def init(self, generator, device=None, lead: Sequence[int] = ()):
        return {"up": self.up.init(generator, device, lead),
                "down": self.down.init(generator, device, lead)}

    def lora_init(self, generator, rank: int, device=None,
                  lead: Sequence[int] = ()):
        return {"down": self.down.lora_init(generator, rank, device, lead)}

    def __call__(self, params, x, lora: Optional[Tree] = None, *,
                 mode: Optional[str] = None):
        lora = lora or {}
        h = torch.nn.functional.gelu(self.up(params["up"], x),
                                     approximate="tanh")
        return self.down(params["down"], h, lora.get("down"), mode=mode)
