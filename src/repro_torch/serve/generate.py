"""Batched autoregressive generation over any model with the
``init_cache`` / ``prefill_step`` / ``decode_fn`` interface.

The JAX package runs the decode steps as one jitted ``lax.scan``; here
they are a Python loop: prefill, then ``max_new_tokens - 1`` decode
steps, each one token for the whole batch against the in-place cache.
Sampling is greedy, or temperature / top-k from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

Tree = Any


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => full distribution
    eos_id: Optional[int] = None


def _sample(logits: torch.Tensor, cfg: GenerationConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _streams(rng: Optional[torch.Generator], device):
    """Two independent generator streams, as the JAX package splits its
    key before the first sample: one for the prefill sample, one for the
    decode steps."""
    if rng is None:
        rng = torch.Generator(device="cpu").manual_seed(0)
    seeds = torch.randint(0, 2 ** 62, (2,), generator=rng,
                          device=rng.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def generate(model, params, lora, prompt: torch.Tensor,
             cfg: GenerationConfig = GenerationConfig(), *,
             rng: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             mode: Optional[str] = None) -> torch.Tensor:
    """prompt (B, S) int -> (B, S + max_new_tokens) int32.  ``mode``
    reaches every kernel dispatch of the model ("ref": plain versions)."""
    b, s = prompt.shape
    max_len = max_len or (s + cfg.max_new_tokens + 8)
    first_gen, step_gen = (_streams(rng, prompt.device)
                           if cfg.temperature > 0.0 else (None, None))
    cache = model.init_cache(b, max_len)
    logits, cache = model.prefill_step(params, lora, {"tokens": prompt},
                                       cache, mode=mode)
    tok = _sample(logits, cfg, first_gen)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    if cfg.eos_id is not None:
        done = done | (tok == cfg.eos_id)
    out = [tok]
    for pos in range(s, s + cfg.max_new_tokens - 1):
        logits, cache = model.decode_fn(params, lora,
                                        {"tokens": tok[:, None]}, cache, pos,
                                        mode=mode)
        nxt = _sample(logits, cfg, step_gen)
        if cfg.eos_id is not None:
            nxt = torch.where(done, cfg.eos_id, nxt).to(torch.int32)
            done = done | (nxt == cfg.eos_id)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt.to(torch.int32), torch.stack(out, dim=1)],
                     dim=1)
