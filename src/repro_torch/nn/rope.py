"""Rotary position embeddings: standard RoPE, rotate-half convention.

M-RoPE (Qwen2-VL's sectioned positions) is not ported yet; it comes
with the qwen2-vl config.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                base: float) -> torch.Tensor:
    """positions (..., S) -> fp32 angles (..., S, head_dim // 2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (base ** exps)
    return positions.float()[..., None] * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               base: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, D), D even; positions (B, S) int.  The rotation runs
    in fp32 and the result returns in x's dtype."""
    half = x.shape[-1] // 2
    ang = rope_angles(positions, x.shape[-1], base)     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
