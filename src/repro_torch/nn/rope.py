"""Rotary position embeddings, rotate-half convention: standard RoPE and
Qwen2-VL's M-RoPE (sectioned (t, h, w) positions)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, base: float,
                mrope_sections: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
    """positions (..., S) -> fp32 angles (..., S, head_dim // 2).  With
    ``mrope_sections`` positions are (..., S, 3) (t, h, w) coordinates:
    the head_dim / 2 frequency slots are split into those sections, and
    each takes its phase from its own coordinate."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (base ** exps)
    if mrope_sections is None:
        return positions.float()[..., None] * freqs
    if positions.shape[-1] != len(mrope_sections):
        raise ValueError(f"M-RoPE needs {len(mrope_sections)} coordinates "
                         f"a position, got {tuple(positions.shape)}")
    if sum(mrope_sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do not "
                         f"sum to head_dim / 2 = {half}")
    per, offset = [], 0
    for i, sec in enumerate(mrope_sections):
        per.append(positions[..., i].float()[..., None]
                   * freqs[offset:offset + sec])
        offset += sec
    return torch.cat(per, dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               base: float = 10000.0,
               mrope_sections: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
    """x (B, S, H, D), D even; positions (B, S) int, or (B, S, 3) with
    ``mrope_sections`` (:func:`rope_angles`).  The rotation runs in fp32
    and the result returns in x's dtype."""
    half = x.shape[-1] // 2
    ang = rope_angles(positions, x.shape[-1], base, mrope_sections)
    cos = torch.cos(ang)[:, :, None, :]                     # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Lift (B, S) text positions to (B, S, 3) M-RoPE coordinates, all
    three equal."""
    return torch.stack([positions, positions, positions], dim=-1)
