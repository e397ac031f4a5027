"""hymba-1.5b — parallel attention + Mamba heads [arXiv:2411.13676].

32 hybrid layers, d_model 1600, 25 attention heads (GQA kv 5, head_dim
64) in parallel with a Mamba branch (d_inner 3,200, ssm_state 16, conv
kernel 4, dt_rank 100); a sliding window of 2,048 on the attention
branch, so its decode cache is a 2,048-slot ring; SwiGLU d_ff 5,504,
vocab 32,001, untied readout.  LoRA rank 16 on the family's five sites
(``mixer/attn/{wq, wo}``, ``mixer/mamba/{in_proj, out_proj}``,
``ffn/down``), so the fused serving route runs kernel 9 ten times a
layer.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    source="arXiv:2411.13676",
    ssm_state=16,
    hybrid_window=2048,
    rope_base=10_000.0,
)
