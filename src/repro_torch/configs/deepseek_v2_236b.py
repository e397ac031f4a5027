"""deepseek-v2-236b — MLA + MoE [arXiv:2405.04434].

60 layers, d_model=5120, 128 heads with Multi-head Latent Attention
(kv_lora_rank=512, q_lora_rank=1536, qk 128 nope + 64 rope, v 128);
MoE: 2 shared + 160 routed experts (d_ff=1536 each), top-6 routing.
Decode uses the absorbed latent cache (512+64 per token — the MLA
cache saving that motivates the arch).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab=102400,
    source="arXiv:2405.04434",
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    shared_d_ff=1536,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_base=10_000.0,
)
