"""granite-moe-3b-a800m — 40 routed experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

32 layers, d_model 1536, 24 heads (GQA kv 8, head_dim 64), per-expert
d_ff 512, vocab 49,155, tied embeddings, no shared expert.  LoRA rank 16
on ``mixer/wq`` and ``mixer/wo`` (the routed experts stay frozen), so the
fused serving route runs kernel 9 four times a layer.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_experts=40,
    top_k=8,
    rope_base=10_000.0,
    tie_embeddings=True,
)
