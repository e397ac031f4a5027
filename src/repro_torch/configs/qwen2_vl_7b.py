"""qwen2-vl-7b — M-RoPE, prepended vision embeddings [arXiv:2409.12191].

28 dense layers, d_model 3,584, 28 heads (GQA kv 4, head_dim 128), SwiGLU
d_ff 18,944, vocab 152,064, QKV bias, rope base 1e6, untied readout.
M-RoPE splits the 64 rotary frequency slots into (16, 24, 24) for the
temporal / height / width coordinates of a (B, S, 3) position tensor.
As in the JAX package, the vision encoder and projector are a stub: a
request carries its ``vision_tokens`` precomputed patch embeddings
(``extra_embeds``, d_model wide), which the model prepends to the text.
LoRA rank 16 on the dense family's three sites (``mixer/wq``,
``mixer/wo``, ``ffn/down``), so the fused serving route runs kernel 9
six times a layer.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    source="arXiv:2409.12191",
    qkv_bias=True,
    rope_base=1_000_000.0,
    mrope_sections=(16, 24, 24),
    vision_tokens=1024,
)
