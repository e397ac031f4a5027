"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    source="hf:Qwen/Qwen2.5-0.5B",
    qkv_bias=True,
    rope_base=1_000_000.0,
)
