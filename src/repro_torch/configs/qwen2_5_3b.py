"""qwen2.5-3b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    source="hf:Qwen/Qwen2.5-0.5B",
    qkv_bias=True,
    rope_base=1_000_000.0,
)
