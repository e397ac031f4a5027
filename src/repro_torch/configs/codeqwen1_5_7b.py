"""codeqwen1.5-7b — qwen1.5 arch, MHA [hf:Qwen/CodeQwen1.5-7B]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    source="hf:Qwen/CodeQwen1.5-7B",
    qkv_bias=True,
    rope_base=1_000_000.0,
)
