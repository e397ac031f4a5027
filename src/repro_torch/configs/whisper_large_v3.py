"""whisper-large-v3 — encoder-decoder, conv front end a stub
[arXiv:2212.04356].

32 encoder and 32 decoder layers, d_model 1280, 20 MHA heads (head_dim
64), GELU MLP of d_ff 5120, vocab 51,866, tied readout.  The encoder
takes precomputed 1,500-frame embeddings (the mel and conv front end is
stubbed, as in the JAX package).  LoRA rank 16 on the family's eight
sites (``encoder/{attn/wq, attn/wo, mlp/down}``, ``decoder/{self_attn,
cross_attn}/{wq, wo}``, ``decoder/mlp/down``).  long_500k is skipped
for this arch: a 500k-token decoder context has no audio meaning.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    source="arXiv:2212.04356",
    enc_frames=1500,
    sliding_window_long=None,  # long_500k skipped
)
