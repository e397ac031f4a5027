"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48 layers at d_model 2048 as 24 alternating (mLSTM, sLSTM) pairs, 4
heads, vocab 50,304, tied embeddings, no FFN outside the blocks (the
mLSTM block carries a proj_factor-2 up-projection, the sLSTM block a
GeGLU FFN).  The mLSTM prefill runs chunkwise over chunks of
``mlstm_chunk`` = 256 steps (``ArchConfig``'s default); LoRA rank 16.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    source="arXiv:2405.04517",
    tie_embeddings=True,
    sliding_window_long=None,  # attention-free
)
