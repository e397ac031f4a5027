"""Neural-network building blocks of the port: the functional module
system with LoRA-aware ``Dense`` (``module``), RoPE (``rope``), GQA with
a KV cache (``attention``), SwiGLU (``mlp``) and the xLSTM mLSTM and
sLSTM blocks (``ssm``)."""
