"""Optimizers of the port (functional, over parameter trees)."""

from repro_torch.optim.optimizers import (Optimizer, adamw, chain,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup_cosine)

__all__ = ["Optimizer", "adamw", "sgd", "clip_by_global_norm", "chain",
           "constant", "cosine_decay", "linear_warmup_cosine"]
