"""Optimizers of the port (functional, over parameter trees)."""

from repro_torch.optim.optimizers import Optimizer, adamw

__all__ = ["Optimizer", "adamw"]
