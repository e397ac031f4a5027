"""Device choice for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  A CUDA
device without a card raises: the port never falls back to the CPU on
its own.  Callers that want the CPU (the tests) say so.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
