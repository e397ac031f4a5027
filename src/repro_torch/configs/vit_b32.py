"""ViT-B/32 — the paper's own model [Dosovitskiy et al., 2021].

Used with LoRA rank 16, as in the paper, by the federated path.  224 ×
224 images at 32-pixel patches give 49 patches of dim 3,072; patches are
extracted outside the model.  ``reduced_vit()`` is the small variant the
CPU tests use.  The JAX package's ``configs/vit_b32.py``, field for
field.
"""

from dataclasses import dataclass

import torch

from repro_torch.common.device import DeviceLike


@dataclass(frozen=True)
class ViTConfig:
    patch_dim: int = 3072        # 32*32*3
    n_patches: int = 49
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    lora_rank: int = 16
    family: str = "vit"          # LoRA targeting rules key (configs.base)


CONFIG = ViTConfig()


def reduced_vit() -> ViTConfig:
    return ViTConfig(patch_dim=32, n_patches=8, d_model=64, n_layers=2,
                     n_heads=4, d_ff=128, lora_rank=4)


def build(cfg: ViTConfig = CONFIG, dtype=None, device: DeviceLike = "cuda"):
    """The :class:`~repro_torch.models.vit.ViT` of ``cfg`` on ``device``
    (default CUDA; raises without a card), fp32 unless ``dtype``."""
    from repro_torch.models.vit import ViT
    return ViT(patch_dim=cfg.patch_dim, n_patches=cfg.n_patches,
               d_model=cfg.d_model, n_layers=cfg.n_layers,
               n_heads=cfg.n_heads, d_ff=cfg.d_ff,
               dtype=dtype or torch.float32, device=device)
