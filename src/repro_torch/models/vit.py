"""Vision Transformer backbone (the paper's own model family, ViT-B/32),
the JAX package's ``models/vit.py``.

Patchification is external: the model takes patch vectors (B,
n_patches, patch_dim).  Per-task classifier heads live in the federated
layer (``repro_torch.fed``), so MaTU task vectors cover exactly the
shared LoRA parameters, as in the paper.  The layers run as a Python
loop over the ``[l]`` views of the stacked parameter and LoRA leaves,
where the JAX package scans.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models.encdec import EncoderBlock
from repro_torch.models.lm import as_generator, layer_views
from repro_torch.nn.module import Dense, LayerNorm, Module, _normal, stack_axes
from repro_torch.nn.sharding import constrain

Tree = Any


class ViT(Module):
    def __init__(self, *, patch_dim: int, n_patches: int, d_model: int,
                 n_layers: int, n_heads: int, d_ff: int, remat: bool = False,
                 dtype=torch.float32, device: DeviceLike = "cuda"):
        self.patch_dim, self.n_patches = patch_dim, n_patches
        self.d_model, self.n_layers = d_model, n_layers
        # ``remat`` is kept for the reference's signature and ignored: the
        # reference's config never sets it, so its ViT never
        # rematerialises a layer, and neither does this one
        del remat
        self.dtype = dtype
        self.device = resolve_device(device)
        self.patch_embed = Dense(patch_dim, d_model, bias=True,
                                 axes=(None, "embed"), dtype=dtype)
        self.block = EncoderBlock(d_model, n_heads, d_ff, dtype=dtype)
        self.final_ln = LayerNorm(d_model, dtype=dtype)

    def init(self, generator=0, *, device=None) -> Tree:
        """Random parameters on the model's device (``device="meta"``
        gives the shapes alone); ``generator`` is a ``torch.Generator``
        or an int seed."""
        dev = torch.device(device) if device is not None else self.device
        g = None if dev.type == "meta" else as_generator(generator, dev)
        return {
            "patch_embed": self.patch_embed.init(g, dev),
            "cls": _normal(g, (1, 1, self.d_model), dev, 0.02, self.dtype),
            "pos": _normal(g, (1, self.n_patches + 1, self.d_model), dev,
                           0.02, self.dtype),
            "blocks": self.block.init(g, dev, (self.n_layers,)),
            "final_ln": self.final_ln.init(None, dev),
        }

    def axes(self) -> Tree:
        return {"patch_embed": self.patch_embed.axes(),
                "cls": (None, None, "embed"), "pos": (None, None, "embed"),
                "blocks": self.block.stacked_axes(),
                "final_ln": self.final_ln.axes()}

    def lora_axes(self) -> Tree:
        return {"blocks": stack_axes(self.block.lora_axes())}

    def lora_init(self, generator, rank: int, *, device=None) -> Tree:
        dev = torch.device(device) if device is not None else self.device
        g = None if dev.type == "meta" else as_generator(generator, dev)
        return {"blocks": self.block.lora_init(g, rank, dev,
                                               (self.n_layers,))}

    def features(self, params, patches, *, lora=None):
        """patches (B, P, patch_dim) -> CLS features (B, d_model)."""
        b = patches.shape[0]
        x = self.patch_embed(params["patch_embed"], patches.to(self.dtype))
        cls = params["cls"].expand(b, 1, self.d_model)
        x = constrain(torch.cat([cls, x], dim=1) + params["pos"],
                      ("batch", None, "embed"))
        for p, l in zip(layer_views(params["blocks"], self.n_layers),
                        layer_views(None if lora is None else lora["blocks"],
                                    self.n_layers)):
            x = self.block(p, x, lora=l)
        x = self.final_ln(params["final_ln"], x)
        return x[:, 0]

    def __call__(self, params, patches, *, lora=None):
        return self.features(params, patches, lora=lora)
