"""Backbones for federated experiments, exposing a flat LoRA task-vector
space (the d-dimensional space MaTU operates in).

* :class:`ArchBackbone` — the general form: any config-zoo model (lm /
  encdec / ssm / moe / vlm / hybrid, reduced or at full width) or the
  bespoke ViT-B/32 behind the flat task-vector interface.  Features come
  from the model's real forward pass.
* :class:`ViTBackbone` — ``ArchBackbone("vit_b32")``, the paper's model.
* :class:`MLPBackbone` — the quickstart's testbed: a frozen 2-layer MLP
  with LoRA adapters on both layers.

The task vector is the flat delta over the standard LoRA init (A
gaussian, B zero), laid out by ``space``
(:class:`~repro_torch.common.tree.TaskVectorSpace`), so τ = 0 is
exactly the pretrained point.  Holders of one task must agree on the
manifest's ``fingerprint``; mixed rounds zero-pad each client's vector
to the round's common d, a multiple of ``D_BOUNDARY``.

Every backbone is an ``nn.Module`` whose frozen weights are buffers, and
exposes ``d``, ``space``, ``fingerprint``, ``feat_out``,
``split_point``, ``features(tv, x)``, ``features_tree(delta, x)`` and
``lin_features(tv, x)``: the features of the model linearised at the
pretrained point, f(0) + J(0)·τ (``torch.func.jvp``; the NTK-FedAvg
baseline trains through it).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import (TaskVectorSpace, tree_add,
                                     tree_leaves_with_path, tree_map)
from repro_torch.configs.base import (ZOO_FAMILIES, check_lora_targets,
                                      load_arch, lora_targets_for)
from repro_torch.models.convert import tensor_from_numpy, tree_from_numpy

# the word-boundary rule: common-d padding quantum for mixed rounds
# (8 × bitpack.WORD_BITS == ref.LAMBDA_BLOCK)
D_BOUNDARY = 256


def round_up_d(d: int, boundary: int = D_BOUNDARY) -> int:
    """Round a task-vector dimension up to the wire word boundary."""
    return -(-int(d) // boundary) * boundary


def linearized(features):
    """``features(p, x)`` linearised at the pretrained point p = 0:
    ``(p, x) -> f(0, x) + J(0, x)·p``, with ``p`` a flat task vector or
    a model-space delta tree.  One ``torch.func.jvp`` (forward mode) at
    a zero primal with tangent ``p``; the result stays differentiable
    in ``p`` (reverse over forward), which is how the local trainer
    takes its gradient."""
    def lin(p, x):
        zero = tree_map(torch.zeros_like, p)
        f0, jvp_out = torch.func.jvp(lambda q: features(q, x), (zero,), (p,))
        return f0 + jvp_out
    return lin


class MLPBackbone(nn.Module):
    """Frozen ``x -> gelu(x W1') -> gelu(· W2')`` with W_i' = W_i + A_i B_i.

    Weights are buffers (never trained); ``features`` takes the LoRA
    delta as a flat task vector."""

    def __init__(self, feat_dim: int, hidden: int = 64, lora_rank: int = 4,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        rn = lambda *s: torch.randn(s, generator=g)  # noqa: E731
        self._install(
            rn(feat_dim, hidden) / math.sqrt(feat_dim),
            rn(hidden, hidden) / math.sqrt(hidden),
            {"l1": {"a": rn(feat_dim, lora_rank) / math.sqrt(feat_dim),
                    "b": torch.zeros(lora_rank, hidden)},
             "l2": {"a": rn(hidden, lora_rank) / math.sqrt(hidden),
                    "b": torch.zeros(lora_rank, hidden)}})

    @classmethod
    def from_numpy(cls, w1: np.ndarray, w2: np.ndarray,
                   lora0: Dict[str, Dict[str, np.ndarray]]) -> "MLPBackbone":
        """A backbone with given frozen weights (numpy arrays), e.g. the
        JAX package's ``MLPBackbone`` parameters carried across."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
        self._install(t(w1), t(w2), {layer: {k: t(v) for k, v in ab.items()}
                                     for layer, ab in lora0.items()})
        return self

    def _install(self, w1: torch.Tensor, w2: torch.Tensor, lora0) -> None:
        self.register_buffer("w1", w1.float().contiguous())
        self.register_buffer("w2", w2.float().contiguous())
        for layer in ("l1", "l2"):
            for k in ("a", "b"):
                self.register_buffer(f"{layer}_{k}",
                                     lora0[layer][k].float().contiguous())
        self.rank = int(lora0["l1"]["a"].shape[1])
        self.space = TaskVectorSpace.from_tree(self.lora0)
        self.d = self.space.d
        self.fingerprint = self.space.fingerprint
        self.feat_out = int(w2.shape[1])
        # FedPer split: layer-1 LoRA shared, layer-2 LoRA personal
        self.split_point = int(self.l1_a.numel() + self.l1_b.numel())

    @property
    def lora0(self) -> dict:
        return {"l1": {"a": self.l1_a, "b": self.l1_b},
                "l2": {"a": self.l2_a, "b": self.l2_b}}

    def features_tree(self, delta, x: torch.Tensor) -> torch.Tensor:
        l = tree_add(self.lora0, delta)
        h = x @ (self.w1 + l["l1"]["a"] @ l["l1"]["b"])
        h = nn.functional.gelu(h, approximate="tanh")
        h = h @ (self.w2 + l["l2"]["a"] @ l["l2"]["b"])
        return nn.functional.gelu(h, approximate="tanh")

    def features(self, tv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.features_tree(self.space.unflatten(tv), x)

    def lin_features(self, tv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """f(0) + J(0)·τ: the features at τ = 0 plus their jvp along τ."""
        return linearized(self.features)(tv, x)


def _generator(device: torch.device, *ids: int) -> torch.Generator:
    """A generator on ``device`` seeded by a hash of ``ids``."""
    seed = np.random.SeedSequence([int(i) for i in ids]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


class ArchBackbone(nn.Module):
    """Flat LoRA task-vector interface over a zoo model.

    ``arch`` is a config-zoo id (``qwen2-0.5b``, ``whisper-large-v3``,
    ``xlstm-1.3b``, ``granite-moe-3b-a800m``, …) or ``vit_b32``, at its
    reduced config unless ``reduced=False``.  The pretrained point is
    the model's random init from ``seed`` (LoRA factors from ``seed +
    1``); parameters, LoRA init and the input projection are buffers on
    ``device`` (default CUDA; raises without a card).

    Features are the model's real forward pass:

    * vit — x as patches: patch-sized (B, patch_dim), tiled across the
      patches, or flat (B, n_patches · patch_dim); the CLS features;
    * lm-kind (dense / moe / ssm / hybrid / vlm) — x enters through the
      frozen ``in_proj`` as ``ctx_len`` ``extra_embeds`` positions ahead
      of one query token; the features are the final hidden state at the
      query position (so they depend on every block's adapters);
    * encdec (audio) — the projected x enters as encoder frames; the
      features are the decoder's final hidden state (through
      cross-attention, so encoder and decoder adapters both matter).
    """

    def __init__(self, arch: str, feat_dim: Optional[int] = None, *,
                 seed: int = 0, ctx_len: int = 4, reduced: bool = True,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = self._setup(arch, feat_dim, ctx_len, reduced, device)
        params = self.model.init(torch.Generator(device=dev)
                                 .manual_seed(seed))
        lora0 = self.model.lora_init(
            torch.Generator(device=dev).manual_seed(seed + 1),
            self.cfg.lora_rank)
        in_proj = None
        if self.kind != "vit":
            # fixed random input projection: features -> ctx_len
            # pseudo-token embeddings (frozen, untrained)
            in_proj = torch.randn(
                (self.feat_dim, self.ctx_len * self.cfg.d_model),
                generator=_generator(dev, seed, 0xF0), device=dev) \
                / math.sqrt(self.feat_dim)
        self._install(params, lora0, in_proj)

    @classmethod
    def from_numpy(cls, arch: str, params, lora0, in_proj=None, *,
                   feat_dim: Optional[int] = None, ctx_len: int = 4,
                   reduced: bool = True,
                   device: DeviceLike = "cuda") -> "ArchBackbone":
        """A backbone with given frozen trees (numpy), e.g. the JAX
        package's ``ArchBackbone`` ``params``, ``lora0`` and
        ``in_proj`` carried across; paths and shapes are checked."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        dev = self._setup(arch, feat_dim, ctx_len, reduced, device)
        rank = self.cfg.lora_rank
        self._install(
            tree_from_numpy(self.model.init(device="meta"), params, dev),
            tree_from_numpy(self.model.lora_init(None, rank, device="meta"),
                            lora0, dev, "LoRA"),
            None if in_proj is None else tensor_from_numpy(
                in_proj, dev, torch.float32))
        return self

    def _setup(self, arch, feat_dim, ctx_len, reduced, device):
        """Config, model and shapes of ``arch``; returns the device."""
        dev = resolve_device(device)
        self.arch, self.reduced = arch, reduced
        if arch in ("vit", "vit_b32"):
            from repro_torch.configs.vit_b32 import CONFIG, build, reduced_vit
            self.cfg = reduced_vit() if reduced else CONFIG
            self.model = build(self.cfg, device=dev)
            self.kind = "vit"
            self.feat_dim = self.cfg.patch_dim * self.cfg.n_patches
        else:
            cfg = load_arch(arch)
            self.cfg = cfg.reduced() if reduced else cfg
            am = self.cfg.build(device=dev)
            self.model = am.model
            self.kind = am.kind          # "lm" | "encdec"
            if feat_dim is None:
                raise ValueError(f"{arch}: feat_dim is required for "
                                 "lm/encdec backbones")
            self.feat_dim = int(feat_dim)
            self.ctx_len = int(ctx_len)
        self.feat_out = self.cfg.d_model
        return dev

    def _install(self, params, lora0, in_proj) -> None:
        self._params_paths = self._register("p", params)
        self._lora_paths = self._register("l", lora0)
        if in_proj is not None:
            self.register_buffer("in_proj", in_proj.float().contiguous())
        self.space = TaskVectorSpace.from_tree(lora0)
        self.d = self.space.d
        self.fingerprint = self.space.fingerprint
        # declared targeting rules vs the actual manifest: fail loudly at
        # construction, not mid-round
        check_lora_targets(lora_targets_for(self.cfg),
                           [l.path for l in self.space.leaves],
                           context=self.arch)
        # FedPer split at the leaf boundary nearest d/2
        half = self.d // 2
        self.split_point = min((l.offset for l in self.space.leaves
                                if l.offset >= half), default=half)

    def _register(self, prefix: str, tree) -> List[Tuple[str, ...]]:
        paths = []
        for path, leaf in tree_leaves_with_path(tree):
            self.register_buffer("__".join((prefix,) + path),
                                 leaf.contiguous())
            paths.append(path)
        return paths

    def _tree(self, prefix: str, paths) -> dict:
        root: dict = {}
        for path in paths:
            node = root
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, "__".join((prefix,) + path))
        return root

    @property
    def params(self) -> dict:
        return self._tree("p", self._params_paths)

    @property
    def lora0(self) -> dict:
        return self._tree("l", self._lora_paths)

    def _apply(self, fn, recurse=True):
        # a move (``.to``) carries the buffers; the model's own device,
        # which picks where its default positions are made, follows
        out = super()._apply(fn, recurse)
        self.model.device = getattr(self, "__".join(
            ("l",) + self._lora_paths[0])).device
        return out

    # -- feature paths ------------------------------------------------------
    def features_tree(self, delta, x: torch.Tensor) -> torch.Tensor:
        """(B, feat_out) features from the model-space delta tree."""
        lora = tree_add(self.lora0, delta)
        b = x.shape[0]
        if self.kind == "vit":
            cfg = self.cfg
            if x.shape[-1] == cfg.patch_dim:
                patches = x[:, None, :].expand(b, cfg.n_patches,
                                               cfg.patch_dim)
            else:
                patches = x.reshape(b, cfg.n_patches, cfg.patch_dim)
            return self.model.features(self.params, patches, lora=lora)
        tokens = torch.zeros((b, 1), dtype=torch.long, device=x.device)
        ctx = (x @ self.in_proj).reshape(b, self.ctx_len, self.cfg.d_model)
        if self.kind == "encdec":
            hidden = self.model.forward(self.params, tokens, ctx, lora=lora,
                                        return_hidden=True)
        else:
            hidden = self.model.forward(self.params, tokens, lora=lora,
                                        extra_embeds=ctx, return_hidden=True)
        return hidden[:, -1]

    def features(self, tv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.features_tree(self.space.unflatten(tv), x)

    def lin_features(self, tv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """f(0) + J(0)·τ: the features at τ = 0 plus their jvp along τ."""
        return linearized(self.features)(tv, x)


class ViTBackbone(ArchBackbone):
    """The paper's model family (ViT + LoRA): ``ArchBackbone`` on
    vit_b32."""

    def __init__(self, seed: int = 0, reduced: bool = True,
                 device: DeviceLike = "cuda"):
        super().__init__("vit_b32", seed=seed, reduced=reduced,
                         device=device)


def make_zoo_backbones(feat_dim: int, families=None, *, seed: int = 0,
                       ctx_len: int = 4, device: DeviceLike = "cuda"
                       ) -> Dict[str, ArchBackbone]:
    """One reduced :class:`ArchBackbone` per zoo family
    (``ZOO_FAMILIES``).  ``feat_dim`` must equal the reduced vit's
    patch_dim (32) when the vit family is included: the constellation
    feeds every backbone the same (B, feat_dim) batches."""
    out: Dict[str, ArchBackbone] = {}
    for fam in (families or list(ZOO_FAMILIES)):
        arch = ZOO_FAMILIES[fam]
        bb = ArchBackbone(arch, feat_dim=None if fam == "vit" else feat_dim,
                          seed=seed, ctx_len=ctx_len, device=device)
        if fam == "vit" and bb.cfg.patch_dim != feat_dim:
            raise ValueError(
                f"vit patch_dim {bb.cfg.patch_dim} != feat_dim {feat_dim}: "
                "the constellation must feed patch-sized features")
        out[fam] = bb
    return out
