"""Carry parameter trees across: numpy trees (e.g. the JAX package's
``model.init(...)`` output mapped through ``np.asarray``) into the port's
tensors, checked leaf for leaf against the port model's own tree.

Both packages keep parameters as nested dicts with the same keys and the
same (in, out) weight layout, so the conversion is a per-leaf copy into
the dtype of the port model's own leaf (so the fp32 ``a_log`` and ``d``
of a Mamba stay fp32 inside a bf16 model); any difference in paths or
shapes raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves_with_path

Tree = Any


def tensor_from_numpy(arr, device=None, dtype=None) -> torch.Tensor:
    """One array -> tensor; numpy (ml_dtypes) bfloat16 is carried by its
    bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device=device, dtype=dtype)


def tree_from_numpy(like: Tree, tree: Tree, device=None,
                    what: str = "parameter") -> Tree:
    """A numpy tree carried into tensors on ``device``, each in the dtype
    of the same leaf of ``like`` (a model's ``init(device="meta")`` or
    ``lora_init`` tree); raises if the paths or shapes differ.  The
    ViT's trees, which have no ``ArchModel``, come across here."""
    want = {"/".join(p): x for p, x in tree_leaves_with_path(like)}
    got = {"/".join(p): x for p, x in tree_leaves_with_path(tree)}
    if set(want) != set(got):
        raise ValueError(f"{what} tree paths differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    out: dict = {}
    for path, ref in want.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{what} leaf {path!r}: shape "
                             f"{tuple(arr.shape)} != {tuple(ref.shape)}")
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = tensor_from_numpy(arr, device, ref.dtype)
    return out


def params_from_numpy(model, tree: Tree) -> Tree:
    """The port's parameters (on the model's device, in its dtypes) from
    a numpy tree of the JAX package's parameters of the same config;
    ``model`` is an :class:`~repro_torch.models.builders.ArchModel`."""
    return tree_from_numpy(model.init(device="meta"), tree, model.device,
                           "parameter")


def lora_from_numpy(model, tree: Tree) -> Tree:
    """The port's LoRA tree from a numpy tree of the JAX package's
    ``lora_init`` output of the same config."""
    return tree_from_numpy(model.lora_init(device="meta"), tree,
                           model.device, "LoRA")
