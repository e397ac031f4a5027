"""Round-resumable checkpointing: trees → ``.npz`` + ``.json`` manifest,
in the JAX package's format (``ckpt/checkpoint.py``), so a file that
either package writes loads in the other.

Arrays are stored flat in one ``.npz`` under their tree paths (keys
joined by "/", sequence entries by index); the manifest records the
tree structure (as the reference's ``PyTreeDef`` text), each array's
dtype and shape, and user metadata (round number, strategy, config
digest).

bf16 leaves: the reference stores a bf16 leaf as numpy's 2-byte void
array (its bfloat16 bits, dtype "bfloat16" in the manifest), which this
``load`` decodes bit for bit, but which the reference's own ``load``
cannot cast back.  So this ``save`` stores a bf16 leaf as its fp32
values (dtype "float32" in the manifest), which both packages load
back exactly into a bf16 leaf: for a tree with bf16 leaves the two
packages' files differ in those leaves' bytes and manifest dtypes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves_with_path, tree_like

Tree = Any
SEP = "/"


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A stored array as a tensor; the reference's bf16 leaves (2-byte
    void arrays of bfloat16 bits) as bf16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flatten_with_paths(tree: Tree) -> Dict[str, np.ndarray]:
    return {SEP.join(path): _to_numpy(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


def treedef_text(tree: Tree) -> str:
    """The reference's ``str(jax.tree_util.tree_structure(tree))`` for a
    tree of dicts, lists and tuples."""
    def text(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {text(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(text(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(text(x) for x in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "None" if t is None else "*"
    return f"PyTreeDef({text(tree)})"


def save(path: str, tree: Tree, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten_with_paths(tree)
    np.savez(path + ".npz", **flat)
    manifest = {
        "treedef": treedef_text(tree),
        "keys": sorted(flat.keys()),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)


def load(path: str, like: Tree) -> Tuple[Tree, dict]:
    """Restore into the structure of ``like`` (shape-checked), each leaf
    in the dtype and on the device of ``like``'s."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    with np.load(path + ".npz") as data:
        paths = tree_leaves_with_path(like)
        missing = {SEP.join(p) for p, _ in paths} - set(data.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: "
                             f"{sorted(missing)[:5]} ...")
        out = []
        for path_keys, leaf in paths:
            key = SEP.join(path_keys)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            out.append(_from_numpy(arr, manifest["dtypes"].get(key)).to(
                dtype=leaf.dtype, device=leaf.device))
    return tree_like(like, out), manifest["metadata"]
