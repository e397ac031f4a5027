"""Parameter trees and the task-vector layout manifest.

Task vectors live in LoRA parameter trees (nested dicts of tensors);
the MaTU server math is defined over the flattened d-dimensional
vector.  Trees here are nested ``dict`` / ``list`` / ``tuple`` of
tensors, walked in the JAX package's canonical order: dict keys sorted,
sequence entries by index.  So the same tree flattens to the same
vector in both packages, and :class:`TaskVectorSpace` gives it the same
manifest and the same ``fingerprint``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

Tree = Any


def tree_leaves_with_path(tree: Tree, prefix: Tuple[str, ...] = ()
                          ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) pairs in canonical order (sorted dict keys)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_leaves_with_path(tree[key], prefix + (str(key),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += tree_leaves_with_path(sub, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_size(tree: Tree) -> int:
    """Total number of scalar entries across all leaves."""
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def tree_flatten_vector(tree: Tree, dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """All leaves raveled into one 1-D vector of ``dtype``, in canonical
    order (sorted dict keys, the JAX package's leaf order), so
    :func:`tree_unflatten_vector` round-trips it exactly."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype)
    return torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])


def tree_unflatten_vector(vector: torch.Tensor, like: Tree) -> Tree:
    """Inverse of :func:`tree_flatten_vector`: ``like``'s structure, each
    leaf cut from ``vector`` in canonical order and cast to that leaf's
    dtype."""
    out, offset = [], 0
    for leaf in tree_leaves(like):
        n = leaf.numel()
        out.append(vector[offset:offset + n].reshape(leaf.shape)
                   .to(leaf.dtype))
        offset += n
    return tree_like(like, out)


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Σ over leaves of each leaf's fp32 dot product, leaves added in
    canonical order."""
    parts = [torch.sum(x.float() * y.float())
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return sum(parts, torch.zeros((), dtype=torch.float32))


def tree_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_cast(tree: Tree, dtype: torch.dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_like(tree: Tree, leaves) -> Tree:
    """``tree``'s structure holding ``leaves`` (in canonical order, e.g.
    what ``torch.autograd.grad`` returns for ``tree_leaves(tree)``)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


class TaskVectorLayoutError(ValueError):
    """Client/server disagree on the task-vector layout (manifest
    fingerprint mismatch, or a tree that doesn't fit the manifest)."""


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's name, the JAX
    package's manifest spelling)."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class LeafSpec:
    """One manifest row: where a model-space leaf lives on the d-axis."""
    path: str
    shape: Tuple[int, ...]
    dtype: str
    offset: int

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _set_path(root: dict, path: str, value: torch.Tensor) -> None:
    parts = path.split("/") if path else [""]
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


class TaskVectorSpace:
    """Deterministic layout manifest mapping a LoRA parameter tree to
    the flat d-axis: leaves in canonical order, each raveled C-order at
    a contiguous ``[offset, offset + size)`` slice.  ``fingerprint``
    hashes the manifest; two parties that agree on it agree on the
    meaning of every coordinate.  Trees rebuilt by :meth:`template` /
    :meth:`unflatten` are nested dicts keyed by the path parts."""

    def __init__(self, leaves: Tuple[LeafSpec, ...],
                 dtype: torch.dtype = torch.float32):
        self.leaves = tuple(leaves)
        self.dtype = dtype
        self.d = int(sum(l.size for l in self.leaves))
        off = 0
        for leaf in self.leaves:
            if leaf.offset != off:
                raise TaskVectorLayoutError(
                    f"manifest offset for {leaf.path!r} is {leaf.offset}, "
                    f"expected {off} (manifest rows must tile the d-axis)")
            off += leaf.size

    @classmethod
    def from_tree(cls, tree: Tree,
                  dtype: torch.dtype = torch.float32) -> "TaskVectorSpace":
        """Build the manifest from a template tree (canonical order)."""
        specs, off = [], 0
        for path, leaf in tree_leaves_with_path(tree):
            spec = LeafSpec("/".join(path), tuple(int(s) for s in leaf.shape),
                            _dtype_name(leaf.dtype), off)
            specs.append(spec)
            off += spec.size
        return cls(tuple(specs), dtype=dtype)

    def manifest_text(self) -> str:
        """Canonical text form of the manifest (the fingerprint input)."""
        lines = [f"{l.path} shape={l.shape} dtype={l.dtype} offset={l.offset}"
                 for l in self.leaves]
        lines.append(f"d={self.d} wire_dtype={_dtype_name(self.dtype)}")
        return "\n".join(lines)

    @property
    def fingerprint(self) -> str:
        return hashlib.sha256(self.manifest_text().encode()).hexdigest()[:16]

    def require_compatible(self, other, context: str = "") -> None:
        """Abort-before-use check.  ``other`` is a fingerprint string or
        another :class:`TaskVectorSpace`; raises
        :class:`TaskVectorLayoutError` on mismatch."""
        theirs = (other.fingerprint if isinstance(other, TaskVectorSpace)
                  else str(other))
        if theirs != self.fingerprint:
            where = f" ({context})" if context else ""
            raise TaskVectorLayoutError(
                f"task-vector layout mismatch{where}: local manifest "
                f"{self.fingerprint} != peer {theirs}; refusing to "
                f"aggregate vectors whose coordinates may not align")

    def by_path(self, path: str) -> LeafSpec:
        """Manifest row of one leaf path (the serving router slices a
        leaf's coordinates, or its packed mask bits, out of the d-axis)."""
        if not hasattr(self, "_by_path"):
            self._by_path = {l.path: l for l in self.leaves}
        try:
            return self._by_path[path]
        except KeyError:
            raise TaskVectorLayoutError(
                f"no manifest row for leaf path {path!r}") from None

    def template(self, device=None) -> dict:
        """Zeros tree in the manifest's model space."""
        root: dict = {}
        for l in self.leaves:
            _set_path(root, l.path, torch.zeros(
                l.shape, dtype=getattr(torch, l.dtype), device=device))
        return root

    def flatten(self, tree: Tree) -> torch.Tensor:
        """Model-space tree -> flat (d,) vector; checks path and shape of
        every leaf against the manifest."""
        flat = tree_leaves_with_path(tree)
        if len(flat) != len(self.leaves):
            raise TaskVectorLayoutError(
                f"tree has {len(flat)} leaves, manifest has "
                f"{len(self.leaves)}")
        pieces = []
        for (path, leaf), spec in zip(flat, self.leaves):
            if "/".join(path) != spec.path or tuple(leaf.shape) != spec.shape:
                raise TaskVectorLayoutError(
                    f"leaf {'/'.join(path)!r} {tuple(leaf.shape)} does not "
                    f"match manifest row {spec.path!r} {spec.shape}")
            pieces.append(leaf.reshape(-1).to(self.dtype))
        return torch.cat(pieces)

    def unflatten(self, vector: torch.Tensor) -> dict:
        """Flat (>= d,) vector -> model-space tree (coordinates past d
        are ignored)."""
        if int(vector.shape[0]) < self.d:
            raise TaskVectorLayoutError(
                f"vector has {int(vector.shape[0])} coords, manifest "
                f"needs d={self.d}")
        root: dict = {}
        for l in self.leaves:
            _set_path(root, l.path, vector[l.offset:l.offset + l.size]
                      .reshape(l.shape).to(getattr(torch, l.dtype)))
        return root

    def to_json(self) -> str:
        """The manifest as JSON (the JAX package's format, field for
        field)."""
        return json.dumps({
            "version": 1,
            "wire_dtype": _dtype_name(self.dtype),
            "d": self.d,
            "fingerprint": self.fingerprint,
            "leaves": [{"path": l.path, "shape": list(l.shape),
                        "dtype": l.dtype, "offset": l.offset}
                       for l in self.leaves],
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "TaskVectorSpace":
        """Rebuild a manifest from :meth:`to_json` text; raises if the
        stored fingerprint does not match the rebuilt one."""
        obj = json.loads(text)
        specs = tuple(LeafSpec(e["path"], tuple(e["shape"]), e["dtype"],
                               int(e["offset"])) for e in obj["leaves"])
        space = cls(specs, dtype=getattr(torch, obj["wire_dtype"]))
        if obj.get("fingerprint") and obj["fingerprint"] != space.fingerprint:
            raise TaskVectorLayoutError(
                f"serialized fingerprint {obj['fingerprint']} does not "
                f"match rebuilt manifest {space.fingerprint}")
        return space

    def __repr__(self) -> str:
        return (f"TaskVectorSpace(d={self.d}, leaves={len(self.leaves)}, "
                f"fingerprint={self.fingerprint})")


def pad_vector(vector: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-pad a flat vector up to a common d (identity when equal)."""
    n = int(vector.shape[0])
    if n == d:
        return vector
    if n > d:
        raise TaskVectorLayoutError(f"vector ({n}) longer than target d ({d})")
    return torch.nn.functional.pad(vector, (0, d - n))
