"""Logical-axis sharding rules and the taskvec layout of the sharded round.

The twin of ``repro.nn.sharding``.  Every tensor axis is named by a
*logical* axis (``"taskvec"``, ``"fed_slots"``, ``"heads"``, …); a set
of *rules* maps each logical axis to zero or more mesh axes.  A mesh
here is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``repro_torch.launch.mesh`` builds them); every rule lookup reads only
its dim names and sizes.

JAX runs one program over every device (``shard_map``); torch runs one
process per rank, each on its own d-slice.  So where the JAX package's
round body sees ``lax.axis_index`` and ``lax.psum``, a rank of the port
sees :class:`TaskvecLayout` (its shard index and the process group of
the ranks that share its slot rows) and :func:`psum`.  Every reduction
of the package goes through :func:`psum` and every wire-boundary gather
through :func:`gather`; both count their calls
(:func:`collective_counts`), as ``kernels.ops.launch_counts`` counts
kernel launches, so that tests and ``chip_smoke.py`` can hold a round to
its collective budget.

The model half is DTensor's: :func:`logical_to_sharding` turns a tree of
logical axes into DTensor placements (one a mesh dim) leaf for leaf,
:func:`distribute_tree` places a tree's tensors by them, and
:func:`constrain` redistributes an activation under the active
:class:`mesh_context`, JAX's ``with_sharding_constraint`` hint made a
move.  Outside a mesh, or on a plain tensor, :func:`constrain` returns
its input, so model code is written once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LogicalAxes = Optional[Tuple[Optional[str], ...]]

# The JAX package's rules, unchanged.  ``None`` = replicate.
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("pod", "data")),
    ("fed_clients", ("pod", "data")),
    # the chunked round's slot rows: only population meshes have "slots"
    ("fed_slots", ("slots",)),
    ("act_seq", "model"),
    ("cache_seq", ("data", "model")),
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", None),
    ("head_dim", None),
    ("mlp", "model"),
    ("moe_mlp", "model"),
    ("experts", "model"),
    ("expert_embed", "data"),
    ("vocab", "model"),
    ("state", None),
    ("conv", None),
    ("lora", None),
    ("layers", None),
    ("taskvec", ("pod", "data", "model")),  # flattened-d MaTU server math
    ("tasks", None),
)


class _Ctx:
    """The active (mesh, rules): process-wide, where the JAX package's
    is a thread's, because autograd replays a rematerialised forward on
    its own device thread, which must see the mesh of the step."""

    def __init__(self):
        self.mesh = None
        self.rules: Mapping[str, Any] = dict(DEFAULT_RULES)


_CTX = _Ctx()


class mesh_context:
    """Context manager installing (mesh, rules) for logical sharding.
    Inside it a plain tensor that meets a DTensor in an op is taken as
    replicated (``implicit_replication``), as JAX takes an array with no
    sharding under a mesh."""

    def __init__(self, mesh, rules: Optional[Mapping[str, Any]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self._prev = None
        self._implicit = None

    def __enter__(self):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        self._prev = (_CTX.mesh, _CTX.rules)
        _CTX.mesh, _CTX.rules = self.mesh, self.rules
        self._implicit = implicit_replication()
        self._implicit.__enter__()
        return self

    def __exit__(self, *exc):
        self._implicit.__exit__(*exc)
        _CTX.mesh, _CTX.rules = self._prev
        return False


def current_mesh():
    return _CTX.mesh


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Dim name -> size of a mesh with named dims (JAX's ``mesh.shape``)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def _mapped(rules: Mapping[str, Any], logical: str,
            sizes: Mapping[str, int]) -> Tuple[str, ...]:
    mapped = rules.get(logical)
    if mapped is None:
        return ()
    if isinstance(mapped, str):
        mapped = (mapped,)
    return tuple(a for a in mapped if a in sizes)


def resolve_spec(logical: LogicalAxes, shape: Optional[Sequence[int]] = None,
                 *, mesh=None, rules: Optional[Mapping[str, Any]] = None
                 ) -> Tuple[Any, ...]:
    """Map logical axis names to a partition spec under the active rules:
    one entry a tensor dim, None (replicated), a mesh axis name or a
    tuple of them, trailing Nones dropped (the entries of the JAX
    package's ``PartitionSpec``).  A mesh axis serves one tensor dim at
    most; with ``shape``, a mapping that does not divide the dim falls
    back to the longest dividing prefix of its axes, else replicates."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if logical is None or mesh is None:
        return ()
    sizes = mesh_axis_sizes(mesh)
    spec, used = [], set()
    for i, name in enumerate(logical):
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            spec.append(None)
            continue
        candidates = ((mesh_axes,) if isinstance(mesh_axes, str)
                      else tuple(mesh_axes))
        candidates = tuple(a for a in candidates
                           if a in sizes and a not in used)
        if not candidates:
            spec.append(None)
            continue
        size = math.prod(sizes[a] for a in candidates)
        if shape is not None and shape[i] % size != 0:
            ok = None
            for j in range(len(candidates) - 1, 0, -1):
                sub = candidates[:j]
                if shape[i] % math.prod(sizes[a] for a in sub) == 0:
                    ok = sub
                    break
            if ok is None:
                spec.append(None)
                continue
            candidates = ok
        used.update(candidates)
        spec.append(candidates[0] if len(candidates) == 1
                    else tuple(candidates))
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def spec_placements(spec: Sequence[Any], mesh, ndim: int):
    """The DTensor placements (one a mesh dim) of a partition spec of an
    ``ndim``-rank tensor: ``Shard(i)`` on every mesh dim that entry i
    names, ``Replicate()`` on the rest.  A tensor dim split over several
    mesh dims is split major→minor in mesh-dim order, as DTensor lays
    it out; a spec naming them in another order has no DTensor twin and
    raises.  A mesh dim of size 1 splits nothing and stays
    ``Replicate()``: the same layout, and one DTensor's view rules take
    where a size-1 ``Shard`` beside a split dim fails."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = [int(v) for v in mesh.shape]
    out = [Replicate()] * len(names)
    for i, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} must follow the mesh's dim "
                             f"order {tuple(names)}")
        for j in idx:
            if sizes[j] > 1:
                out[j] = Shard(i)
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    return x is None or isinstance(x, tuple)


def _map_axes(fn, axes_tree, *rest):
    """``fn(axes, *rest_leaves)`` over a logical-axes tree (its leaves
    are tuples or None) and trees of its structure."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *rest)
    return {k: _map_axes(fn, v, *(r[k] for r in rest))
            for k, v in axes_tree.items()}


def logical_to_sharding(axes_tree, shapes_tree=None, *, mesh=None,
                        rules: Optional[Mapping[str, Any]] = None):
    """The DTensor placements of every leaf of a logical-axes tree, as a
    tree of its structure: ``resolve_spec``'s spec of each leaf (with
    its shape from ``shapes_tree`` -- tensors, ``meta`` tensors or
    shapes -- when given) made placements by :func:`spec_placements`.
    Without ``shapes_tree`` a leaf's rank is its axes' length."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("logical_to_sharding requires an active "
                         "mesh_context or explicit mesh")

    def one(axes, shape=None):
        if shape is not None and hasattr(shape, "shape"):
            shape = tuple(shape.shape)
        ndim = len(shape) if shape is not None else len(axes or ())
        return spec_placements(resolve_spec(axes, shape, mesh=mesh,
                                            rules=rules), mesh, ndim)

    if shapes_tree is None:
        return _map_axes(one, axes_tree)
    return _map_axes(one, axes_tree, shapes_tree)


def distribute_tree(tree, shardings, mesh):
    """Every tensor leaf of ``tree`` made a ``DTensor`` on ``mesh`` with
    its placements from ``shardings`` (a tree of the same structure, as
    :func:`logical_to_sharding` returns), by ``distribute_tensor``: each
    rank keeps its own block of the leaf it holds, which must be the
    same on every rank.  Non-tensor leaves pass through."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k], mesh)
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, list(shardings))


def constrain(x, logical: LogicalAxes):
    """``x`` redistributed to the placements of ``logical`` under the
    active mesh (JAX's ``with_sharding_constraint``); ``x`` itself
    outside a mesh or when ``x`` is not a ``DTensor``."""
    mesh = _CTX.mesh
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(logical, tuple(x.shape), mesh=mesh)
    placements = spec_placements(spec, mesh, x.dim())
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def split_last(x, n: int):
    """x (..., n·k) reshaped to (..., n, k).  A DTensor whose last dim is
    split over a mesh dim that does not divide ``n`` is made whole on
    that mesh dim first: GSPMD pads such a split, DTensor refuses it."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        last = x.dim() - 1
        sizes = [int(v) for v in x.device_mesh.shape]
        pl = tuple(Replicate() if p.is_shard(last) and n % sizes[i] else p
                   for i, p in enumerate(x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def flat_ready(x):
    """``x`` with its middle dims (all but the first and the last) whole
    on every rank, for an op that folds the leading dims into one (a
    matmul of a (B, S, d) DTensor): DTensor folds dims only while no
    dim after the first of them is split.  A plain tensor, or one whose
    middle dims are whole, is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or x.dim() < 3:
        return x
    last = x.dim() - 1
    pl = tuple(Replicate() if p.is_shard() and 0 < p.dim < last else p
               for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def replicated(x, mesh):
    """A DTensor replicated on ``mesh`` holding ``x``, the same on every
    rank (no collective); a DTensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def to_block(x, mesh, placements, grad_placements=None):
    """This rank's block of ``x`` (a plain ``x`` taken as replicated)
    placed by ``placements``, its gradient declared as
    ``grad_placements`` (the same by default): where the rank's local
    gradient lies, e.g. ``Partial()`` over a mesh dim whose ranks each
    hold part of a sum."""
    pl = tuple(placements)
    return replicated(x, mesh).redistribute(mesh, pl).to_local(
        grad_placements=tuple(grad_placements or pl))


def from_block(t, mesh, placements, shape):
    """The DTensor of global ``shape`` whose blocks, placed by
    ``placements``, are each rank's ``t``."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, mesh, tuple(placements), shape=tuple(shape),
                              stride=stride)


# -- taskvec axis (the sharded round engine) --------------------------------

def taskvec_axes(mesh=None, *, rules: Optional[Mapping[str, Any]] = None
                 ) -> Tuple[str, ...]:
    """Mesh axes the ``taskvec`` logical axis shards over, major→minor
    (only axes present in the mesh).  Empty tuple = replicated."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return ()
    return _mapped(rules or _CTX.rules, "taskvec", mesh_axis_sizes(mesh))


def taskvec_shards(mesh=None, *,
                   rules: Optional[Mapping[str, Any]] = None) -> int:
    """Number of d-axis shards the taskvec rule yields on this mesh."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in taskvec_axes(mesh, rules=rules))


def slot_axes(mesh=None, *, rules: Optional[Mapping[str, Any]] = None
              ) -> Tuple[str, ...]:
    """Mesh axes the ``fed_slots`` logical axis (the chunked round's
    client/slot rows) shards over: empty on every mesh without a
    "slots" axis."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return ()
    return _mapped(rules or _CTX.rules, "fed_slots", mesh_axis_sizes(mesh))


def slot_shards(mesh=None, *,
                rules: Optional[Mapping[str, Any]] = None) -> int:
    """Number of client/slot-row shards the fed_slots rule yields."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in slot_axes(mesh, rules=rules))


def _flat_index(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's index over ``axes``, major→minor (JAX's
    ``_shard_offset``)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    sizes = mesh_axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + int(coord[names.index(a)])
    return idx


def taskvec_sharding(mesh, ndim: int, *,
                     rules: Optional[Mapping[str, Any]] = None):
    """The layout of every d-axis tensor of the sharded round: an
    ``ndim``-rank tensor with its LAST axis split over the taskvec mesh
    axes, the other axes replicated.  Returns (placements, shard): the
    DTensor placements, one a mesh dim (``Shard(ndim - 1)`` on the
    taskvec dims, ``Replicate()`` elsewhere), and this rank's shard
    index, major→minor over the taskvec axes — the contiguous d-slice
    ``[shard · d_pad / n, (shard + 1) · d_pad / n)`` it holds."""
    axes = taskvec_axes(mesh, rules=rules)
    spec = [None] * (ndim - 1) + [axes if axes else None]
    return spec_placements(spec, mesh, ndim), _flat_index(mesh, axes)


# -- counted collectives ----------------------------------------------------

_COUNTS = {"psum": 0, "gather": 0}


def collective_counts() -> Dict[str, int]:
    """Calls of :func:`psum` and :func:`gather` since the last reset, in
    this process."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum of ``x`` over ``group``, in place; returns ``x``.
    Integer tensors sum exactly; the λ roots ride fp32 columns with one
    nonzero contributor each, exact too (``kernels.ref._lam_totals``)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _COUNTS["psum"] += 1
    return x


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim`` in
    group-rank order (the wire-boundary gather).  The bytes travel as
    uint8, a dtype every backend takes, on ``x``'s own device."""
    n = dist.get_world_size(group)
    xb = x.contiguous().view(torch.uint8)
    parts = [torch.empty_like(xb) for _ in range(n)]
    dist.all_gather(parts, xb, group=group)
    _COUNTS["gather"] += 1
    return torch.cat(parts, dim=dim).view(x.dtype)


@dataclass(frozen=True)
class TaskvecLayout:
    """What one rank needs to run its part of the sharded round.

    ``shard`` (of ``n_shards``) is this rank's d-slice, major→minor over
    ``axes`` (sizes ``axis_sizes``); ``group`` holds the ranks that share
    this rank's other mesh coordinates, in shard order (group rank =
    shard), and carries the round's psums; None when ``n_shards`` is 1.
    ``row`` (of ``row_shards``) is this rank's slice of the chunked
    round's slot rows over the ``fed_slots`` axes, and ``row_group`` the
    ranks that share everything but those coordinates (None when
    ``row_shards`` is 1)."""
    axes: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    n_shards: int
    shard: int
    group: Any
    row_shards: int
    row: int
    row_group: Any


def _axis_groups(mesh, axes: Tuple[str, ...]):
    """One process group for each set of ranks that differ only in their
    ``axes`` coordinates, created on every rank (``new_group`` is
    collective over the default group); returns this rank's.  Each
    group's ranks, in major→minor order over ``axes``, must ascend, so
    that group rank = flat index over ``axes``."""
    if not axes:
        return None
    names = list(mesh.mesh_dim_names)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx):
        raise ValueError(f"axes {axes} must follow the mesh's dim order "
                         f"{tuple(names)}")
    other = [i for i in range(len(names)) if i not in idx]
    ranks = mesh.mesh.permute(other + idx).reshape(
        -1, math.prod(int(mesh.mesh.shape[i]) for i in idx))
    me, mine = dist.get_rank(), None
    for row in ranks.tolist():
        if row != sorted(row):
            raise ValueError(f"mesh ranks {row} along {axes} do not ascend")
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


_LAYOUTS: Dict[tuple, tuple] = {}


def taskvec_layout(mesh, *, rules: Optional[Mapping[str, Any]] = None
                   ) -> Optional[TaskvecLayout]:
    """This rank's :class:`TaskvecLayout` on ``mesh`` (None without a
    mesh).  The process groups are made once a mesh (every rank of the
    default group must make the same calls in the same order) and kept
    for the life of the process."""
    if mesh is None:
        return None
    rules = dict(rules or _CTX.rules)
    key = (id(mesh), tuple(sorted((k, str(v)) for k, v in rules.items())))
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    sizes = mesh_axis_sizes(mesh)
    axes = taskvec_axes(mesh, rules=rules)
    rows = slot_axes(mesh, rules=rules)
    axis_sizes = tuple(sizes[a] for a in axes)
    n_shards = math.prod(axis_sizes)
    row_shards = math.prod(sizes[a] for a in rows)
    group = _axis_groups(mesh, axes) if n_shards > 1 else None
    row_group = _axis_groups(mesh, rows) if row_shards > 1 else None
    layout = TaskvecLayout(axes, axis_sizes, n_shards,
                           _flat_index(mesh, axes), group, row_shards,
                           _flat_index(mesh, rows), row_group)
    _LAYOUTS[key] = (mesh, layout)
    return layout
