"""Device meshes for the sharded round and the model-parallel step (the
twin of ``repro.launch.mesh``, without its TPU pod meshes), and the
placements of a sharded train step's batch and optimizer state (the
twins of ``repro.launch.dryrun``'s ``batch_shardings`` and
``opt_state_shardings``).

A "device" of the JAX package is a rank of the default process group
here: each mesh is an ``init_device_mesh`` over the first ranks of the
group the caller initialised.  The caller picks the backend (gloo for
CPU ranks or for several ranks sharing one card, NCCL where each rank
owns a card) and the device type (``device_type``, ``"cuda"`` unless
the caller asks for ``"cpu"``); nothing here chooses either.  Every
mesh is made by one helper, which gives gloo ranks on CUDA tensors
:func:`route_all_gather`.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.nn.sharding import (mesh_axis_sizes, resolve_spec,
                                     spec_placements)

_ROUTED_KEYS = set()


def route_all_gather(dispatch_key: str = "CUDA") -> None:
    """Route the functional all-gather on ``dispatch_key`` tensors -- the
    ``_c10d_functional`` op behind DTensor's ``Shard -> Replicate`` moves
    -- through ``torch.distributed.all_gather_into_tensor`` on the same
    process group.  gloo ranks that share one card need it: there the
    functional op (and its coalesced form) ends the process
    (SIGSEGV, torch 2.11), while ``all_gather_into_tensor`` and every
    other collective DTensor issues run.  The gather is the same one:
    rank order, the bytes unchanged.  Idempotent."""
    if dispatch_key in _ROUTED_KEYS:
        return
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(t, group_size, group_name):
        out = t.new_empty((group_size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    def gather_coalesced(ts, group_size, group_name):
        return [gather(t, group_size, group_name) for t in ts]

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, dispatch_key)
    lib.impl("all_gather_into_tensor_coalesced", gather_coalesced,
             dispatch_key)
    _ROUTED_KEYS.add(dispatch_key)
    _LIBS.append(lib)


_LIBS = []


def _devices(n: Optional[int], what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: initialise the default process group "
                           f"first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = n or world
    if n > world:
        raise ValueError(f"{what}: {n} devices requested, {world} available")
    return n


def _mesh(device_type: str, shape: Sequence[int], axes: Sequence[str]):
    """The named mesh over the first ranks of the default group; gloo on
    CUDA tensors gets :func:`route_all_gather` first."""
    if device_type == "cuda" and dist.get_backend() == "gloo":
        route_all_gather("CUDA")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_debug_mesh(shape: Sequence[int] = (2, 2),
                    axes: Sequence[str] = ("data", "model"), *,
                    device_type: str = "cuda"):
    """A small named mesh for CI-scale sharding tests."""
    _devices(math.prod(shape), "make_debug_mesh")
    return _mesh(device_type, shape, axes)


def make_round_mesh(n_devices: Optional[int] = None, *,
                    device_type: str = "cuda"):
    """1-D ("data",) mesh over the first ``n_devices`` ranks for the
    taskvec-sharded round: the "taskvec" rule maps onto ("pod", "data",
    "model"), so here d splits ``n_devices`` ways."""
    n = _devices(n_devices, "make_round_mesh")
    return _mesh(device_type, (n,), ("data",))


def make_population_mesh(slots: int = 2, n_devices: Optional[int] = None, *,
                         device_type: str = "cuda"):
    """2-D ("slots", "data") mesh for the chunked population round: the
    "slots" axis shards a chunk's slot rows in the downlink phase and
    "data" carries the taskvec d-sharding.  ``slots`` must divide the
    device count."""
    n = _devices(n_devices, "make_population_mesh")
    if slots < 1 or n % slots != 0:
        raise ValueError(f"make_population_mesh: slots={slots} must divide "
                         f"the device count {n}")
    return _mesh(device_type, (slots, n // slots), ("slots", "data"))


def arch_rules(cfg, mesh) -> Mapping[str, object]:
    """Per-arch logical-axis rule overrides: kv_heads shard over
    ``model`` only when the head count divides the axis (and the arch is
    not MLA); otherwise KV stays replicated."""
    n_model = mesh_axis_sizes(mesh).get("model", 1)
    rules = {}
    if cfg.n_kv_heads and cfg.n_kv_heads % n_model == 0 and not cfg.use_mla:
        rules["kv_heads"] = "model"
    return rules


def batch_shardings(batch, mesh):
    """The placements of a batch tree: a leaf whose leading dim is more
    than 1 splits it by the ``"batch"`` rule (where it divides), every
    other leaf is replicated.  ``batch`` holds tensors (``meta`` ones
    serve) or shapes."""
    def one(leaf):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        axes = ((("batch",) + (None,) * (len(shape) - 1))
                if shape and shape[0] > 1 else (None,) * len(shape))
        return spec_placements(resolve_spec(axes, shape, mesh=mesh), mesh,
                               len(shape))
    return {k: (batch_shardings(v, mesh) if isinstance(v, dict) else one(v))
            for k, v in batch.items()}


def opt_state_shardings(opt_state, lora_sh, mesh):
    """The placements of an AdamW state: ``mu`` and ``nu`` take the LoRA
    tree's (``lora_sh``); the step, a Python int here, stays as it is on
    every rank (the reference replicates its scalar).  ``mesh`` is
    the reference's argument, kept for its signature and not read."""
    del mesh
    return {"step": None, "mu": lora_sh, "nu": lora_sh}
