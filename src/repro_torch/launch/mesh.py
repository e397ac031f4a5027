"""Device meshes for the taskvec-sharded round (the twin of
``repro.launch.mesh``, without its TPU pod meshes).

A "device" of the JAX package is a rank of the default process group
here: each mesh is an ``init_device_mesh`` over the first ranks of the
group the caller initialised.  The caller picks the backend (gloo for
CPU ranks or for several ranks sharing one card, NCCL where each rank
owns a card) and the device type (``device_type``, ``"cuda"`` unless
the caller asks for ``"cpu"``); nothing here chooses either.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.nn.sharding import mesh_axis_sizes


def _devices(n: Optional[int], what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: initialise the default process group "
                           f"first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = n or world
    if n > world:
        raise ValueError(f"{what}: {n} devices requested, {world} available")
    return n


def make_debug_mesh(shape: Sequence[int] = (2, 2),
                    axes: Sequence[str] = ("data", "model"), *,
                    device_type: str = "cuda"):
    """A small named mesh for CI-scale sharding tests."""
    _devices(math.prod(shape), "make_debug_mesh")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_round_mesh(n_devices: Optional[int] = None, *,
                    device_type: str = "cuda"):
    """1-D ("data",) mesh over the first ``n_devices`` ranks for the
    taskvec-sharded round: the "taskvec" rule maps onto ("pod", "data",
    "model"), so here d splits ``n_devices`` ways."""
    n = _devices(n_devices, "make_round_mesh")
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


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
    return init_device_mesh(device_type, (slots, n // slots),
                            mesh_dim_names=("slots", "data"))


def arch_rules(cfg, mesh) -> Mapping[str, object]:
    """Per-arch logical-axis rule overrides: kv_heads shard over
    ``model`` only when the head count divides the axis (and the arch is
    not MLA); otherwise KV stays replicated."""
    n_model = mesh_axis_sizes(mesh).get("model", 1)
    rules = {}
    if cfg.n_kv_heads and cfg.n_kv_heads % n_model == 0 and not cfg.use_mla:
        rules["kv_heads"] = "model"
    return rules
