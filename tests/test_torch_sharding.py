"""The port's logical-axis rules and mesh helpers against the JAX
package's (``repro.nn.sharding``, ``repro.launch.mesh``,
``repro.core.engine.pad_d_for_shards``), on the CPU, in one process.

The rule functions read only a mesh's dim names and sizes, so stand-in
meshes serve: a ``.shape`` dict for JAX's functions, ``mesh_dim_names``
+ ``.shape`` tuple + ``get_coordinate()`` for the port's (the fields of
a ``torch.distributed.device_mesh.DeviceMesh`` they read).  The real
meshes, on 8 gloo ranks, are ``tests/test_torch_sharded_engine.py``'s.
"""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import pad_d_for_shards as j_pad_d  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.nn import sharding as jsh  # noqa: E402
from repro_torch.core.engine import pad_d_for_shards  # noqa: E402
from repro_torch.kernels.ref import LAMBDA_BLOCK  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.nn import sharding as tsh  # noqa: E402


class JaxMesh:
    """What JAX's rule functions read of a Mesh: ``shape`` (name -> size)."""

    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))


class TorchMesh:
    """What the port's rule functions read of a DeviceMesh."""

    def __init__(self, names, sizes, coord=None):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(sizes)
        self._coord = coord

    def get_coordinate(self):
        return self._coord


MESHES = {
    "round8": (("data",), (8,)),
    "debug4x2": (("data", "model"), (4, 2)),
    "debug2x2": (("data", "model"), (2, 2)),
    "pop_s2": (("slots", "data"), (2, 4)),
    "pod": (("pod", "data", "model"), (2, 4, 4)),
    "model_only": (("model",), (4,)),
}


def both(name):
    names, sizes = MESHES[name]
    return JaxMesh(names, sizes), TorchMesh(names, sizes)


def test_default_rules_equal_jax():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES


LOGICAL = [None, ("batch", "embed"), ("embed", "mlp"), ("heads", None),
           ("taskvec",), (None, "taskvec"), ("fed_slots", "taskvec"),
           ("cache_seq", "kv_heads", "head_dim"), ("vocab", "embed"),
           ("experts", "expert_embed", "moe_mlp"), ("batch", "act_seq"),
           ("mlp", "heads"), ("unknown", "layers")]
SHAPES = [None, (8, 12), (6, 10), (16, 16), (3, 5, 7), (32, 2, 64)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_spec_matches_jax(mesh):
    jm, tm = both(mesh)
    for logical, shape in itertools.product(LOGICAL, SHAPES):
        if shape is not None and logical is not None \
                and len(shape) != len(logical):
            continue
        want = tuple(jsh.resolve_spec(logical, shape, mesh=jm))
        assert tsh.resolve_spec(logical, shape, mesh=tm) == want, (logical,
                                                                   shape)


def test_resolve_spec_rules_and_context():
    jm, tm = both("debug4x2")
    rules = dict(jsh.DEFAULT_RULES, embed="model", heads=None)
    for logical in LOGICAL:
        assert tsh.resolve_spec(logical, mesh=tm, rules=rules) == tuple(
            jsh.resolve_spec(logical, mesh=jm, rules=rules))
    assert tsh.current_mesh() is None
    assert tsh.resolve_spec(("embed", "mlp")) == ()
    with tsh.mesh_context(tm, {"embed": "data"}) as ctx:
        assert tsh.current_mesh() is tm and ctx.rules["embed"] == "data"
        assert tsh.resolve_spec(("embed", "mlp")) == ("data", "model")
        assert tsh.taskvec_axes() == ("data", "model")
    assert tsh.current_mesh() is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_taskvec_and_slot_axes_match_jax(mesh):
    jm, tm = both(mesh)
    assert tsh.taskvec_axes(tm) == jsh.taskvec_axes(jm)
    assert tsh.taskvec_shards(tm) == jsh.taskvec_shards(jm)
    assert tsh.slot_axes(tm) == jsh.slot_axes(jm)
    assert tsh.slot_shards(tm) == jsh.slot_shards(jm)
    assert tsh.taskvec_axes(None) == () and tsh.taskvec_shards(None) == 1
    assert tsh.slot_shards(None) == 1


@pytest.mark.parametrize("mesh", ("round8", "debug4x2", "pop_s2"))
@pytest.mark.parametrize("ndim", (2, 3))
def test_taskvec_sharding_placements_and_shard(mesh, ndim):
    """Shard(ndim-1) on the taskvec dims, Replicate elsewhere; the shard
    index major→minor over the taskvec axes, as JAX's ``_shard_offset``
    and the last-axis layout of its ``taskvec_sharding`` spec."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = MESHES[mesh]
    jm = JaxMesh(names, sizes)
    axes = jsh.taskvec_axes(jm)
    spec = tuple(jsh.resolve_spec((None,) * (ndim - 1) + ("taskvec",),
                                  mesh=jm))
    assert spec[-1] == (axes[0] if len(axes) == 1 else axes)
    seen = set()
    for coord in itertools.product(*(range(s) for s in sizes)):
        pl, shard = tsh.taskvec_sharding(TorchMesh(names, sizes, coord),
                                         ndim)
        assert pl == tuple(Shard(ndim - 1) if n in axes else Replicate()
                           for n in names)
        want = 0
        for a in axes:
            want = want * jm.shape[a] + coord[names.index(a)]
        assert shard == want
        seen.add(shard)
    assert seen == set(range(jsh.taskvec_shards(jm)))


def test_pad_d_for_shards_matches_jax():
    """The JAX package's padding grid: each shard a power-of-two number of
    whole 256-coordinate blocks; identity unsharded."""
    for d in (1, 31, 300, 1000, 4096, 1 << 20, (1 << 20) + 5, 1_327_140):
        for shards in (1, 2, 3, 4, 8, 256, 512):
            dp = pad_d_for_shards(d, shards)
            assert dp == j_pad_d(d, shards), (d, shards)
            if shards > 1:
                per = dp // shards
                assert per * shards == dp and per % LAMBDA_BLOCK == 0
                blocks = per // LAMBDA_BLOCK
                assert blocks & (blocks - 1) == 0
    assert pad_d_for_shards(1000, 1) == 1000
    assert pad_d_for_shards(1_327_140, 4) == 2_097_152


def test_arch_rules_match_jax():
    class Cfg:
        def __init__(self, kv, mla=False):
            self.n_kv_heads, self.use_mla = kv, mla
    for mesh in ("debug4x2", "debug2x2", "round8", "model_only"):
        jm, tm = both(mesh)
        for cfg in (Cfg(2), Cfg(4), Cfg(8), Cfg(3), Cfg(4, mla=True),
                    Cfg(0)):
            assert tmesh.arch_rules(cfg, tm) == jmesh.arch_rules(cfg, jm)


def test_mesh_functions_need_a_process_group():
    """Without an initialised default group every mesh function raises (the
    package initialises none and picks no backend)."""
    for build in (lambda: tmesh.make_round_mesh(2, device_type="cpu"),
                  lambda: tmesh.make_debug_mesh((2, 2), device_type="cpu"),
                  lambda: tmesh.make_population_mesh(2, device_type="cpu")):
        with pytest.raises(RuntimeError, match="init_process_group"):
            build()


def test_collective_counts_reset():
    tsh.reset_collective_counts()
    assert tsh.collective_counts() == {"psum": 0, "gather": 0}
    assert tsh.taskvec_layout(None) is None
