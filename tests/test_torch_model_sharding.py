"""The port's model half of distribution against the JAX package's, on the
CPU in one process: every parameter, LoRA and cache leaf's placement,
``input_specs``, the batch and optimizer-state placements, and the
serving-step factories.

The rule functions read only a mesh's dim names and sizes, so stand-in
meshes serve (``tests/test_torch_sharding.py``'s): for every arch of
``ARCH_IDS`` and ViT-B/32, at full and reduced size, on the (2, 2),
(1, 4), (4, 2) and (1, 3) meshes with ``arch_rules``, the port's
``resolve_spec`` of each leaf of ``axes`` / ``lora_axes`` /
``cache_axes`` (shapes from ``meta`` tensors) equals JAX's (shapes from
``jax.eval_shape``) leaf for leaf, and ``logical_to_sharding``'s DTensor
placements are that spec's.  The models are built inside each package's
``mesh_context``, as the MoE's axes depend on the mesh.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import vit_b32 as j_vit  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.nn import sharding as jsh  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import vit_b32 as t_vit  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.nn import sharding as tsh  # noqa: E402
from repro_torch.train import trainer as ttrain  # noqa: E402
from test_torch_sharding import JaxMesh, TorchMesh  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

MESHES = ((2, 2), (1, 4), (4, 2), (1, 3))
ARCHS = list(jbase.ARCH_IDS) + ["vit_b32"]
CACHE_B, CACHE_LEN = 4, 64


def meshes(shape):
    names = ("data", "model")
    return JaxMesh(names, shape), TorchMesh(names, shape)


def leaves(tree, prefix=()):
    """{path: leaf} of a nested dict whose leaves are axes tuples / None,
    arrays or shapes; empty dicts have no leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def configs(arch, size):
    if arch == "vit_b32":
        return ((j_vit.CONFIG, t_vit.CONFIG) if size == "full"
                else (j_vit.reduced_vit(), t_vit.reduced_vit()))
    j, t = jbase.load_arch(arch), tbase.load_arch(arch)
    return (j, t) if size == "full" else (j.reduced(), t.reduced())


def rules(cfg, jm, tm):
    if not hasattr(cfg, "n_kv_heads"):      # the ViT's config
        return {}, {}
    return jmesh.arch_rules(cfg, jm), tmesh.arch_rules(cfg, tm)


@functools.lru_cache(maxsize=None)
def jax_shapes(arch, size):
    """JAX's (params, lora, cache) shape trees, no allocation."""
    jcfg, _ = configs(arch, size)
    if arch == "vit_b32":
        model = j_vit.build(jcfg)
        key = jax.random.PRNGKey(0)
        return (jax.eval_shape(model.init, key),
                jax.eval_shape(lambda k: model.lora_init(k, jcfg.lora_rank),
                               key), None)
    model = jcfg.build(jbase.SHAPES["train_4k"])
    key = jax.random.PRNGKey(0)
    return (jax.eval_shape(model.init, key),
            jax.eval_shape(model.lora_init, key),
            jax.eval_shape(lambda: model.init_cache(CACHE_B, CACHE_LEN)))


def port_trees(arch, size, tm, rules_t):
    """The port's (axes, lora_axes, cache_axes) and meta shape trees,
    built under its mesh_context."""
    _, tcfg = configs(arch, size)
    with tsh.mesh_context(tm, rules_t):
        if arch == "vit_b32":
            model = t_vit.build(tcfg, device="meta")
            return ((model.axes(), model.init(device="meta")),
                    (model.lora_axes(),
                     model.lora_init(0, tcfg.lora_rank, device="meta")),
                    None)
        model = tcfg.build(tbase.SHAPES["train_4k"], device="meta")
        return ((model.axes(), model.init(device="meta")),
                (model.lora_axes(), model.lora_init(device="meta")),
                (model.cache_axes(),
                 model.init_cache(CACHE_B, CACHE_LEN)))


def jax_axes(arch, size, jm, rules_j):
    jcfg, _ = configs(arch, size)
    with jsh.mesh_context(jm, rules_j):
        if arch == "vit_b32":
            model = j_vit.build(jcfg)
            return model.axes(), model.lora_axes(), None
        model = jcfg.build(jbase.SHAPES["train_4k"])
        return model.axes(), model.lora_axes(), model.cache_axes()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("size", ("full", "reduced"))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_match_jax_specs(arch, size, mesh):
    jm, tm = meshes(mesh)
    jcfg, tcfg = configs(arch, size)
    rules_j, rules_t = rules(jcfg, jm, tm)
    assert rules_t == rules_j
    j_trees = jax_axes(arch, size, jm, rules_j)
    t_trees = port_trees(arch, size, tm, rules_t)
    for what, j_ax, j_shapes, t in zip(("params", "lora", "cache"), j_trees,
                                       jax_shapes(arch, size), t_trees):
        if t is None:
            assert j_ax is None
            continue
        t_ax, t_shapes = t
        ja, js = leaves(j_ax), leaves(j_shapes)
        ta, ts = leaves(t_ax), leaves(t_shapes)
        assert set(ja) == set(js) and set(ta) == set(ts), what
        assert set(ta) == set(ja), (what, set(ta) ^ set(ja))
        placements = leaves(tsh.logical_to_sharding(
            t_ax, t_shapes, mesh=tm, rules=dict(tsh.DEFAULT_RULES,
                                                **rules_t)))
        for path in ja:
            shape = tuple(js[path].shape)
            assert tuple(ts[path].shape) == shape, (what, path)
            assert ta[path] == ja[path], (what, path)
            want = tuple(jsh.resolve_spec(
                ja[path], shape, mesh=jm,
                rules=dict(jsh.DEFAULT_RULES, **rules_j)))
            assert tsh.resolve_spec(ta[path], shape, mesh=tm, rules=dict(
                tsh.DEFAULT_RULES, **rules_t)) == want, (what, path)
            assert placements[path] == tsh.spec_placements(
                want, tm, len(shape)), (what, path)


def test_placements_of_a_split_spec():
    """Shard(i) on every mesh dim a spec entry names (both, major→minor,
    for a tuple); a size-1 mesh dim stays replicated; a tuple against
    the mesh's dim order raises."""
    from torch.distributed.tensor import Replicate, Shard
    tm = TorchMesh(("data", "model"), (2, 4))
    assert tsh.spec_placements(("model", "data"), tm, 2) == (Shard(1),
                                                             Shard(0))
    assert tsh.spec_placements(((("data", "model")),), tm, 3) == (Shard(0),
                                                                  Shard(0))
    assert tsh.spec_placements((), tm, 2) == (Replicate(), Replicate())
    one = TorchMesh(("data", "model"), (1, 4))
    assert tsh.spec_placements(("data", "model"), one, 2) == (Replicate(),
                                                              Shard(1))
    with pytest.raises(ValueError):
        tsh.spec_placements((("model", "data"),), tm, 1)


def test_constrain_is_identity_off_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert tsh.constrain(x, ("batch", "embed")) is x
    with tsh.mesh_context(TorchMesh(("data", "model"), (2, 2))):
        assert tsh.constrain(x, ("batch", "embed")) is x   # a plain tensor


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"))
@pytest.mark.parametrize("arch", list(jbase.ARCH_IDS))
def test_input_specs_match_jax(arch, shape):
    """Names, shapes and dtypes of every input of every family and shape
    kind; ``concrete=True`` fills as the reference (int zeros, 0.01)."""
    jcfg, tcfg = jbase.load_arch(arch), tbase.load_arch(arch)
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tcfg.supports_long == jcfg.supports_long
    js = jbase.input_specs(jcfg, jbase.SHAPES[shape])
    ts = tbase.input_specs(tcfg, tbase.SHAPES[shape])
    assert set(ts) == set(js)
    for k in js:
        assert ts[k].device.type == "meta"
        assert tuple(ts[k].shape) == tuple(js[k].shape), k
        assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), k
    jr, tr = jcfg.reduced(), tcfg.reduced()
    jc = jbase.input_specs(jr, jbase.SHAPES[shape], concrete=True,
                           batch_override=2, seq_override=8)
    tc = tbase.input_specs(tr, tbase.SHAPES[shape], concrete=True,
                           batch_override=2, seq_override=8, device="cpu")
    for k in jc:
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(jc[k], np.float32))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_batch_and_opt_state_shardings(mesh):
    """A batch leaf splits its leading dim by the "batch" rule when it is
    more than 1 and divides (JAX's ``dryrun.batch_shardings``), the rest
    replicated; mu / nu take the LoRA's placements."""
    jm, tm = meshes(mesh)
    cfg = tbase.load_arch("qwen2-vl-7b")
    batch = tbase.input_specs(cfg, tbase.SHAPES["train_4k"],
                              batch_override=6, seq_override=16)
    batch["one"] = torch.empty((1, 5), device="meta")
    got = tmesh.batch_shardings(batch, tm)
    for k, v in batch.items():
        axes = (("batch",) + (None,) * (v.dim() - 1) if v.shape[0] > 1
                else (None,) * v.dim())
        want = tuple(jsh.resolve_spec(axes, tuple(v.shape), mesh=jm))
        assert got[k] == tsh.spec_placements(want, tm, v.dim()), k
    lora_sh = {"a": "placements"}
    assert tmesh.opt_state_shardings({}, lora_sh, tm) == {
        "step": None, "mu": lora_sh, "nu": lora_sh}


def test_serving_step_factories():
    """``make_prefill_step`` / ``make_decode_step`` call the model's steps
    (the reference's ``impl="chunked"`` is the port's prefill rule;
    another impl raises)."""
    cfg = tbase.load_arch("qwen2-0.5b").reduced()
    model = cfg.build(device="cpu")
    params, lora = model.init(0), model.lora_init(1)
    tokens = torch.randint(0, cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(0))
    c1, c2 = model.init_cache(2, 8), model.init_cache(2, 8)
    want, _ = model.prefill_step(params, lora, {"tokens": tokens}, c1)
    got, _ = ttrain.make_prefill_step(model)(params, lora,
                                             {"tokens": tokens}, c2)
    assert torch.equal(got, want)
    step = {"tokens": tokens[:, :1]}
    want, _ = model.decode_fn(params, lora, step, c1, 5)
    got, _ = ttrain.make_decode_step(model)(params, lora, step, c2, 5)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ttrain.make_prefill_step(model, impl="full")
