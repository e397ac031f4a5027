"""The port's MoE family against the JAX package's, on the CPU.

1. ``repro_torch.nn.moe.MoE`` against ``repro.nn.moe.MoE`` on its
   mesh-free path, on the same numpy parameters and inputs (d_model 32,
   B 4 × S 16 = 64 tokens): (E, k) in {(4, 2), (5, 2), (8, 3), (40, 8)},
   capacity factors 8.0, 1.25 and 0.25 (0.25 drops rows in every case),
   with and without a shared expert and its LoRA; router ties planted
   by duplicated router columns; bf16.
2. granite-moe-3b-a800m at full width, shapes only: parameter and LoRA
   trees, d = 3,145,792 and the manifest fingerprint.
3. The reduced granite (2 layers, d_model 128, 4 experts, top-2, cf 8.0)
   and a variant with 8 experts at cf 1.25 whose prefills drop rows:
   forward, prefill-then-decode logits and greedy tokens against JAX;
   one MaTU round, both downlink layouts, both routes (``mode="ref"``),
   every LoRA site on the fused route.

Tolerances: fp32 MoE outputs rtol 1e-5, atol 1e-6 (sums in another
order); the load-balance aux within 1e-6; routed expert ids, capacity
positions and drops identical; bf16 MoE outputs within 2^-6 of the
output scale (a few bf16 ulps: XLA on the CPU keeps excess precision
through bf16 elementwise chains); model logits rtol 1e-4, atol 1e-5;
packed words and greedy tokens identical.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.tree import TaskVectorSpace as JSpace  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import load_arch as j_load_arch  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.server import MaTUServer as JServer  # noqa: E402
from repro.core.server import MaTUServerConfig as JServerCfg  # noqa: E402
from repro.core.unify import unify_with_modulators  # noqa: E402
from repro.nn.moe import MoE as JMoE  # noqa: E402
from repro.serve import GenerationConfig as JGenCfg  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import MultiTenantDecoder as JDecoder  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.configs.base import (PORTED_ARCHS, SHAPES,  # noqa: E402
                                      load_arch)
from repro_torch.core.client import ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.nn import moe as moe_mod  # noqa: E402
from repro_torch.nn.moe import MoE  # noqa: E402
from repro_torch.serve import (GenerationConfig, ModulatorStore,  # noqa: E402
                               MultiTenantDecoder, route_batch)

jax.config.update("jax_platform_name", "cpu")

ARCH = "granite-moe-3b-a800m"
D_MODEL, D_FF, B, S = 32, 16, 4, 16
EXPERTS = [(4, 2), (5, 2), (8, 3), (40, 8)]
RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2.0 ** -6
LM_RTOL, LM_ATOL = 1e-4, 1e-5


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: tensor_from_numpy(np.asarray(a)),
                                  tree)


def j_route(jmoe, router_w, x):
    """The reference's routing, as ``repro.nn.moe.MoE._local_moe`` computes
    it on the mesh-free path (e0 = 0, every expert local): expert ids,
    capacity positions and kept flags, each (T, k)."""
    xt = x.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xt, router_w).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jmoe.top_k)
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, jmoe.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    keep = pos < jmoe.capacity(xt.shape[0])
    return (np.asarray(idx), np.asarray(pos).reshape(idx.shape),
            np.asarray(keep).reshape(idx.shape))


def pair(e, k, cf, shared, dtype=jnp.float32, seed=0):
    """The same MoE in both packages: (jmoe, jparams, jlora, moe, params,
    lora, x numpy); the shared expert's LoRA b ~ 0.05 N(0, 1)."""
    kw = dict(n_shared=1 if shared else 0, shared_d_ff=8 if shared else None,
              capacity_factor=cf)
    jmoe = JMoE(D_MODEL, D_FF, e, k, dtype=dtype, **kw)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    moe = MoE(D_MODEL, D_FF, e, k, dtype=tdt, **kw)
    jparams = jmoe.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    jlora = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                      a.dtype)
                      if str(p[-1].key) == "b" else a),
        jmoe.lora_init(jax.random.PRNGKey(seed + 2), 4))
    x = rng.standard_normal((B, S, D_MODEL)).astype(np.float32)
    return (jmoe, jparams, jlora, moe, to_torch(jparams), to_torch(jlora), x)


def run_both(jmoe, jparams, jlora, moe, params, lora, x, dtype=jnp.float32):
    jy = jmoe(jparams, jnp.asarray(x, dtype), jlora or None)
    y = moe(params, tensor_from_numpy(np.asarray(jnp.asarray(x, dtype))),
            lora or None)
    return y, jy


# ---------------------------------------------------------------------------
# 1. the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("e,k", EXPERTS, ids=[f"E{e}k{k}" for e, k in EXPERTS])
def test_moe_matches_jax(e, k, cf, shared):
    """Routed ids, capacity positions and drops identical; outputs within
    rtol 1e-5 / atol 1e-6; the aux term within 1e-6; cf 0.25 drops."""
    jmoe, jparams, jlora, moe, params, lora, x = pair(e, k, cf, shared)
    assert moe.lora_init(None, 4, "meta").keys() == jlora.keys()
    y, jy = run_both(jmoe, jparams, jlora, moe, params, lora, x)
    jidx, jpos, jkeep = j_route(jmoe, jparams["router"]["w"], jnp.asarray(x))
    xt = torch.from_numpy(x).reshape(-1, D_MODEL)
    _, _, idx, pos, keep = moe.route(params["router"]["w"], xt,
                                     moe.capacity(B * S))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if cf == 0.25:
        assert not keep.all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    assert abs(float(moe.last_aux) - float(jmoe.last_aux)) <= 1e-6


@pytest.mark.parametrize("e,k", [(8, 3), (40, 8)], ids=["E8k3", "E40k8"])
def test_planted_router_ties_order_as_jax(e, k):
    """Router columns come in groups of g equal columns (g = 2 for odd
    k, 3 for k = 8, so a group straddles the cut), and inputs and weights
    are multiples of 1/4 (every logit exact in fp32 in any order): equal
    probabilities at the cut between choice k and k + 1, and inside the
    top k, in many rows.  The ids follow lax.top_k's
    order (lower index first) and the outputs agree."""
    jmoe, jparams, _, moe, _, _, _ = pair(e, k, 1.25, False, seed=3)
    rng = np.random.default_rng(4)
    w = rng.integers(-4, 5, (D_MODEL, e)).astype(np.float32) / 4
    g = 2 if k % 2 else 3
    w = w[:, (np.arange(e) // g) * g]
    x = rng.integers(-4, 5, (B, S, D_MODEL)).astype(np.float32) / 4
    jparams = dict(jparams, router={"w": jnp.asarray(w)})
    params = to_torch(jparams)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(-1, D_MODEL) @ w),
                                      axis=-1))
    srt = -np.sort(-probs, axis=-1)
    assert (srt[:, k - 1] == srt[:, k]).sum() >= 8
    assert (srt[:, :k - 1] == srt[:, 1:k]).any(-1).all()
    y, jy = run_both(jmoe, jparams, {}, moe, params, {}, x)
    jidx, jpos, jkeep = j_route(jmoe, jnp.asarray(w), jnp.asarray(x))
    _, _, idx, pos, keep = moe.route(params["router"]["w"],
                                     torch.from_numpy(x).reshape(-1, D_MODEL),
                                     moe.capacity(B * S))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def test_top_k_orders_ties_as_lax_top_k():
    """Softmax rows of 4,096 × 40 logits rounded to 1/8 (ties in most
    rows): ``moe.top_k`` gives ``lax.top_k``'s values and indices in
    every row, where ``torch.topk``'s indices differ in many."""
    rng = np.random.default_rng(6)
    logits = np.round(rng.standard_normal((4096, 40)) * 8) / 8
    p = np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1))
    jv, ji = jax.lax.top_k(jnp.asarray(p), 8)
    tv, ti = moe_mod.top_k(torch.from_numpy(p), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    plain = torch.topk(torch.from_numpy(p), 8).indices.numpy()
    assert (plain != np.asarray(ji)).any(-1).sum() > 1000


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("e,k", [(8, 3), (40, 8)], ids=["E8k3", "E40k8"])
def test_moe_bf16_matches_jax(e, k, shared):
    """bf16 parameters and inputs: routed ids identical, outputs within
    2^-6 of the output scale (elementwise)."""
    jmoe, jparams, jlora, moe, params, lora, x = pair(
        e, k, 1.25, shared, dtype=jnp.bfloat16, seed=5)
    assert params["router"]["w"].dtype == torch.bfloat16
    y, jy = run_both(jmoe, jparams, jlora, moe, params, lora, x,
                     dtype=jnp.bfloat16)
    assert y.dtype == torch.bfloat16
    jidx, _, jkeep = j_route(jmoe, jparams["router"]["w"],
                             jnp.asarray(x, jnp.bfloat16))
    _, _, idx, _, keep = moe.route(
        params["router"]["w"],
        tensor_from_numpy(np.asarray(jnp.asarray(x, jnp.bfloat16)))
        .reshape(-1, D_MODEL), moe.capacity(B * S))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    jy = np.asarray(jy).astype(np.float32)
    scale = np.abs(jy).max()
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=BF16_TOL,
                               atol=BF16_TOL * scale)


def test_capacity_matches_jax_on_a_grid():
    for e, k in EXPERTS + [(40, 8), (160, 6)]:
        for cf in (8.0, 1.25, 1.0, 0.25, 0.1):
            jmoe = JMoE(D_MODEL, D_FF, e, k, capacity_factor=cf)
            moe = MoE(D_MODEL, D_FF, e, k, capacity_factor=cf)
            for n in (1, 2, 7, 8, 63, 64, 100, 1024, 4097):
                assert moe.capacity(n) == jmoe.capacity(n), (e, k, cf, n)
    assert MoE(1536, 512, 40, 8).capacity(8 * 128) == 256
    assert MoE(1536, 512, 40, 8).capacity(8) == 8


def test_moe_init_shapes_on_meta():
    moe = MoE(D_MODEL, D_FF, 5, 2, n_shared=2, shared_d_ff=8)
    p = moe.init(None, "meta", lead=(3,))
    assert p["router"]["w"].shape == (3, D_MODEL, 5)
    assert p["experts"]["gate"].shape == (3, 5, D_MODEL, D_FF)
    assert p["experts"]["down"].shape == (3, 5, D_FF, D_MODEL)
    assert p["shared"]["down"]["w"].shape == (3, 16, D_MODEL)
    assert MoE(D_MODEL, D_FF, 5, 2).lora_init(None, 4, "meta") == {}


# ---------------------------------------------------------------------------
# 2. full width, shapes only
# ---------------------------------------------------------------------------

def test_full_width_trees_manifest_and_fingerprint_match_jax():
    """granite at full width: the same 3,298,793,472 parameters in the
    same paths and shapes, LoRA leaves ``units/blk/mixer/{wo,wq}/{a,
    alpha,b}``, d = 3,145,792 and fingerprint ``c35e17542cab0e2c`` in
    both packages; every site's factor (1536 · 16 bits a layer) is
    word-aligned, so all 64 take the fused route."""
    assert ARCH in PORTED_ARCHS
    jm = j_load_arch(ARCH).build()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jspace = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                             jax.random.PRNGKey(1)))
    m = load_arch(ARCH).build(device="cpu")
    jshapes = {"/".join(str(k.key) for k in p): tuple(x.shape)
               for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    tshapes = {"/".join(p): tuple(x.shape)
               for p, x in _leaves(m.init(device="meta"))}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in tshapes.values()) == 3_298_793_472
    assert tshapes["units/blk/ffn/experts/gate"] == (32, 40, 1536, 512)
    space = TaskVectorSpace.from_tree(m.lora_init(device="meta"))
    assert space.d == jspace.d == 3_145_792
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint == "c35e17542cab0e2c"
    assert [l.path for l in space.leaves] == [
        f"units/blk/mixer/{s}/{f}" for s in ("wo", "wq")
        for f in ("a", "alpha", "b")]
    m.cfg.check_lora_targets([l.path for l in space.leaves])
    for l in space.leaves:
        if l.path.endswith(("/a", "/b")):
            assert (l.size // 32) % bitpack.WORD_BITS == 0


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_configs_match_jax():
    for reduce in (False, True):
        j, t = j_load_arch(ARCH), load_arch(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "source", "rope_base", "tie_embeddings",
                  "n_experts", "top_k", "n_shared_experts", "shared_d_ff",
                  "moe_capacity_factor", "use_mla", "lora_rank",
                  "sliding_window_long"):
            assert getattr(j, f) == getattr(t, f), (reduce, f)
        assert t.lora_targets() == j.lora_targets() == ("mixer/wq",
                                                        "mixer/wo")
    assert load_arch(ARCH).dtype == torch.bfloat16
    assert load_arch(ARCH).reduced().dtype == torch.float32


# ---------------------------------------------------------------------------
# 3. the reduced granite: model, round, store and decoder
# ---------------------------------------------------------------------------

N_TASKS, PROMPT = 4, 40
CLIENT_TASKS = [[0, 1], [1, 2], [2, 3], [0, 3], [0, 2], [1, 3]]
IDS = [2, 0, 3, 2]
GEN = GenerationConfig(max_new_tokens=5)
J_GEN = JGenCfg(max_new_tokens=5)
VARIANTS = ["reduced", "drops"]


def configs(variant):
    """(JAX config, port config): ``reduced()``, or with 8 experts at cf
    1.25, where a 4 × 40 prefill drops rows."""
    j, t = j_load_arch(ARCH).reduced(), load_arch(ARCH).reduced()
    if variant == "drops":
        j = dataclasses.replace(j, n_experts=8, moe_capacity_factor=1.25)
        t = dataclasses.replace(t, n_experts=8, moe_capacity_factor=1.25)
    return j, t


@functools.lru_cache(maxsize=None)
def rig(variant):
    jcfg, cfg = configs(variant)
    jm = jcfg.build(J_SHAPES["decode_32k"])
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora0 = jm.lora_init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    jlora = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                      x.dtype)
                      if str(p[-1].key) == "b" else x), jlora0)
    m = cfg.build(SHAPES["decode_32k"], device="cpu")
    tokens = np.random.default_rng(3).integers(1, m.cfg.vocab, (N_TASKS,
                                                                PROMPT))
    return dict(jm=jm, jparams=jparams, jlora0=jlora0, jlora=jlora, m=m,
                params=params_from_numpy(m, to_np(jparams)),
                lora0=lora_from_numpy(m, to_np(jlora0)),
                lora=lora_from_numpy(m, to_np(jlora)), tokens=tokens)


def kept_rows(m, fn):
    """(kept, routed) (token, choice) rows over every MoE call of ``fn``."""
    moe = m.model.unit_blocks[0][1].ffn
    seen = []
    orig = moe.route

    def spy(router_w, xt, cap):
        out = orig(router_w, xt, cap)
        seen.append((int(out[4].sum()), out[4].numel()))
        return out

    moe.route = spy
    try:
        fn()
    finally:
        del moe.route
    return tuple(sum(c) for c in zip(*seen))


@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_logits_match_jax(variant, with_lora):
    r = rig(variant)
    jl, _ = r["jm"].model.forward(r["jparams"], jnp.asarray(r["tokens"]),
                                  lora=r["jlora"] if with_lora else None)
    holder = {}

    def fwd():
        holder["l"] = r["m"].forward(r["params"],
                                     torch.from_numpy(r["tokens"]),
                                     lora=r["lora"] if with_lora else None)

    kept, routed = kept_rows(r["m"], fwd)
    assert routed == 2 * N_TASKS * PROMPT * r["m"].cfg.top_k
    assert (kept < routed) == (variant == "drops")
    np.testing.assert_allclose(holder["l"].numpy(), np.asarray(jl),
                               rtol=LM_RTOL, atol=LM_ATOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_then_decode_logits_match_jax(variant):
    """A 40-token prefill, then three decode steps (B 4: capacity 8, no
    drop), logits against JAX's at each step."""
    r = rig(variant)
    jm, m = r["jm"], r["m"]
    jc = jm.init_cache(N_TASKS, 64)
    jl, jc = jm.prefill_step(r["jparams"], r["jlora"],
                             {"tokens": jnp.asarray(r["tokens"])}, jc)
    tc = m.init_cache(N_TASKS, 64)
    tl, _ = m.prefill_step(r["params"], r["lora"],
                           {"tokens": torch.from_numpy(r["tokens"])}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for pos in (PROMPT, PROMPT + 1, PROMPT + 2):
        jl, jc = jm.decode_fn(r["jparams"], r["jlora"],
                              {"tokens": jnp.asarray(nxt)}, jc,
                              jnp.int32(pos))
        tl, _ = m.decode_fn(r["params"], r["lora"],
                            {"tokens": torch.from_numpy(nxt)}, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL)
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)


@functools.lru_cache(maxsize=None)
def rounds(variant):
    """One MaTU round in each package on the same uploads (clients unify
    with the JAX package's ``unify_with_modulators``)."""
    r = rig(variant)
    jspace = JSpace.from_tree(r["jlora0"])
    space = TaskVectorSpace.from_tree(r["lora0"])
    assert space.fingerprint == jspace.fingerprint
    d = space.d
    rng = np.random.default_rng(7)
    vecs = (0.05 * rng.standard_normal((N_TASKS, d))).astype(np.float32)
    jups, ups = [], []
    for cid, tids in enumerate(CLIENT_TASKS):
        local = vecs[tids] + (0.01 * rng.standard_normal((len(tids), d))
                              ).astype(np.float32)
        uni, masks, lams = (np.array(a) for a in
                            unify_with_modulators(jnp.asarray(local)))
        sizes = [int(s) for s in rng.integers(10, 200, len(tids))]
        jups.append(JUpload(cid, tids, jnp.asarray(uni), jnp.asarray(masks),
                            jnp.asarray(lams), sizes,
                            fingerprint=jspace.fingerprint))
        ups.append(ClientUpload(cid, tids, torch.from_numpy(uni),
                                torch.from_numpy(masks),
                                torch.from_numpy(lams), sizes,
                                fingerprint=space.fingerprint))
    jserver = JServer(JServerCfg(n_tasks=N_TASKS))
    jserver.round(jups)
    server = MaTUServer(MaTUServerConfig(n_tasks=N_TASKS), device="cpu")
    server.round(ups)
    return jspace, space, jserver, server


def stores(variant, packed):
    """The JAX round's serving downlink in both stores (the port's own
    round agrees to fp32 tolerance: ``test_round_matches_jax``)."""
    r = rig(variant)
    jspace, space, jserver, _ = rounds(variant)
    jdl = jserver.serving_downlink(packed=packed,
                                   fingerprint=jspace.fingerprint)
    port = MaTUServer(MaTUServerConfig(n_tasks=N_TASKS), device="cpu")
    port.last_task_vectors = torch.from_numpy(
        np.array(jserver.last_task_vectors))
    dl = port.serving_downlink(packed=packed, fingerprint=space.fingerprint)
    if packed:
        np.testing.assert_array_equal(bitpack.words_to_numpy(dl.masks),
                                      np.asarray(jdl.masks))
    else:
        np.testing.assert_array_equal(dl.masks.numpy(),
                                      np.asarray(jdl.masks))
    jstore = JStore(jspace, r["jlora0"])
    jstore.ingest(jdl)
    store = ModulatorStore(space, r["lora0"], capacity=N_TASKS, device="cpu")
    store.ingest(dl)
    return jstore, store


def test_round_matches_jax():
    _, _, jserver, server = rounds("reduced")
    np.testing.assert_allclose(server.last_task_vectors.numpy(),
                               np.asarray(jserver.last_task_vectors),
                               rtol=1e-5, atol=1e-6)


def _sites(node, prefix=""):
    if not isinstance(node, dict):
        return
    if "a" in node and "b" in node:
        yield prefix, node
        return
    for k in node:
        yield from _sites(node[k], f"{prefix}/{k}")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_every_site_fused_and_four_kernel9_calls_a_layer(packed,
                                                         monkeypatch):
    """Both sites (``mixer/wq``, ``mixer/wo``) of every layer take the
    fused route, none falls back to dense-routed, and a prefill and a
    decode step each call kernel 9 4 × n_layers times."""
    r = rig("reduced")
    _, store = stores("reduced", packed)
    tree = route_batch(store, IDS, fused=True)
    sites = dict(_sites(tree))
    assert sites.keys() == {"/units/blk/mixer/wq", "/units/blk/mixer/wo"}
    assert all(isinstance(s["a"], dict) for s in sites.values())
    calls = []
    real = ops.modulated_matmul

    def count(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "modulated_matmul", count)
    m = r["m"]
    cache = m.init_cache(N_TASKS, 64)
    logits, _ = m.prefill_step(r["params"], tree,
                               {"tokens": torch.from_numpy(r["tokens"])},
                               cache, mode="ref")
    assert len(calls) == 4 * m.cfg.n_layers
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    m.decode_fn(r["params"], tree, {"tokens": tok}, cache, PROMPT,
                mode="ref")
    assert len(calls) == 8 * m.cfg.n_layers


@functools.lru_cache(maxsize=None)
def jax_tokens(variant, packed, fused):
    r = rig(variant)
    jstore, _ = stores(variant, packed)
    dec = JDecoder(r["jm"], r["jparams"], jstore, fused=fused, cfg=J_GEN)
    return np.asarray(dec.generate(jnp.asarray(r["tokens"]), IDS))


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_decoder_tokens_match_jax(variant, packed, fused):
    """A mixed batch (tasks 2, 0, 3, 2) through the port's store and
    decoder (plain versions) gives the JAX decoder's tokens on the same
    downlink layout, on both routes; the drops variant's prefill drops
    rows in the port."""
    r = rig(variant)
    _, store = stores(variant, packed)
    dec = MultiTenantDecoder(r["m"], r["params"], store, fused=fused,
                             cfg=GEN, mode="ref", device="cpu")
    holder = {}

    def gen():
        holder["out"] = dec.generate(torch.from_numpy(r["tokens"]), IDS)

    kept, routed = kept_rows(r["m"], gen)
    assert (kept < routed) == (variant == "drops")
    out = holder["out"]
    assert out.shape == (N_TASKS, PROMPT + GEN.max_new_tokens)
    np.testing.assert_array_equal(out.numpy(),
                                  jax_tokens(variant, packed, fused))
