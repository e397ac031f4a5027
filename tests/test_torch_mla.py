"""The port's Multi-head Latent Attention and deepseek-v2-236b against the
JAX package's, on the CPU, on the same numpy inputs.

1. ``MLAttention`` (d_model 64, 4 heads, q_lora 32, kv_lora 16, nope 16,
   rope 8, v 16, q_chunk 4): its parameter, LoRA and cache trees; the
   full-sequence call in fp32 and bf16, with and without LoRA, impl
   "full", "chunked" and "auto" at S 3, 4, 7 and 13 (below, at and past
   the chunk) and at offset positions; ``_wkv_b_split`` on converted
   JAX weights; a prefill then four absorbed decode steps, with and
   without a window of 5 (a 9-token prompt past it, so decode runs
   through the ring's wrap), outputs and every cache leaf; the absorbed
   decode against the naive call.
2. deepseek-v2-236b's config, and its full-width trees on ``meta``: at
   60 layers 239,375,569,920 parameters, d = 34,898,100, fingerprint
   ``fd20f8e23ca2e1b2``; at the 2 layers the card serves d = 1,163,270,
   fingerprint ``aa8b21849ef6989e``; every site word-aligned.
3. The reduced deepseek (2 layers, d_model 128, 4 heads, MLA ranks 32 /
   16, 4 experts top-2 and one shared expert, LoRA rank 4, fp32):
   parameters carried across; forward logits with and without LoRA;
   prefill then decode logits and the latent caches; prefill + decode
   against the full forward; one MaTU round, both downlink layouts, both
   routes, all three sites fused with 2·3·L kernel-9 calls a forward,
   greedy tokens against JAX's ``MultiTenantDecoder``.

The JAX side runs under ``jax.jit`` (one compile a call,
cheaper than eager's per-op compiles at each new shape), except bf16
decode steps, which run eagerly: there XLA's fused program keeps excess
precision through the absorbed chain's bf16 rounding points and lands
an element 1.2 × 2^-7 of the scale away, where eager JAX rounds op by
op as the port does.  JAX's ``decode_step`` takes its position as
a traced int32, so the tests pass ``jnp.int32(pos)``.

Tolerances: fp32 pieces rtol 1e-5 / atol 1e-6 (the products and
norms sum in another order than XLA's); fp32 logits and caches of a
whole stack rtol 1e-4 / atol 1e-5 (the other families' bar), and so
the absorbed decode against the naive call, which sums its products in
another order (not bitwise); bf16 outputs and cache leaves within 2^-7
of their scale (the port rounds where the reference does, but XLA may
keep excess precision through a fused bf16 chain); ``kpos``, packed
words, route leaves and greedy tokens identical.
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
from repro.configs.base import load_arch as j_load_arch  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.server import MaTUServer as JServer  # noqa: E402
from repro.core.server import MaTUServerConfig as JServerCfg  # noqa: E402
from repro.core.unify import unify_with_modulators  # noqa: E402
from repro.nn.mla import MLAttention as JMLA  # noqa: E402
from repro.serve import GenerationConfig as JGenCfg  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import MultiTenantDecoder as JDecoder  # noqa: E402
from repro.serve import route_batch as j_route_batch  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.configs.base import PORTED_ARCHS, load_arch  # noqa: E402
from repro_torch.core.client import ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.nn.mla import MLAttention  # noqa: E402
from repro_torch.serve import (GenerationConfig, ModulatorStore,  # noqa: E402
                               MultiTenantDecoder, route_batch)

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v2-236b"
RTOL, ATOL = 1e-5, 1e-6            # one piece in fp32
LM_RTOL, LM_ATOL = 1e-4, 1e-5      # a whole stack in fp32
BF16_TOL = 2.0 ** -7
D, H, B = 64, 4, 3
DIMS = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16, q_chunk=4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
N_TASKS, PROMPT, N_NEW = 4, 12, 5
CLIENT_TASKS = [[0, 1], [1, 2], [2, 3], [0, 3], [0, 2], [1, 3]]
IDS = [2, 0, 3, 2]
SITES = sorted(f"units/blk/{s}" for s in ("mixer/wq_a", "mixer/wo",
                                          "ffn/shared/down"))
DS_FINGERPRINT_2 = "aa8b21849ef6989e"


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: tensor_from_numpy(np.asarray(a)),
                                  tree)


def perturbed(jlora, seed):
    """The LoRA tree with b ~ 0.05 N(0, 1) (``lora_init`` zeroes b)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                      x.dtype)
                      if str(p[-1].key) == "b" else x), jlora)


def assert_close(got, want, dtype, rtol=RTOL, atol=ATOL):
    """fp32: rtol / atol; bf16: within BF16_TOL of the output scale."""
    want = np.asarray(want).astype(np.float32)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_TOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def x_in(seed, shape, jdt):
    """Seeded N(0, 1) input in the JAX dtype and the same bits in torch."""
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    jdt)
    return x, tensor_from_numpy(np.asarray(x))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _jshapes(tree):
    return {"/".join(str(k.key) for k in p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# 1. MLAttention
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def mla_pair(dtype, window=None, seed=0):
    jdt, tdt = DTYPES[dtype]
    jm = JMLA(D, H, window=window, dtype=jdt, **DIMS)
    m = MLAttention(D, H, window=window, dtype=tdt, **DIMS)
    jp = jm.init(jax.random.PRNGKey(seed))
    jl = perturbed(jm.lora_init(jax.random.PRNGKey(seed + 1), 4), seed + 2)
    return jm, jp, jl, m, to_torch(jp), to_torch(jl)


def test_mla_trees_on_meta_match_jax():
    """Parameter and LoRA trees in JAX's keys and shapes (LoRA on wq_a
    and wo only), under a layers axis; the latent cache's leaves."""
    jm = JMLA(D, H, **DIMS)
    m = MLAttention(D, H, **DIMS)
    p = m.init(None, "meta", lead=(2,))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert {"/".join(k): tuple(x.shape)[1:] for k, x in _leaves(p)} == \
        _jshapes(jp)
    assert all(x.shape[0] == 2 for _, x in _leaves(p))
    lora = m.lora_init(None, 4, "meta", lead=(2,))
    jl = jax.eval_shape(functools.partial(jm.lora_init, rank=4),
                        jax.random.PRNGKey(1))
    assert sorted(lora) == ["wo", "wq_a"]
    assert {"/".join(k): tuple(x.shape)[1:] for k, x in _leaves(lora)} == \
        _jshapes(jl)
    c = m.init_cache(3, 20, device="meta", lead=(2,))
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "c_kv": (2, 3, 20, 16), "k_rope": (2, 3, 20, 8), "kpos": (2, 20)}
    assert c["kpos"].dtype == torch.int32
    assert MLAttention(D, H, window=5, **DIMS).cache_len(20) == 5
    assert m.scale == 1.0 / np.sqrt(24)


@pytest.mark.parametrize("s", [3, 4, 7, 13])
@pytest.mark.parametrize("impl", ["full", "chunked", "auto"])
@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_call_matches_jax(dtype, with_lora, impl, s):
    """The naive expansion against JAX's, at S below, at and past the
    4-row query chunk (past it, "chunked" and "auto" take the chunked
    loop, whose last chunk is padded)."""
    jm, jp, jl, m, p, lora = mla_pair(dtype)
    jx, x = x_in(s, (B, s, D), DTYPES[dtype][0])
    jy = jax.jit(functools.partial(jm.__call__, impl=impl))(
        jp, jx, lora=jl if with_lora else None)
    y = m(p, x, lora=lora if with_lora else None, impl=impl)
    assert y.shape == (B, s, D)
    assert_close(y, jy, dtype)


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_call_at_offset_positions_matches_jax(dtype, impl):
    """Positions 100..112 (the rope angles move, the mask reads
    ``positions[0]``) at S 13, past the chunk."""
    jm, jp, jl, m, p, lora = mla_pair(dtype)
    jx, x = x_in(21, (B, 13, D), DTYPES[dtype][0])
    pos = np.broadcast_to(np.arange(100, 113), (B, 13))
    jy = jax.jit(functools.partial(jm.__call__, impl=impl))(
        jp, jx, positions=jnp.asarray(pos), lora=jl)
    y = m(p, x, positions=torch.from_numpy(pos.copy()), lora=lora,
          impl=impl)
    assert_close(y, jy, dtype)
    assert not torch.equal(y, m(p, x, lora=lora, impl=impl))


def test_wkv_b_split_on_converted_jax_weights():
    """Head-major: each head's nope columns, then its v columns, bitwise
    JAX's split; the [all k | all v] reading gives other weights."""
    jm, jp, _, m, p, _ = mla_pair("float32")
    jwk, jwv = jm._wkv_b_split(jp)
    wk, wv = m._wkv_b_split(p)
    assert wk.shape == (16, H, 16) and wv.shape == (16, H, 16)
    np.testing.assert_array_equal(wk.numpy(), np.asarray(jwk))
    np.testing.assert_array_equal(wv.numpy(), np.asarray(jwv))
    w = p["wkv_b"]["w"]
    wrong = w[:, :H * 16].reshape(16, H, 16)
    assert not torch.equal(wrong, wk)
    np.testing.assert_array_equal(wk[:, 1].numpy(), w[:, 32:48].numpy())


def _prefill_decode(dtype, window, cache_len, prompt, total, seed):
    """A ``prompt``-token prefill, then absorbed decode steps to
    ``total``: each step's output and every cache leaf against JAX's.
    Returns the port's cache."""
    jdt, tdt = DTYPES[dtype]
    jm, jp, jl, m, p, lora = mla_pair(dtype, window=window, seed=seed)
    jx, x = x_in(seed + 5, (B, total, D), jdt)
    jc = jm.init_cache(B, cache_len, jdt)
    c = m.init_cache(B, cache_len, tdt)
    jy, jc = jax.jit(jm.prefill)(jp, jx[:, :prompt], jc, lora=jl)
    y, c2 = m.prefill(p, x[:, :prompt], c, lora=lora)
    assert c2 is c
    assert_close(y, jy, dtype)
    step = (jax.jit(jm.decode_step) if dtype == "float32"
            else jm.decode_step)

    def leaves_match():
        np.testing.assert_array_equal(c["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))
        for f in ("c_kv", "k_rope"):
            assert_close(c[f], jc[f], dtype)

    leaves_match()
    for t in range(prompt, total):
        jy, jc = step(jp, jx[:, t:t + 1], jc, jnp.int32(t), lora=jl)
        y, _ = m.decode_step(p, x[:, t:t + 1], c, t, lora=lora)
        assert_close(y, jy, dtype)
        leaves_match()
    return c


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_prefill_then_decode_steps_match_jax(dtype):
    """A 9-token prefill into a 20-slot cache, then four absorbed decode
    steps (positions 9-12)."""
    c = _prefill_decode(dtype, None, 20, 9, 13, seed=30)
    np.testing.assert_array_equal(c["kpos"].numpy(),
                                  list(range(13)) + [-1] * 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_ring_prefill_and_decode_match_jax(dtype):
    """Window 5: a 5-slot ring; a 9-token prefill keeps its trailing 5
    latents (slot = pos % 5), and four decode steps wrap the ring again;
    outputs, c_kv, k_rope and kpos against JAX's."""
    c = _prefill_decode(dtype, 5, 20, 9, 13, seed=40)
    np.testing.assert_array_equal(c["kpos"].numpy(), [10, 11, 12, 8, 9])


@pytest.mark.parametrize("window", [None, 5])
def test_absorbed_decode_matches_the_naive_call(window):
    """fp32: a prefill of S - 1 positions, then one absorbed decode step
    at S - 1, gives the naive call's row S - 1 to the stack bar (not
    bitwise: the products sum in another order)."""
    jm, jp, jl, m, p, lora = mla_pair("float32", window=window, seed=50)
    _, x = x_in(51, (B, 13, D), jnp.float32)
    full = m(p, x, lora=lora)
    c = m.init_cache(B, 16)
    m.prefill(p, x[:, :12], c, lora=lora)
    y, _ = m.decode_step(p, x[:, 12:], c, 12, lora=lora)
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, 12].numpy(),
                               rtol=LM_RTOL, atol=LM_ATOL)


# ---------------------------------------------------------------------------
# 2. deepseek-v2-236b: config and full-width trees
# ---------------------------------------------------------------------------

def test_config_matches_jax_field_for_field():
    for reduce in (False, True):
        j, t = j_load_arch(ARCH), load_arch(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), (reduce,
                                                                  f.name)
        assert t.lora_targets() == j.lora_targets()
    assert load_arch(ARCH).dtype == torch.bfloat16
    assert load_arch(ARCH).reduced().dtype == torch.float32


@pytest.mark.parametrize("n_layers,n_params,d,fingerprint", [
    (60, 239_375_569_920, 34_898_100, "fd20f8e23ca2e1b2"),
    (2, 8_992_814_080, 1_163_270, DS_FINGERPRINT_2)])
def test_full_width_trees_manifest_and_fingerprint_match_jax(
        n_layers, n_params, d, fingerprint):
    """deepseek-v2-236b at full width (and cut to the 2 layers the card
    serves): the same parameters in the same paths and shapes, 9 LoRA
    leaves on the three sites, the same d and fingerprint in both
    packages; every factor word-aligned, so all take the fused route."""
    assert ARCH in PORTED_ARCHS
    jcfg = dataclasses.replace(j_load_arch(ARCH), n_layers=n_layers)
    jm = jcfg.build()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jspace = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                             jax.random.PRNGKey(1)))
    m = dataclasses.replace(load_arch(ARCH), n_layers=n_layers).build(
        device="cpu")
    assert isinstance(m.model.unit_blocks[0][1].mixer, MLAttention)
    tshapes = {"/".join(p): tuple(x.shape)
               for p, x in _leaves(m.init(device="meta"))}
    assert tshapes == _jshapes(jp)
    assert sum(int(np.prod(s)) for s in tshapes.values()) == n_params
    assert tshapes["units/blk/ffn/experts/gate"] == (n_layers, 160, 5120,
                                                     1536)
    assert tshapes["units/blk/ffn/shared/down/w"] == (n_layers, 3072, 5120)
    space = TaskVectorSpace.from_tree(m.lora_init(device="meta"))
    assert space.d == jspace.d == d
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint == fingerprint
    assert [leaf.path for leaf in space.leaves] == [
        f"{s}/{f}" for s in SITES for f in ("a", "alpha", "b")]
    m.cfg.check_lora_targets([leaf.path for leaf in space.leaves])
    for leaf in space.leaves:
        if leaf.path.endswith(("/a", "/b")):
            assert (leaf.size // n_layers) % bitpack.WORD_BITS == 0


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        load_arch(ARCH).build()


# ---------------------------------------------------------------------------
# 3. the reduced deepseek: model, round, store, routes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def rig():
    jm = j_load_arch(ARCH).reduced().build()
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jlora0 = jax.jit(jm.lora_init)(jax.random.PRNGKey(1))
    jlora = perturbed(jlora0, 5)
    m = load_arch(ARCH).reduced().build(device="cpu")
    tokens = np.random.default_rng(3).integers(
        1, m.cfg.vocab, (N_TASKS, PROMPT)).astype(np.int32)
    return dict(jm=jm, jparams=jparams, jlora0=jlora0, jlora=jlora, m=m,
                params=params_from_numpy(m, to_np(jparams)),
                lora0=lora_from_numpy(m, to_np(jlora0)),
                lora=lora_from_numpy(m, to_np(jlora)), tokens=tokens)


def test_params_and_lora_carry_across_leaf_for_leaf():
    """Every converted leaf equals the JAX leaf (the MLA and both expert
    kinds among them); a tree missing a leaf is refused."""
    r = rig()
    for tree, jtree in ((r["params"], r["jparams"]),
                        (r["lora"], r["jlora"])):
        jl = {"/".join(str(k.key) for k in p): np.asarray(x)
              for p, x in jax.tree_util.tree_leaves_with_path(jtree)}
        tl = {"/".join(p): x for p, x in _leaves(tree)}
        assert tl.keys() == jl.keys()
        for k, x in tl.items():
            np.testing.assert_array_equal(x.numpy(), jl[k])
    assert r["params"]["units"]["blk"]["mixer"]["wkv_b"]["w"].shape == (
        2, 16, 4 * 32)
    bad = to_np(r["jparams"])
    del bad["units"]["blk"]["mixer"]["kv_norm"]
    with pytest.raises(ValueError, match="paths differ"):
        params_from_numpy(r["m"], bad)


@pytest.mark.parametrize("with_lora", [False, True])
def test_forward_logits_match_jax(with_lora):
    r = rig()
    jl, _ = jax.jit(r["jm"].model.forward)(
        r["jparams"], jnp.asarray(r["tokens"]),
        lora=r["jlora"] if with_lora else None)
    tl = r["m"].forward(r["params"], torch.from_numpy(r["tokens"]),
                        lora=r["lora"] if with_lora else None)
    assert tl.shape == (N_TASKS, PROMPT, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)


def test_prefill_then_decode_logits_and_caches_match_jax():
    """A 12-token prefill into a 24-slot latent cache, then five absorbed
    decode steps at positions 12-16: logits at each step and every cache
    leaf."""
    r = rig()
    jm, m = r["jm"], r["m"]
    jc = jm.init_cache(N_TASKS, 24)
    tc = m.init_cache(N_TASKS, 24)
    blk = tc["blk"]
    assert blk["c_kv"].shape == (2, N_TASKS, 24, 16)
    assert blk["k_rope"].shape == (2, N_TASKS, 24, 8)
    jl, jc = jax.jit(jm.prefill_step)(r["jparams"], r["jlora"],
                                      {"tokens": jnp.asarray(r["tokens"])},
                                      jc)
    decode = jax.jit(jm.decode_fn)
    tl, _ = m.prefill_step(r["params"], r["lora"],
                           {"tokens": torch.from_numpy(r["tokens"])}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for pos in range(PROMPT, PROMPT + 5):
        jl, jc = decode(r["jparams"], r["jlora"],
                        {"tokens": jnp.asarray(nxt)}, jc, jnp.int32(pos))
        tl, _ = m.decode_fn(r["params"], r["lora"],
                            {"tokens": torch.from_numpy(nxt)}, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL)
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for f in ("c_kv", "k_rope", "kpos"):
        np.testing.assert_allclose(blk[f].numpy(), np.asarray(jc["blk"][f]),
                                   rtol=LM_RTOL, atol=LM_ATOL, err_msg=f)
    np.testing.assert_array_equal(
        blk["kpos"].numpy(),
        np.stack([list(range(PROMPT + 5)) + [-1] * 7] * 2))


def test_prefill_and_decode_equal_the_full_forward():
    """Prefill of S - 3 tokens, then three absorbed decode steps, give
    the naive forward's logits at S - 4 .. S - 1 to the fp32 stack bar
    (not bitwise: the absorbed products sum in another order)."""
    r = rig()
    m = r["m"]
    toks = torch.from_numpy(r["tokens"])
    full = m.forward(r["params"], toks, lora=r["lora"])
    cache = m.init_cache(N_TASKS, 24)
    got = [m.prefill_step(r["params"], r["lora"],
                          {"tokens": toks[:, :-3]}, cache)[0]]
    for pos in range(PROMPT - 3, PROMPT):
        got.append(m.decode_fn(r["params"], r["lora"],
                               {"tokens": toks[:, pos:pos + 1]}, cache,
                               pos)[0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               full[:, -4:].numpy(), rtol=LM_RTOL,
                               atol=LM_ATOL)


@functools.lru_cache(maxsize=1)
def rounds():
    """One MaTU round in each package on the same uploads (clients unify
    with the JAX package's ``unify_with_modulators``)."""
    r = rig()
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


@functools.lru_cache(maxsize=None)
def stores(packed):
    """The JAX round's serving downlink in both stores (the port's own
    round agrees to fp32 tolerance: ``test_round_matches_jax``)."""
    r = rig()
    jspace, space, jserver, _ = rounds()
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
    _, space, jserver, server = rounds()
    assert space.d == 4_358
    np.testing.assert_allclose(server.last_task_vectors.numpy(),
                               np.asarray(jserver.last_task_vectors),
                               rtol=1e-5, atol=1e-6)


def _sites(node, prefix=""):
    if not isinstance(node, dict):
        return
    if "a" in node and "b" in node:
        yield prefix[1:], node
        return
    for k in node:
        yield from _sites(node[k], f"{prefix}/{k}")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_every_site_fused_and_six_kernel9_calls_a_layer(packed,
                                                        monkeypatch):
    """All three sites take the fused route (words, base and τ bitwise
    JAX router's, λ and α to rtol 1e-5); a prefill and a decode step
    each call kernel 9 2·3·L times, at S = PROMPT and S = 1."""
    jstore, store = stores(packed)
    tree = route_batch(store, IDS, fused=True)
    sites = dict(_sites(tree))
    jsites = dict(_sites(j_route_batch(jstore, IDS, fused=True)))
    assert sorted(sites) == sorted(jsites) == SITES
    for path, site in sites.items():
        assert isinstance(site["a"], dict), path
        for f in ("a", "b"):
            for part in ("base", "tau"):
                np.testing.assert_array_equal(
                    site[f][part].numpy(), np.asarray(jsites[path][f][part]))
            np.testing.assert_array_equal(
                bitpack.words_to_numpy(site[f]["words"]),
                np.asarray(jsites[path][f]["words"]))
        for f in ("lam", "alpha"):
            np.testing.assert_allclose(site[f].numpy(),
                                       np.asarray(jsites[path][f]),
                                       rtol=1e-5)
    calls = []
    real = ops.modulated_matmul

    def count(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "modulated_matmul", count)
    r = rig()
    m = r["m"]
    n = m.cfg.n_layers
    cache = m.init_cache(N_TASKS, 24)
    logits, _ = m.prefill_step(r["params"], tree,
                               {"tokens": torch.from_numpy(r["tokens"])},
                               cache, mode="ref")
    assert calls == [PROMPT] * 6 * n
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    m.decode_fn(r["params"], tree, {"tokens": tok}, cache, PROMPT, mode="ref")
    assert calls[6 * n:] == [1] * 6 * n


@functools.lru_cache(maxsize=None)
def jax_tokens(packed, fused):
    r = rig()
    jstore, _ = stores(packed)
    dec = JDecoder(r["jm"], r["jparams"], jstore, fused=fused,
                   cfg=JGenCfg(max_new_tokens=N_NEW))
    return np.asarray(dec.generate(jnp.asarray(r["tokens"]), IDS))


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_decoder_tokens_match_jax(packed, fused):
    """A mixed batch (tasks 2, 0, 3, 2) of 12-token prompts through the
    port's store and decoder (plain versions) gives the JAX decoder's
    tokens on the same downlink layout, on both routes: MLA's naive
    prefill, then its absorbed decode."""
    r = rig()
    _, store = stores(packed)
    dec = MultiTenantDecoder(r["m"], r["params"], store, fused=fused,
                             cfg=GenerationConfig(max_new_tokens=N_NEW),
                             mode="ref", device="cpu")
    out = dec.generate(torch.from_numpy(r["tokens"]), IDS)
    assert out.shape == (N_TASKS, PROMPT + N_NEW)
    np.testing.assert_array_equal(out.numpy(), jax_tokens(packed, fused))
