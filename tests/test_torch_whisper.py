"""The port's audio family (whisper-large-v3) against the JAX package's,
on the CPU, on the same numpy inputs.

1. The pieces: ``LayerNorm``, ``GeluMLP`` and ``sinusoidal_positions``
   in fp32 and bf16; ``Attention`` bidirectional with ``out_bias``,
   with ``kv_input`` (cross-attention), ``init_cross_cache`` and
   ``cross_decode_step``; the chunked query loop at q_chunk 8 over 20
   frames (a ragged last chunk) against JAX's ``_chunked`` and the
   port's full path.
2. whisper-large-v3 at full width, shapes only: parameter and LoRA
   trees, d = 14,418,176, fingerprint ``a2829b09233f62cc``.
3. The reduced whisper (2 + 2 layers, d_model 128, 4 heads, 16 frames,
   LoRA rank 4, fp32): ``encode``, ``forward``, prefill and three decode
   steps (logits and both caches), prefill + decode against the port's
   own full forward, the position clamp past ``max_dec_len``; one MaTU
   round, both downlink layouts, both routes, every LoRA site of both
   stacks fused, kernel-9 calls counted, greedy tokens against JAX's.

Tolerances: fp32 logits rtol 1e-4 / atol 1e-5 (the bar of the MoE
family's tests: sums in other orders through 4 layers); fp32 pieces
(norms, MLP, attention, encoder output, caches) rtol 1e-5 / atol 1e-6,
or rtol 1e-4 / atol 1e-5 where a whole stack runs; the fp32 sinusoid
table atol 2^-13 + 2^-22: XLA's and torch's fp32 ``exp`` differ by one
ulp in 65 of the 640 divisors ``exp(-2i ln(1e4) / 1280)``, and the
product ``pos · div`` then rounds to a neighbouring fp32 value, one ulp
of the argument (2^-13 for arguments in [1024, 2048) rad), which ``sin``
/ ``cos`` carry through (plus their own ulp); bf16
outputs within 2^-7 of the output scale, one bf16 ulp at the largest
magnitude (both packages do the math in fp32 and round once, but XLA on
the CPU may keep more precision through a bf16 elementwise chain, so a
rounding can fall on the other side); packed words, route leaves and
greedy tokens identical.
"""

import functools
import sys
from pathlib import Path

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
from repro.models.encdec import sinusoidal_positions as j_sinusoids  # noqa: E402
from repro.nn.attention import Attention as JAttention  # noqa: E402
from repro.nn.mlp import GeluMLP as JGeluMLP  # noqa: E402
from repro.nn.module import LayerNorm as JLayerNorm  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import route_batch as j_route_batch  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.configs.base import PORTED_ARCHS, load_arch  # noqa: E402
from repro_torch.core.client import ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.models.encdec import sinusoidal_positions  # noqa: E402
from repro_torch.nn.attention import Attention  # noqa: E402
from repro_torch.nn.mlp import GeluMLP  # noqa: E402
from repro_torch.nn.module import LayerNorm  # noqa: E402
from repro_torch.serve import ModulatorStore, route_batch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import served_generate  # noqa: E402  the serving loop

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
RTOL, ATOL = 1e-5, 1e-6            # one piece in fp32
LM_RTOL, LM_ATOL = 1e-4, 1e-5      # a whole stack in fp32
SIN_ATOL = 2.0 ** -13 + 2.0 ** -22
BF16_TOL = 2.0 ** -7
D, H, FF = 32, 4, 64
N_TASKS, PROMPT, N_NEW = 4, 6, 5
CLIENT_TASKS = [[0, 1], [1, 2], [2, 3], [0, 3], [0, 2], [1, 3]]
IDS = [2, 0, 3, 2]


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


def assert_bf16_close(got, want):
    want = np.asarray(want).astype(np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# 1. the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """Scale and bias away from 1 / 0, rows with a large mean (where a
    one-pass variance would lose digits)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, D)) + 4.0).astype(np.float32)
    p = {"scale": rng.standard_normal(D).astype(np.float32),
         "bias": rng.standard_normal(D).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p)
    jy = JLayerNorm(D, dtype=jdt)(jp, jnp.asarray(x, jdt))
    ln = LayerNorm(D, dtype=getattr(torch, dtype))
    y = ln(to_torch(jp), tensor_from_numpy(np.asarray(jnp.asarray(x, jdt))))
    assert ln.init(device="meta", lead=(2,))["bias"].shape == (2, D)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert_bf16_close(y, jy)


@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype, with_lora):
    """up (biased), tanh-GELU, down (biased, LoRA); nonzero biases."""
    jdt = jnp.dtype(dtype)
    jm = JGeluMLP(D, FF, dtype=jdt)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + jnp.asarray(0.1 * rng.standard_normal(a.shape), jdt)
                      if str(p[-1].key) == "b" else a), jp)
    jl = perturbed(jm.lora_init(jax.random.PRNGKey(2), 4), 3) \
        if with_lora else None
    x = jnp.asarray(rng.standard_normal((2, 7, D)), jdt)
    jy = jm(jp, x, jl)
    m = GeluMLP(D, FF, dtype=getattr(torch, dtype))
    assert m.lora_init(None, 4, "meta").keys() == {"down"}
    y = m(to_torch(jp), tensor_from_numpy(np.asarray(x)),
          to_torch(jl) if with_lora else None)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert_bf16_close(y, jy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_positions_match_jax(dtype):
    """whisper's full table, 1,500 frames x 1,280, within one ulp of the
    argument (the divisors' ``exp`` may differ by an ulp); the bf16 cast
    (the encoder adds it in the model's dtype) within one bf16 ulp."""
    jt = np.asarray(j_sinusoids(1500, 1280))
    t = sinusoidal_positions(1500, 1280)
    assert t.dtype == torch.float32 and t.shape == (1500, 1280)
    if dtype == "float32":
        np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=SIN_ATOL)
    else:
        assert_bf16_close(t.to(torch.bfloat16),
                          jnp.asarray(jt).astype(jnp.bfloat16))


def attn_pair(seed, causal=False, cross=False, lora=True):
    """The same biased MHA in both packages (rope off), nonzero biases;
    a LoRA tree on wq / wo with b ~ 0.05 N(0, 1), or None."""
    kw = dict(qkv_bias=True, out_bias=True, rope=False, causal=causal,
              cross=cross)
    ja = JAttention(D, H, H, **kw)
    jp = ja.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                      a.dtype)
                      if str(p[-1].key) == "b" else a), jp)
    jl = perturbed(ja.lora_init(jax.random.PRNGKey(seed + 1), 4), seed + 2) \
        if lora else None
    return (ja, jp, jl, Attention(D, H, H, **kw), to_torch(jp),
            to_torch(jl) if lora else None)


def test_attention_bidirectional_with_out_bias_matches_jax():
    ja, jp, jl, ta, tp, tl = attn_pair(0)
    x = np.random.default_rng(1).standard_normal((2, 9, D)).astype(
        np.float32)
    jy = ja(jp, jnp.asarray(x), lora=jl)
    y = ta(tp, torch.from_numpy(x), lora=tl)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def test_cross_attention_and_its_cache_match_jax():
    """``kv_input`` of 11 frames against 5 queries (no rope, no mask);
    the cross cache (k, v) and one decode step against it; 5 decode
    steps one query at a time equal the 5-query call."""
    ja, jp, jl, ta, tp, tl = attn_pair(3, causal=True, cross=True)
    assert not ta.causal and not ta.rope
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    enc = rng.standard_normal((2, 11, D)).astype(np.float32)
    jy = ja(jp, jnp.asarray(x), kv_input=jnp.asarray(enc), lora=jl)
    y = ta(tp, torch.from_numpy(x), kv_input=torch.from_numpy(enc), lora=tl)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    jc = ja.init_cross_cache(jp, jnp.asarray(enc))
    tc = ta.init_cross_cache(tp, torch.from_numpy(enc))
    for f in ("k", "v"):
        assert tc[f].shape == (2, 11, H, D // H)
        np.testing.assert_allclose(tc[f].numpy(), np.asarray(jc[f]),
                                   rtol=RTOL, atol=ATOL)
    steps = []
    for i in range(5):
        xs = x[:, i:i + 1]
        jys = ja.cross_decode_step(jp, jnp.asarray(xs), jc, lora=jl)
        ys = ta.cross_decode_step(tp, torch.from_numpy(xs), tc, lora=tl)
        np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=RTOL,
                                   atol=ATOL)
        steps.append(ys)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), y.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["chunked", "auto"])
@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "decoder"])
def test_chunked_queries_match_jax_and_the_full_path(causal, impl):
    """q_chunk 8 over 20 frames: chunks of 8, 8 and a ragged 4 (JAX pads
    the last with masked rows); against JAX's ``_chunked`` and the port's
    materialised path; the causal mask applied per chunk.  ``prefill``
    takes the loop too, and the cache it fills is the full path's."""
    ja, jp, jl, ta, tp, tl = attn_pair(5, causal=causal)
    x = np.random.default_rng(6).standard_normal((2, 20, D)).astype(
        np.float32)
    calls = []
    real = ta._chunked

    def spy(*a):
        calls.append(a[0].shape[1])
        return real(*a)

    ta._chunked = spy
    ta.q_chunk = 8
    jy = ja(jp, jnp.asarray(x), lora=jl, impl=impl, q_chunk=8)
    y = ta(tp, torch.from_numpy(x), lora=tl, impl=impl)
    y_full = ta(tp, torch.from_numpy(x), lora=tl, impl="full")
    assert calls == [20]
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(y.numpy(), y_full.numpy(), rtol=RTOL,
                               atol=ATOL)
    cache = ta.init_cache(2, 24)
    yp, cache = ta.prefill(tp, torch.from_numpy(x), cache, lora=tl)
    assert calls == [20, 20]
    np.testing.assert_allclose(yp.numpy(), y.numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        ta(tp, torch.from_numpy(x), impl="scan")


# ---------------------------------------------------------------------------
# 2. full width, shapes only
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


SITES = ["decoder/cross_attn/wo", "decoder/cross_attn/wq", "decoder/mlp/down",
         "decoder/self_attn/wo", "decoder/self_attn/wq", "encoder/attn/wo",
         "encoder/attn/wq", "encoder/mlp/down"]


def test_configs_match_jax():
    for reduce in (False, True):
        j, t = j_load_arch(ARCH), load_arch(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "source", "qkv_bias",
                  "rope_base", "tie_embeddings", "head_dim", "enc_frames",
                  "sliding_window_long", "lora_rank", "remat"):
            assert getattr(j, f) == getattr(t, f), (reduce, f)
        assert t.lora_targets() == j.lora_targets()
    assert ARCH in PORTED_ARCHS
    assert load_arch(ARCH).dtype == torch.bfloat16
    assert load_arch(ARCH).reduced().dtype == torch.float32


def test_full_width_trees_manifest_and_fingerprint_match_jax():
    """The same 1,536,284,160 parameters in the same paths and shapes; 24
    LoRA leaves (8 sites x a, alpha, b, each over 32 layers), d =
    14,418,176 and fingerprint ``a2829b09233f62cc`` in both packages;
    every per-layer factor word-aligned, so all 8 sites take the fused
    route."""
    jm = j_load_arch(ARCH).build()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jspace = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                             jax.random.PRNGKey(1)))
    m = load_arch(ARCH).build(device="cpu")
    assert m.kind == "encdec" and m.model.max_dec_len == 448
    jshapes = {"/".join(str(k.key) for k in p): tuple(x.shape)
               for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    tshapes = {"/".join(p): tuple(x.shape)
               for p, x in _leaves(m.init(device="meta"))}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in tshapes.values()) == 1_536_284_160
    assert tshapes["pos_embed/table"] == (448, 1280)
    assert tshapes["decoder/cross_attn/wk/w"] == (32, 1280, 1280)
    space = TaskVectorSpace.from_tree(m.lora_init(device="meta"))
    assert space.d == jspace.d == 14_418_176
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint == "a2829b09233f62cc"
    assert [l.path for l in space.leaves] == [
        f"{s}/{f}" for s in SITES for f in ("a", "alpha", "b")]
    m.cfg.check_lora_targets([l.path for l in space.leaves])
    for l in space.leaves:
        assert l.shape[0] == 32
        if l.path.endswith(("/a", "/b")):
            assert (l.size // 32) % bitpack.WORD_BITS == 0
    assert space.by_path("encoder/mlp/down/a").shape == (32, 5120, 16)


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        load_arch(ARCH).build()


# ---------------------------------------------------------------------------
# 3. the reduced whisper: model, round, store, routes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def rig():
    jm = j_load_arch(ARCH).reduced().build()
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora0 = jm.lora_init(jax.random.PRNGKey(1))
    jlora = perturbed(jlora0, 5)
    m = load_arch(ARCH).reduced().build(device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, m.cfg.vocab, (N_TASKS, PROMPT)).astype(np.int32)
    audio = rng.standard_normal((N_TASKS, m.cfg.enc_frames,
                                 m.cfg.d_model)).astype(np.float32)
    return dict(jm=jm, jparams=jparams, jlora0=jlora0, jlora=jlora, m=m,
                params=params_from_numpy(m, to_np(jparams)),
                lora0=lora_from_numpy(m, to_np(jlora0)),
                lora=lora_from_numpy(m, to_np(jlora)), tokens=tokens,
                audio=audio)


def test_params_and_lora_carry_across_leaf_for_leaf():
    """Every converted leaf equals the JAX leaf; a tree missing a leaf
    or with a leaf of another shape is refused."""
    r = rig()
    for tree, jtree in ((r["params"], r["jparams"]), (r["lora"], r["jlora"])):
        jl = {"/".join(str(k.key) for k in p): np.asarray(x)
              for p, x in jax.tree_util.tree_leaves_with_path(jtree)}
        tl = {"/".join(p): x for p, x in _leaves(tree)}
        assert tl.keys() == jl.keys()
        for k, x in tl.items():
            np.testing.assert_array_equal(x.numpy(), jl[k])
    bad = to_np(r["jparams"])
    del bad["decoder"]["cross_attn"]["wk"]["b"]
    with pytest.raises(ValueError, match="paths differ"):
        params_from_numpy(r["m"], bad)
    bad = to_np(r["jlora"])
    bad["encoder"]["mlp"]["down"]["a"] = bad["encoder"]["mlp"]["down"]["a"][1:]
    with pytest.raises(ValueError, match="shape"):
        lora_from_numpy(r["m"], bad)


def test_encode_matches_jax():
    r = rig()
    je = r["jm"].model.encode(r["jparams"], jnp.asarray(r["audio"]),
                              lora=r["jlora"])
    e = r["m"].model.encode(r["params"], torch.from_numpy(r["audio"]),
                            lora=r["lora"])
    assert e.shape == (N_TASKS, 16, 128)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=LM_RTOL,
                               atol=LM_ATOL)


@pytest.mark.parametrize("with_lora", [False, True])
def test_forward_logits_match_jax(with_lora):
    r = rig()
    jl = r["jm"].model.forward(r["jparams"], jnp.asarray(r["tokens"]),
                               jnp.asarray(r["audio"]),
                               lora=r["jlora"] if with_lora else None)
    tl = r["m"].forward(r["params"], torch.from_numpy(r["tokens"]),
                        lora=r["lora"] if with_lora else None,
                        audio_embeds=torch.from_numpy(r["audio"]))
    assert tl.shape == (N_TASKS, PROMPT, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)


def test_prefill_then_decode_logits_and_caches_match_jax():
    """A 6-token prefill over 16 frames, then three decode steps: logits
    at each step, the cross cache and the self-attention cache."""
    r = rig()
    jm, m = r["jm"], r["m"]
    jbatch = {"tokens": jnp.asarray(r["tokens"]),
              "audio_embeds": jnp.asarray(r["audio"])}
    jl, jc = jm.prefill_step(r["jparams"], r["jlora"], jbatch,
                             jm.init_cache(N_TASKS, 16))
    tc = m.init_cache(N_TASKS, 16)
    assert tc["cross"]["k"].shape == (2, N_TASKS, 16, 4, 32)
    assert tc["self"]["kpos"].shape == (2, 16)
    tl, tc = m.prefill_step(r["params"], r["lora"],
                            {"tokens": torch.from_numpy(r["tokens"]),
                             "audio_embeds": torch.from_numpy(r["audio"])},
                            tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)
    for f in ("k", "v"):
        np.testing.assert_allclose(tc["cross"][f].numpy(),
                                   np.asarray(jc["cross"][f]), rtol=LM_RTOL,
                                   atol=LM_ATOL)
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for pos in (PROMPT, PROMPT + 1, PROMPT + 2):
        jl, jc = jm.decode_fn(r["jparams"], r["jlora"],
                              {"tokens": jnp.asarray(nxt)}, jc,
                              jnp.int32(pos))
        tl, tc = m.decode_fn(r["params"], r["lora"],
                             {"tokens": torch.from_numpy(nxt)}, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL)
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(tc["self"]["kpos"].numpy(),
                                  np.asarray(jc["self"]["kpos"]))
    for f in ("k", "v"):
        np.testing.assert_allclose(tc["self"][f].numpy(),
                                   np.asarray(jc["self"][f]), rtol=LM_RTOL,
                                   atol=LM_ATOL)


def test_prefill_and_decode_equal_the_full_forward():
    """The port holds itself as the JAX package's test_serving holds
    JAX: a prefill of S - 1 tokens, then one decode step, give the full
    forward's logits at S - 2 and S - 1."""
    r = rig()
    m = r["m"]
    toks = torch.from_numpy(r["tokens"])
    audio = torch.from_numpy(r["audio"])
    full = m.forward(r["params"], toks, lora=r["lora"], audio_embeds=audio)
    cache = m.init_cache(N_TASKS, 16)
    pl, cache = m.prefill_step(r["params"], r["lora"],
                               {"tokens": toks[:, :-1],
                                "audio_embeds": audio}, cache)
    dl, _ = m.decode_fn(r["params"], r["lora"], {"tokens": toks[:, -1:]},
                        cache, PROMPT - 1)
    np.testing.assert_allclose(pl.numpy(), full[:, -2].numpy(),
                               rtol=LM_RTOL, atol=LM_ATOL)
    np.testing.assert_allclose(dl.numpy(), full[:, -1].numpy(),
                               rtol=LM_RTOL, atol=LM_ATOL)


def test_position_clamp_past_max_dec_len_matches_jax():
    """``lax.dynamic_slice_in_dim`` clamps its start: a token at position
    450 or 500 reads row 447 of the 448-row table, as at 447; a 3-token
    window at 446 starts at 445.  The port reads the same rows, and a
    decode step at 450 gives JAX's logits."""
    r = rig()
    jm, m = r["jm"].model, r["m"].model
    tok = r["tokens"][:, :1]
    for offset, s, row in ((447, 1, 447), (450, 1, 447), (500, 1, 447),
                           (446, 3, 445), (0, 1, 0)):
        toks = r["tokens"][:, :s]
        je = jm._dec_embed(r["jparams"], jnp.asarray(toks), offset=offset)
        te = m._dec_embed(r["params"], torch.from_numpy(toks), offset=offset)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        table = r["params"]["pos_embed"]["table"]
        want = (m.embed(r["params"]["embed"], torch.from_numpy(toks))
                + table[row:row + s][None])
        np.testing.assert_array_equal(te.numpy(), want.numpy())
    with pytest.raises(ValueError, match="max_dec_len"):
        m._dec_embed(r["params"], torch.zeros((1, 449), dtype=torch.long))
    jc = r["jm"].init_cache(N_TASKS, 16)
    tc = r["m"].init_cache(N_TASKS, 16)
    batch = {"tokens": r["tokens"], "audio_embeds": r["audio"]}
    _, jc = r["jm"].prefill_step(r["jparams"], r["jlora"],
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jc)
    _, tc = r["m"].prefill_step(r["params"], r["lora"],
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tc)
    jl, _ = r["jm"].decode_fn(r["jparams"], r["jlora"],
                              {"tokens": jnp.asarray(tok)}, jc,
                              jnp.int32(450))
    tl, _ = r["m"].decode_fn(r["params"], r["lora"],
                             {"tokens": torch.from_numpy(tok)}, tc, 450)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
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
    assert space.d == 18_448
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
def test_every_site_of_both_stacks_fused_and_kernel9_counted(packed,
                                                             monkeypatch):
    """All 8 sites of both stacks take the fused route (words, base and τ
    bitwise JAX's router's, λ and α to rtol 1e-5); a prefill calls kernel
    9 2·(3 + 5)·L times, a decode step 2·5·L times (the encoder runs at
    prefill only)."""
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
    cache = m.init_cache(N_TASKS, 16)
    logits, _ = m.prefill_step(r["params"], tree,
                               {"tokens": torch.from_numpy(r["tokens"]),
                                "audio_embeds": torch.from_numpy(r["audio"])},
                               cache, mode="ref")
    assert len(calls) == 2 * (3 + 5) * n
    assert sorted(set(calls)) == [PROMPT, m.cfg.enc_frames]
    assert calls.count(m.cfg.enc_frames) == 2 * 3 * n
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    m.decode_fn(r["params"], tree, {"tokens": tok}, cache, PROMPT, mode="ref")
    assert len(calls) == 2 * (3 + 5) * n + 2 * 5 * n
    assert set(calls[2 * 8 * n:]) == {1}


@functools.lru_cache(maxsize=None)
def jax_tokens(packed, fused):
    r = rig()
    jstore, _ = stores(packed)
    jm = r["jm"]
    lora = j_route_batch(jstore, IDS, fused=fused)
    cache = jm.init_cache(N_TASKS, PROMPT + N_NEW + 8)
    logits, cache = jm.prefill_step(
        r["jparams"], lora, {"tokens": jnp.asarray(r["tokens"]),
                             "audio_embeds": jnp.asarray(r["audio"])}, cache)
    out = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for pos in range(PROMPT, PROMPT + N_NEW - 1):
        logits, cache = jm.decode_fn(r["jparams"], lora,
                                     {"tokens": out[-1][:, None]}, cache,
                                     jnp.int32(pos))
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return np.concatenate([r["tokens"], np.asarray(jnp.stack(out, 1))], 1)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_greedy_tokens_match_jax(packed, fused):
    """A mixed batch (tasks 2, 0, 3, 2) through the port's store, router,
    model (plain versions) and ``chip_smoke.served_generate``'s greedy
    loop gives JAX's tokens on the same downlink layout, on both
    routes."""
    r = rig()
    _, store = stores(packed)
    lora = route_batch(store, IDS, fused=fused)
    batch = {"tokens": torch.from_numpy(r["tokens"]),
             "audio_embeds": torch.from_numpy(r["audio"])}
    out = served_generate(torch, r["m"], r["params"], lora, batch, N_NEW,
                          mode="ref").numpy()
    assert out.shape == (N_TASKS, PROMPT + N_NEW)
    np.testing.assert_array_equal(out, jax_tokens(packed, fused))
