"""The port's hybrid family (hymba-1.5b) against the JAX package's, on
the CPU, on the same numpy inputs.

1. The pieces: ``Mamba`` (forward with and without LoRA, two halves
   against one whole with the conv and ssm states, prefill then decode
   steps with the cache, softplus above 20, the blocked scan against the
   step-by-step form) and ``HybridMixer`` (full sequence, ``_fuse``;
   prefill and decode through a 16-slot ring), in fp32 and bf16.
2. hymba-1.5b at full width, shapes only: parameter and LoRA trees,
   d = 13,467,808, fingerprint ``4bc1bfd3518aa5c5``.
3. The reduced hymba (2 layers, d_model 128, 4 heads / kv 2, d_state 8,
   window 16, LoRA rank 4, fp32): forward logits; a 40-token prefill
   (past the window: the trailing-window write) and decode steps past
   it, logits and both caches; prefill + decode against the full
   forward; one MaTU round, both downlink layouts, both routes, every
   LoRA site fused, kernel-9 calls counted, greedy tokens against JAX's
   ``MultiTenantDecoder.generate``.

Tolerances: fp32 pieces (Mamba and mixer outputs, the ssm state) rtol
1e-5 / atol 1e-6 (the recurrence's Σ_n h·C and the projections sum in
another order than XLA's; the fp32 exp differs from XLA's by an ulp);
fp32 logits and caches of a whole stack rtol 1e-4 / atol 1e-5 (the bar
of the other families' tests); bf16 outputs within 2^-7 of the output
scale, one bf16 ulp at the largest magnitude (the port rounds where the
reference does, op for op, and matches eager JAX bitwise here, but XLA
may keep excess precision through a fused bf16 chain); the conv state,
``kpos``, packed words, route leaves and greedy tokens identical; the
blocked scan bitwise its step-by-step form.
"""

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
from repro.models.blocks import HybridMixer as JHybridMixer  # noqa: E402
from repro.nn.attention import Attention as JAttention  # noqa: E402
from repro.nn.ssm import Mamba as JMamba  # noqa: E402
from repro.serve import GenerationConfig as JGenCfg  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import MultiTenantDecoder as JDecoder  # noqa: E402
from repro.serve import route_batch as j_route_batch  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.configs.base import PORTED_ARCHS, load_arch  # noqa: E402
from repro_torch.core.client import ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402
from repro_torch.models.blocks import HybridMixer  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.nn import ssm as ssm_mod  # noqa: E402
from repro_torch.nn.attention import Attention  # noqa: E402
from repro_torch.nn.ssm import Mamba  # noqa: E402
from repro_torch.serve import (GenerationConfig, ModulatorStore,  # noqa: E402
                               MultiTenantDecoder, route_batch)

jax.config.update("jax_platform_name", "cpu")

ARCH = "hymba-1.5b"
RTOL, ATOL = 1e-5, 1e-6            # one piece in fp32
LM_RTOL, LM_ATOL = 1e-4, 1e-5      # a whole stack in fp32
BF16_TOL = 2.0 ** -7
D, N_STATE, B, S = 64, 8, 3, 20
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
N_TASKS, PROMPT, N_NEW = 4, 40, 5
CLIENT_TASKS = [[0, 1], [1, 2], [2, 3], [0, 3], [0, 2], [1, 3]]
IDS = [2, 0, 3, 2]
SITES = sorted(f"units/blk/{s}" for s in (
    "mixer/attn/wq", "mixer/attn/wo", "mixer/mamba/in_proj",
    "mixer/mamba/out_proj", "ffn/down"))


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


# ---------------------------------------------------------------------------
# 1. the pieces
# ---------------------------------------------------------------------------

def mamba_pair(dtype, seed=0, lora=True):
    jdt, tdt = DTYPES[dtype]
    jm = JMamba(D, d_state=N_STATE, dtype=jdt)
    m = Mamba(D, d_state=N_STATE, dtype=tdt)
    jp = jm.init(jax.random.PRNGKey(seed))
    jl = (perturbed(jm.lora_init(jax.random.PRNGKey(seed + 1), 4), seed + 2)
          if lora else None)
    return jm, jp, jl, m, to_torch(jp), to_torch(jl) if lora else None


def test_mamba_init_shapes_and_fp32_leaves_on_meta():
    m = Mamba(1600, d_state=16, dtype=torch.bfloat16)
    assert (m.d_inner, m.dt_rank) == (3200, 100)
    p = m.init(None, "meta", lead=(3,))
    assert p["in_proj"]["w"].shape == (3, 1600, 6400)
    assert p["x_proj"]["w"].shape == (3, 3200, 132)
    assert p["dt_proj"]["b"].shape == (3, 3200)
    assert p["conv"]["w"].shape == (3, 4, 3200)
    assert p["a_log"].shape == (3, 3200, 16)
    assert p["a_log"].dtype == p["d"].dtype == torch.float32
    assert p["in_proj"]["w"].dtype == torch.bfloat16
    c = m.init_cache(8, 0, device="meta", lead=(32,))
    assert c["ssm"].shape == (32, 8, 3200, 16)
    assert c["ssm"].dtype == torch.float32
    assert c["conv"].shape == (32, 8, 3, 3200)
    assert c["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_matches_jax(dtype, with_lora):
    """Output and final (ssm, conv) state from a zero state."""
    jm, jp, jl, m, p, lora = mamba_pair(dtype, lora=with_lora)
    jx, x = x_in(3, (B, S, D), DTYPES[dtype][0])
    jy, jst = jm.forward(jp, jx, lora=jl)
    y, st = m.forward(p, x, lora=lora)
    assert y.shape == (B, S, D)
    assert_close(y, jy, dtype)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]),
                               rtol=RTOL, atol=ATOL)
    assert_close(st["conv"], jst["conv"], dtype)
    assert torch.equal(m(p, x, lora=lora), y)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_two_halves_equal_one_whole(dtype):
    """A forward over the first 13 steps, then one over the last 7 from
    its state, gives the whole forward's outputs and final state (conv
    and ssm), and JAX's."""
    jm, jp, jl, m, p, lora = mamba_pair(dtype, seed=4)
    jx, x = x_in(5, (B, S, D), DTYPES[dtype][0])
    y, st = m.forward(p, x, lora=lora)
    y1, st1 = m.forward(p, x[:, :13], lora=lora)
    assert torch.equal(st1["conv"], x_conv_tail(m, p, x[:, :13], lora))
    y2, st2 = m.forward(p, x[:, 13:], lora=lora, state=st1)
    assert st2 is st1                       # updated in place
    halves = torch.cat([y1, y2], dim=1)
    assert_close(halves, y.numpy() if dtype == "float32"
                 else y.float().numpy(), dtype)
    np.testing.assert_allclose(st2["ssm"].numpy(), st["ssm"].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(st2["conv"], st["conv"])
    jy, jst = jm.forward(jp, jx, lora=jl)
    assert_close(halves, jy, dtype)
    np.testing.assert_allclose(st2["ssm"].numpy(), np.asarray(jst["ssm"]),
                               rtol=RTOL, atol=ATOL)
    assert_close(st2["conv"], jst["conv"], dtype)


def x_half(m, p, x, lora):
    """in_proj's x half over ``x`` (the conv's input)."""
    return m.in_proj(p["in_proj"], x, lora["in_proj"])[..., :m.d_inner]


def x_conv_tail(m, p, x, lora):
    """The conv state a forward over ``x`` must leave: in_proj's x half
    of its last conv_kernel - 1 steps."""
    return x_half(m, p, x, lora)[:, -(m.conv_kernel - 1):]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_prefill_then_decode_steps_match_jax(dtype):
    """A 9-step prefill into a cache, then four decode steps (the forward
    at S = 1 from the cache, updated in place): outputs and both states
    against JAX's at every step; the conv state is the last three
    inputs' x half each time."""
    jdt = DTYPES[dtype][0]
    jm, jp, jl, m, p, lora = mamba_pair(dtype, seed=6)
    jx, x = x_in(7, (B, 13, D), jdt)
    cache = m.init_cache(B, 0, dtype=DTYPES[dtype][1])
    jy, jc = jm.prefill(jp, jx[:, :9], lora=jl,
                        state=jm.init_cache(B, dtype=jdt))
    y, c = m.prefill(p, x[:, :9], lora=lora, state=cache)
    assert c is cache
    assert_close(y, jy, dtype)
    rows = x_half(m, p, x[:, :9], lora)
    for t in range(9, 13):
        jy, jc = jm.decode_step(jp, jx[:, t:t + 1], jc, t, lora=jl)
        y, c = m.decode_step(p, x[:, t:t + 1], cache, t, lora=lora)
        assert c is cache
        assert_close(y, jy, dtype)
        np.testing.assert_allclose(cache["ssm"].numpy(),
                                   np.asarray(jc["ssm"]), rtol=RTOL,
                                   atol=ATOL)
        assert_close(cache["conv"], jc["conv"], dtype)
        rows = torch.cat([rows, x_half(m, p, x[:, t:t + 1], lora)], 1)
        assert torch.equal(cache["conv"], rows[:, -3:])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_softplus_above_20_matches_jax(dtype):
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``, op for op: no
    threshold.  Around and above 20 bitwise JAX's; elsewhere bitwise in
    bf16 and within rtol 1e-6 in fp32 (torch's fp32 exp and log1p round
    otherwise than XLA's, by an ulp), except below -87, where XLA on the
    CPU flushes a subnormal result to zero and torch keeps it (within
    fp32's smallest normal there); and in a Mamba whose dt_proj bias
    drives dt past 20 on half its channels."""
    jdt, _ = DTYPES[dtype]
    jx, x = x_in(8, (4096,), jdt)
    jx = jnp.concatenate([jx * 30, jnp.asarray(
        [19.5, 20.0, 20.5, 21.0, 25.0, 40.0, 90.0, -25.0, -90.0], jdt)])
    x = tensor_from_numpy(np.asarray(jx))
    got = ssm_mod._softplus(x).float().numpy()
    want = np.asarray(jax.nn.softplus(jx)).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    normal = np.abs(want) >= tiny
    np.testing.assert_allclose(got[normal], want[normal],
                               rtol=0 if dtype == "bfloat16" else 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=tiny)
    assert (got[-9:-2] == want[-9:-2]).all() and want[-5] == 25.0
    jm, jp, jl, m, p, lora = mamba_pair(dtype, seed=9)
    big = np.where(np.arange(m.d_inner) % 2, 25.0, -3.0)
    jp["dt_proj"]["b"] = jnp.asarray(big, jdt)
    p["dt_proj"]["b"] = tensor_from_numpy(np.asarray(jp["dt_proj"]["b"]))
    jxx, xx = x_in(10, (B, S, D), jdt)
    jy, jst = jm.forward(jp, jxx, lora=jl)
    y, st = m.forward(p, xx, lora=lora)
    assert_close(y, jy, dtype)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s", [1, ssm_mod.MAMBA_SCAN_BLOCK,
                               2 * ssm_mod.MAMBA_SCAN_BLOCK + 3])
def test_mamba_scan_blocks_bitwise_the_step_by_step_form(s):
    """exp(dt·a) and (dt·x)·B computed a block of steps at a time give
    the bits of the reference's step-by-step form: final state and every
    step's y."""
    rng = np.random.default_rng(s)
    b, din, n = 3, 37, 5
    a = -torch.from_numpy(rng.uniform(0.5, 16, (din, n)).astype(np.float32))
    xc = torch.from_numpy(rng.standard_normal((b, s, din)).astype(
        np.float32)).to(torch.bfloat16)
    dt = torch.from_numpy(rng.uniform(0, 2, (b, s, din)).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(
        np.float32)) for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((b, din, n)).astype(
        np.float32))
    h, ys = Mamba._scan(a, xc, dt, bm, cm, h0)
    want, hw = [], h0
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)
        hw = da * hw + (dt[:, t] * xc[:, t].float())[..., None] * bm[:, t,
                                                                     None, :]
        want.append(torch.matmul(hw, cm[:, t, :, None])[..., 0])
    assert torch.equal(h, hw)
    assert torch.equal(ys, torch.stack(want, dim=1))


def mixer_pair(dtype, window=None, seed=11):
    jdt, tdt = DTYPES[dtype]
    ja = JAttention(D, 4, 2, window=window, dtype=jdt)
    jmix = JHybridMixer(D, ja, JMamba(D, d_state=N_STATE, dtype=jdt),
                        dtype=jdt)
    mix = HybridMixer(D, Attention(D, 4, 2, window=window, dtype=tdt),
                      Mamba(D, d_state=N_STATE, dtype=tdt), dtype=tdt)
    jp = jmix.init(jax.random.PRNGKey(seed))
    jp["beta"] = jnp.asarray([0.75, 1.375], jdt)
    jl = perturbed(jmix.lora_init(jax.random.PRNGKey(seed + 1), 4), seed + 2)
    return jmix, jp, jl, mix, to_torch(jp), to_torch(jl)


def test_hybrid_mixer_init_and_lora_trees_on_meta():
    mix = HybridMixer(D, Attention(D, 4, 2), Mamba(D, d_state=N_STATE))
    p = mix.init(None, "meta", lead=(2,))
    assert sorted(p) == ["attn", "beta", "mamba", "norm_a", "norm_m"]
    assert p["beta"].shape == (2, 2)
    assert p["norm_m"]["scale"].shape == (2, D)
    lora = mix.lora_init(None, 4, "meta", lead=(2,))
    assert {k: sorted(v) for k, v in lora.items()} == {
        "attn": ["wo", "wq"], "mamba": ["in_proj", "out_proj"]}
    c = mix.init_cache(3, 40, device="meta")
    assert sorted(c) == ["attn", "mamba"]
    assert c["attn"]["k"].shape == (3, 40, 2, 16)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hybrid_mixer_matches_jax(dtype):
    """The full-sequence mixer (causal attention ‖ Mamba, β = (0.75,
    1.375)) with LoRA on its four sites."""
    jmix, jp, jl, mix, p, lora = mixer_pair(dtype)
    jx, x = x_in(12, (B, S, D), DTYPES[dtype][0])
    pos = np.broadcast_to(np.arange(S), (B, S))
    jy = jmix(jp, jx, positions=jnp.asarray(pos), lora=jl)
    y = mix(p, x, positions=torch.from_numpy(pos.copy()), lora=lora)
    assert_close(y, jy, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fuse_matches_jax(dtype):
    """0.5·(β0·norm_a(ya) + β1·norm_m(ym)) in the model dtype, with
    norm scales and β away from 1: bitwise JAX's in bf16 (each op rounds
    to bf16 in both), within the fp32 bar in fp32 (the norms' mean and
    rsqrt round otherwise than XLA's)."""
    jdt, _ = DTYPES[dtype]
    jmix, jp, _, mix, p, _ = mixer_pair(dtype)
    for k, seed in (("norm_a", 13), ("norm_m", 14)):
        jp[k]["scale"] = x_in(seed, (D,), jdt)[0]
        p[k]["scale"] = tensor_from_numpy(np.asarray(jp[k]["scale"]))
    (jya, ya), (jym, ym) = x_in(15, (B, S, D), jdt), x_in(16, (B, S, D), jdt)
    got = mix._fuse(p, ya * 3, ym)
    want = jmix._fuse(jp, jya * 3, jym)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
    else:
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hybrid_mixer_prefill_and_decode_through_a_ring_match_jax(dtype):
    """Window 8 and a 6-slot cache: an 11-token prefill keeps its
    trailing 6 keys (slot = pos % 6), then four decode steps wrap the
    ring again; outputs, kpos and both branches' caches against JAX's."""
    jdt, tdt = DTYPES[dtype]
    jmix, jp, jl, mix, p, lora = mixer_pair(dtype, window=8, seed=17)
    jx, x = x_in(18, (B, 15, D), jdt)
    jc = jmix.init_cache(B, 6, jdt)
    c = mix.init_cache(B, 6, tdt)
    assert c["attn"]["k"].shape[1] == 6
    pos = np.broadcast_to(np.arange(11), (B, 11))
    jy, jc = jmix.prefill(jp, jx[:, :11], jc, positions=jnp.asarray(pos),
                          lora=jl)
    y, c2 = mix.prefill(p, x[:, :11], c, positions=torch.from_numpy(
        pos.copy()), lora=lora)
    assert c2["attn"] is c["attn"] and c2["mamba"] is c["mamba"]
    assert_close(y, jy, dtype)
    np.testing.assert_array_equal(c["attn"]["kpos"].numpy(),
                                  [6, 7, 8, 9, 10, 5])
    for t in range(11, 15):
        jy, jc = jmix.decode_step(jp, jx[:, t:t + 1], jc, jnp.int32(t),
                                  lora=jl)
        y, _ = mix.decode_step(p, x[:, t:t + 1], c, t, lora=lora)
        assert_close(y, jy, dtype)
        np.testing.assert_array_equal(c["attn"]["kpos"].numpy(),
                                      np.asarray(jc["attn"]["kpos"]))
        for br, f in (("attn", "k"), ("attn", "v"), ("mamba", "conv")):
            assert_close(c[br][f], jc[br][f], dtype)
        np.testing.assert_allclose(c["mamba"]["ssm"].numpy(),
                                   np.asarray(jc["mamba"]["ssm"]), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(c["attn"]["kpos"].numpy(),
                                  [12, 13, 14, 9, 10, 11])


# ---------------------------------------------------------------------------
# 2. full width, shapes only
# ---------------------------------------------------------------------------

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
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "source", "qkv_bias",
                  "rope_base", "tie_embeddings", "head_dim", "ssm_state",
                  "hybrid_window", "lora_rank", "sliding_window_long"):
            assert getattr(j, f) == getattr(t, f), (reduce, f)
        assert t.lora_targets() == j.lora_targets()
    assert load_arch(ARCH).dtype == torch.bfloat16
    assert load_arch(ARCH).reduced().dtype == torch.float32


def test_full_width_trees_manifest_and_fingerprint_match_jax():
    """hymba at full width: the same 1,662,161,664 parameters in the same
    paths and shapes (``a_log`` and ``d`` fp32 in the bf16 model), 15
    LoRA leaves on the five sites, d = 13,467,808 and fingerprint
    ``4bc1bfd3518aa5c5`` in both packages; every site's factor is
    word-aligned, so all take the fused route; the attention's window is
    2,048, so its cache is a 2,048-slot ring."""
    assert ARCH in PORTED_ARCHS
    jm = j_load_arch(ARCH).build()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jspace = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                             jax.random.PRNGKey(1)))
    m = load_arch(ARCH).build(device="cpu")
    jshapes = {"/".join(str(k.key) for k in p): (tuple(x.shape),
                                                 str(x.dtype))
               for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    tshapes = {"/".join(p): (tuple(x.shape), str(x.dtype)[6:])
               for p, x in _leaves(m.init(device="meta"))}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s, _ in tshapes.values()) == 1_662_161_664
    assert tshapes["units/blk/mixer/mamba/a_log"] == ((32, 3200, 16),
                                                      "float32")
    space = TaskVectorSpace.from_tree(m.lora_init(device="meta"))
    assert space.d == jspace.d == 13_467_808
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint == "4bc1bfd3518aa5c5"
    assert [l.path for l in space.leaves] == [
        f"{s}/{f}" for s in SITES for f in ("a", "alpha", "b")]
    m.cfg.check_lora_targets([l.path for l in space.leaves])
    for l in space.leaves:
        if l.path.endswith(("/a", "/b")):
            assert (l.size // 32) % bitpack.WORD_BITS == 0
    attn = m.model.unit_blocks[0][1].mixer.attn
    assert attn.window == 2048 and attn.cache_len(2080) == 2048


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        load_arch(ARCH).build()


# ---------------------------------------------------------------------------
# 3. the reduced hymba: model, round, store, routes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def rig():
    jm = j_load_arch(ARCH).reduced().build()
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora0 = jm.lora_init(jax.random.PRNGKey(1))
    jlora = perturbed(jlora0, 5)
    m = load_arch(ARCH).reduced().build(device="cpu")
    tokens = np.random.default_rng(3).integers(
        1, m.cfg.vocab, (N_TASKS, PROMPT)).astype(np.int32)
    return dict(jm=jm, jparams=jparams, jlora0=jlora0, jlora=jlora, m=m,
                params=params_from_numpy(m, to_np(jparams)),
                lora0=lora_from_numpy(m, to_np(jlora0)),
                lora=lora_from_numpy(m, to_np(jlora)), tokens=tokens)


def test_params_and_lora_carry_across_leaf_for_leaf():
    """Every converted leaf equals the JAX leaf, in a bf16 model too,
    where ``a_log`` and ``d`` stay fp32; a tree missing a leaf or with a
    leaf of another shape is refused."""
    import dataclasses
    r = rig()
    jm16 = dataclasses.replace(j_load_arch(ARCH).reduced(),
                               dtype=jnp.bfloat16).build()
    m16 = dataclasses.replace(load_arch(ARCH).reduced(),
                              dtype=torch.bfloat16).build(device="cpu")
    jp16 = jm16.init(jax.random.PRNGKey(2))
    p16 = params_from_numpy(m16, to_np(jp16))
    assert p16["units"]["blk"]["mixer"]["mamba"]["a_log"].dtype == \
        torch.float32
    assert p16["units"]["blk"]["mixer"]["beta"].dtype == torch.bfloat16
    for tree, jtree in ((r["params"], r["jparams"]), (r["lora"], r["jlora"]),
                        (p16, jp16)):
        jl = {"/".join(str(k.key) for k in p): np.asarray(x)
              for p, x in jax.tree_util.tree_leaves_with_path(jtree)}
        tl = {"/".join(p): x for p, x in _leaves(tree)}
        assert tl.keys() == jl.keys()
        for k, x in tl.items():
            assert str(x.dtype)[6:] == str(jl[k].dtype), k
            np.testing.assert_array_equal(x.float().numpy(),
                                          jl[k].astype(np.float32))
    bad = to_np(r["jparams"])
    del bad["units"]["blk"]["mixer"]["mamba"]["a_log"]
    with pytest.raises(ValueError, match="paths differ"):
        params_from_numpy(r["m"], bad)
    bad = to_np(r["jlora"])
    mam = bad["units"]["blk"]["mixer"]["mamba"]
    mam["in_proj"]["b"] = mam["in_proj"]["b"][:, 1:]
    with pytest.raises(ValueError, match="shape"):
        lora_from_numpy(r["m"], bad)


@pytest.mark.parametrize("with_lora", [False, True])
def test_forward_logits_match_jax(with_lora):
    """40 tokens through the windowed (16) attention ‖ Mamba layers."""
    r = rig()
    jl, _ = r["jm"].model.forward(r["jparams"], jnp.asarray(r["tokens"]),
                                  lora=r["jlora"] if with_lora else None)
    tl = r["m"].forward(r["params"], torch.from_numpy(r["tokens"]),
                        lora=r["lora"] if with_lora else None)
    assert tl.shape == (N_TASKS, PROMPT, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)


def test_prefill_then_decode_logits_and_caches_match_jax():
    """A 40-token prefill into a 16-slot ring (longer than the window:
    the trailing 16 keys, slot = pos % 16), then five decode steps at
    positions 40-44, which overwrite slots 8-12: logits at each step and
    every cache leaf."""
    r = rig()
    jm, m = r["jm"], r["m"]
    jc = jm.init_cache(N_TASKS, 64)
    tc = m.init_cache(N_TASKS, 64)
    mix = tc["blk"]
    assert mix["attn"]["k"].shape == (2, N_TASKS, 16, 2, 32)
    assert mix["mamba"]["ssm"].shape == (2, N_TASKS, 256, 8)
    assert mix["mamba"]["conv"].shape == (2, N_TASKS, 3, 256)
    jl, jc = jm.prefill_step(r["jparams"], r["jlora"],
                             {"tokens": jnp.asarray(r["tokens"])}, jc)
    tl, _ = m.prefill_step(r["params"], r["lora"],
                           {"tokens": torch.from_numpy(r["tokens"])}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)
    want_kpos = np.array([32 + i if i < 8 else 16 + i for i in range(16)])
    np.testing.assert_array_equal(mix["attn"]["kpos"].numpy(),
                                  np.stack([want_kpos] * 2))
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for pos in range(PROMPT, PROMPT + 5):
        jl, jc = jm.decode_fn(r["jparams"], r["jlora"],
                              {"tokens": jnp.asarray(nxt)}, jc,
                              jnp.int32(pos))
        tl, _ = m.decode_fn(r["params"], r["lora"],
                            {"tokens": torch.from_numpy(nxt)}, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL)
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    want_kpos[8:13] = np.arange(40, 45)
    for br, f in (("attn", "kpos"), ("attn", "k"), ("attn", "v"),
                  ("mamba", "ssm"), ("mamba", "conv")):
        np.testing.assert_allclose(mix[br][f].numpy(),
                                   np.asarray(jc["blk"][br][f]),
                                   rtol=LM_RTOL, atol=LM_ATOL, err_msg=f)
    np.testing.assert_array_equal(mix["attn"]["kpos"].numpy(),
                                  np.stack([want_kpos] * 2))


def test_prefill_and_decode_equal_the_full_forward():
    """The port holds itself as the JAX package's test_serving holds
    JAX: a prefill of S - 3 tokens, then three decode steps, give the
    full forward's logits at S - 4 .. S - 1 (the window masks the same
    keys in both)."""
    r = rig()
    m = r["m"]
    toks = torch.from_numpy(r["tokens"])
    full = m.forward(r["params"], toks, lora=r["lora"])
    cache = m.init_cache(N_TASKS, 64)
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
    assert space.d == 15_370
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
def test_every_site_fused_and_ten_kernel9_calls_a_layer(packed, monkeypatch):
    """All five sites take the fused route (words, base and τ bitwise JAX
    router's, λ and α to rtol 1e-5); a prefill and a decode step each
    call kernel 9 2·5·L times, at S = PROMPT and S = 1."""
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
    cache = m.init_cache(N_TASKS, 64)
    logits, _ = m.prefill_step(r["params"], tree,
                               {"tokens": torch.from_numpy(r["tokens"])},
                               cache, mode="ref")
    assert calls == [PROMPT] * 10 * n
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    m.decode_fn(r["params"], tree, {"tokens": tok}, cache, PROMPT, mode="ref")
    assert calls[10 * n:] == [1] * 10 * n


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
    """A mixed batch (tasks 2, 0, 3, 2) of 40-token prompts through the
    port's store and decoder (plain versions) gives the JAX decoder's
    tokens on the same downlink layout, on both routes; its decode steps
    run past the 16-slot ring's wrap."""
    r = rig()
    _, store = stores(packed)
    dec = MultiTenantDecoder(r["m"], r["params"], store, fused=fused,
                             cfg=GenerationConfig(max_new_tokens=N_NEW),
                             mode="ref", device="cpu")
    out = dec.generate(torch.from_numpy(r["tokens"]), IDS)
    assert out.shape == (N_TASKS, PROMPT + N_NEW)
    np.testing.assert_array_equal(out.numpy(), jax_tokens(packed, fused))
