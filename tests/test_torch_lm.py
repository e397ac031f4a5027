"""The port's language model (``repro_torch.models``, ``repro_torch.nn``)
against the JAX package's, on the CPU, at the reduced qwen2-0.5b config
(2 layers, d_model 128, fp32): the JAX model's random parameters and a
LoRA tree with nonzero ``b`` are carried into the port with
``params_from_numpy`` / ``lora_from_numpy``, and both packages run the
same tokens.

Tolerances: logits of forward, prefill and decode step to rtol 1e-4,
atol 1e-5 (fp32 matmuls sum in another order in XLA and in torch, and
RoPE's pow/cos/sin may differ by an ulp); greedy tokens identical; the
manifest and fingerprint of the full-width LoRA tree identical (shapes
only, nothing is allocated).
"""

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
from repro.nn.attention import Attention as JAttention  # noqa: E402
from repro.nn.rope import apply_rope as j_apply_rope  # noqa: E402
from repro.serve import GenerationConfig as JGenCfg  # noqa: E402
from repro.serve import generate as j_generate  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.configs.base import SHAPES, load_arch  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.nn.attention import Attention  # noqa: E402
from repro_torch.nn.rope import apply_rope  # noqa: E402
from repro_torch.serve import GenerationConfig, generate  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-4, 1e-5


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=1)
def rig():
    """Reduced qwen2 in both packages, same parameters; a LoRA tree with
    b ~ 0.05 N(0, 1) so the adapters change the logits."""
    jcfg = j_load_arch("qwen2-0.5b").reduced()
    jm = jcfg.build(J_SHAPES["decode_32k"])
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora = jm.lora_init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    jlora = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                      x.dtype)
                      if str(p[-1].key) == "b" else x), jlora)
    cfg = load_arch("qwen2-0.5b").reduced()
    m = cfg.build(SHAPES["decode_32k"], device="cpu")
    params = params_from_numpy(m, to_np(jparams))
    lora = lora_from_numpy(m, to_np(jlora))
    tokens = np.random.default_rng(3).integers(1, cfg.vocab, (3, 10))
    return jm, jparams, jlora, m, params, lora, tokens


def test_reduced_config_matches_jax():
    j, t = j_load_arch("qwen2-0.5b").reduced(), load_arch("qwen2-0.5b").reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "qkv_bias", "rope_base", "tie_embeddings", "lora_rank"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.dtype == torch.float32
    assert load_arch("qwen2-0.5b").dtype == torch.bfloat16
    assert SHAPES == {k: type(SHAPES[k])(*v.__dict__.values())
                      for k, v in J_SHAPES.items()}


def test_unported_arch_and_family_raise():
    # vit-b32 has its own ViTConfig (built by configs.vit_b32.build); a
    # name without a config raises
    assert load_arch("vit-b32").family == "vit"
    with pytest.raises(ValueError, match="not ported"):
        load_arch("llama-3-8b")
    cfg = load_arch("qwen2-0.5b").reduced()
    cfg.family = "vit"
    with pytest.raises(ValueError, match="not ported"):
        cfg.build(device="cpu")


def test_moe_with_mla_builds_an_mla_mixer():
    """The reduced deepseek builds on the CPU: an ``MLAttention`` mixer
    before the MoE, and LoRA adapters on exactly its three declared
    targets."""
    from repro_torch.common.tree import tree_leaves_with_path
    from repro_torch.nn.mla import MLAttention
    cfg = load_arch("deepseek-v2-236b").reduced()
    m = cfg.build(device="cpu")
    blk = m.model.unit_blocks[0][1]
    assert isinstance(blk.mixer, MLAttention)
    assert (blk.ffn.n_experts, blk.ffn.n_shared) == (4, 1)
    assert cfg.lora_targets() == ("mixer/wq_a", "mixer/wo",
                                  "ffn/shared/down")
    paths = ["/".join(p) for p, _ in
             tree_leaves_with_path(m.lora_init(device="meta"))]
    cfg.check_lora_targets(paths)
    assert len(paths) == 9


def test_full_width_manifest_and_fingerprint_match_jax():
    """qwen2-0.5b at full width, bf16, rank 16: d = 3,588,168 and the
    same manifest rows and fingerprint in both packages."""
    jm = j_load_arch("qwen2-0.5b").build()
    jspace = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                             jax.random.PRNGKey(1)))
    cfg = load_arch("qwen2-0.5b")
    space = TaskVectorSpace.from_tree(
        cfg.build(device="cpu").lora_init(device="meta"))
    assert space.d == jspace.d == 3_588_168
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint
    cfg.check_lora_targets([l.path for l in space.leaves])
    # the JSON round trip keeps the fingerprint, in the JAX format
    assert TaskVectorSpace.from_json(jspace.to_json()).fingerprint == \
        jspace.fingerprint
    assert space.to_json() == jspace.to_json()


def test_params_from_numpy_checks_the_tree():
    jm, jparams, _, m, params, _, _ = rig()
    tree = to_np(jparams)
    assert torch.equal(params["embed"]["table"],
                       torch.from_numpy(np.array(tree["embed"]["table"])))
    del tree["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(m, tree)
    tree = to_np(jparams)
    tree["embed"]["table"] = tree["embed"]["table"][:, :5]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(m, tree)


def test_bf16_numpy_leaf_carried_by_bits():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = tensor_from_numpy(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


@pytest.mark.parametrize("with_lora", [False, True])
def test_forward_logits_match_jax(with_lora):
    jm, jparams, jlora, m, params, lora, tokens = rig()
    jl, _ = jm.model.forward(jparams, jnp.asarray(tokens),
                             lora=jlora if with_lora else None)
    tl = m.forward(params, torch.from_numpy(tokens),
                   lora=lora if with_lora else None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_prefill_and_decode_logits_match_jax():
    jm, jparams, jlora, m, params, lora, tokens = rig()
    b, s = tokens.shape
    jc = jm.init_cache(b, 16)
    jl, jc = jm.prefill_step(jparams, jlora, {"tokens": jnp.asarray(tokens)},
                             jc)
    tc = m.init_cache(b, 16)
    tl, tc = m.prefill_step(params, lora,
                            {"tokens": torch.from_numpy(tokens)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tc["blk"]["kpos"].numpy(),
                                  np.asarray(jc["blk"]["kpos"]))
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for pos in (s, s + 1):
        jl, jc = jm.decode_fn(jparams, jlora, {"tokens": jnp.asarray(nxt)},
                              jc, jnp.int32(pos))
        tl, tc = m.decode_fn(params, lora, {"tokens": torch.from_numpy(nxt)},
                             tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tc["blk"]["k"].numpy(),
                                   np.asarray(jc["blk"]["k"]), rtol=RTOL,
                                   atol=ATOL)
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)


def test_greedy_generate_tokens_match_jax():
    jm, jparams, jlora, m, params, lora, tokens = rig()
    jout = j_generate(jm, jparams, jlora, jnp.asarray(tokens),
                      JGenCfg(max_new_tokens=6))
    tout = generate(m, params, lora, torch.from_numpy(tokens),
                    GenerationConfig(max_new_tokens=6))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(100, 107), (2, 1))
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), base=1e6)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), base=1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sliding_window_ring_buffer_matches_jax():
    """A window of 4 against a 6-token prompt: prefill keeps the trailing
    window in the ring (slot = pos % 4), and decode steps overwrite it;
    GQA with 4 query heads over 2 KV heads."""
    kw = dict(head_dim=8, qkv_bias=True, rope_base=1e4, window=4)
    ja = JAttention(32, 4, 2, **kw)
    jp = ja.init(jax.random.PRNGKey(2))
    ta = Attention(32, 4, 2, **kw)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    pos = np.tile(np.arange(6), (2, 1))
    jc = ja.init_cache(2, 16)
    tc = ta.init_cache(2, 16)
    assert tc["k"].shape == (2, 4, 2, 8)
    jy, jc = ja.prefill(jp, jnp.asarray(x), jc, positions=jnp.asarray(pos),
                        impl="full")
    ty, tc = ta.prefill(tp, torch.from_numpy(x), tc,
                        positions=torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    for p in (6, 7, 8):
        xs = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jc = ja.decode_step(jp, jnp.asarray(xs), jc, jnp.int32(p))
        ty, tc = ta.decode_step(tp, torch.from_numpy(xs), tc, p)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(tc["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))
