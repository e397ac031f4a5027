"""The dense family's remaining configs (qwen2.5-3b, qwen2.5-32b,
codeqwen1.5-7b) against the JAX package's, on the CPU.

For each: the config field for field (published and reduced); the
full-width parameter and LoRA trees on ``meta`` against JAX's
``eval_shape`` (parameter count, d, manifest and fingerprint; every
site word-aligned); the reduced model's forward logits, with LoRA, on
converted JAX parameters.  codeqwen1.5-7b is multi-head (kv 32 = heads),
which the dense builder takes as it is.

Tolerances: logits rtol 1e-4 / atol 1e-5 (fp32 matmuls sum in another
order in XLA and in torch), the bar of the other families' stacks;
shapes, manifests and fingerprints identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.tree import TaskVectorSpace as JSpace  # noqa: E402
from repro.configs.base import load_arch as j_load_arch  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.common.tree import tree_leaves_with_path  # noqa: E402
from repro_torch.configs.base import PORTED_ARCHS, load_arch  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.nn.attention import Attention  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LM_RTOL, LM_ATOL = 1e-4, 1e-5
# (arch, parameters, LoRA d at rank 16, layout fingerprint), full width
FULL = [("qwen2.5-3b", 3_397_103_616, 12_238_956, "d2ca3f6eb147680a"),
        ("qwen2.5-32b", 32_763_876_352, 54_526_144, "cb4bc1da4e128af0"),
        ("codeqwen1.5-7b", 8_190_038_016, 17_367_136, "8b84b0e10080e1b9")]
ARCHS = [a for a, *_ in FULL]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_for_field(arch):
    assert arch in PORTED_ARCHS
    for reduce in (False, True):
        j, t = j_load_arch(arch), load_arch(arch)
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), (reduce,
                                                                  f.name)
        assert t.lora_targets() == j.lora_targets()
    assert load_arch(arch).dtype == torch.bfloat16
    assert load_arch(arch).reduced().dtype == torch.float32


@pytest.mark.parametrize("arch,n_params,d,fingerprint", FULL)
def test_full_width_trees_manifest_and_fingerprint_match_jax(
        arch, n_params, d, fingerprint):
    """Parameter paths and shapes as JAX's; the LoRA manifest, d and
    fingerprint identical; each site's factors word-aligned."""
    jm = j_load_arch(arch).build()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jspace = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                             jax.random.PRNGKey(1)))
    m = load_arch(arch).build(device="cpu")
    tshapes = {"/".join(p): tuple(x.shape)
               for p, x in tree_leaves_with_path(m.init(device="meta"))}
    assert tshapes == {"/".join(str(k.key) for k in p): tuple(x.shape)
                       for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    assert sum(int(np.prod(s)) for s in tshapes.values()) == n_params
    space = TaskVectorSpace.from_tree(m.lora_init(device="meta"))
    assert space.d == jspace.d == d
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint == fingerprint
    m.cfg.check_lora_targets([leaf.path for leaf in space.leaves])
    n_layers = m.cfg.n_layers
    for leaf in space.leaves:
        if leaf.path.endswith(("/a", "/b")):
            assert (leaf.size // n_layers) % bitpack.WORD_BITS == 0
    attn = m.model.unit_blocks[0][1].mixer
    assert isinstance(attn, Attention)
    assert (attn.n_heads, attn.n_kv) == (m.cfg.n_heads, m.cfg.n_kv_heads)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_logits_match_jax(arch):
    """The reduced model (2 layers, d_model 128, 4 heads; kv 2, or 4 for
    the multi-head codeqwen) on JAX's parameters and a LoRA tree with
    b ~ 0.05 N(0, 1): logits of 10 seeded tokens."""
    jm = j_load_arch(arch).reduced().build()
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    jlora = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                      x.dtype)
                      if str(p[-1].key) == "b" else x),
        jax.jit(jm.lora_init)(jax.random.PRNGKey(1)))
    m = load_arch(arch).reduced().build(device="cpu")
    to_np = jax.tree_util.Partial(jax.tree_util.tree_map, np.asarray)
    params = params_from_numpy(m, to_np(jparams))
    lora = lora_from_numpy(m, to_np(jlora))
    tokens = rng.integers(1, m.cfg.vocab, (3, 10)).astype(np.int32)
    jl, _ = jax.jit(jm.model.forward)(jparams, jnp.asarray(tokens),
                                      lora=jlora)
    tl = m.forward(params, torch.from_numpy(tokens), lora=lora)
    assert tl.shape == (3, 10, m.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)
