"""The port's vlm family (qwen2-vl-7b) against the JAX package's, on the
CPU, on the same numpy inputs.

1. The pieces: M-RoPE (``rope_angles`` and ``apply_rope`` with sections
   at the full (16, 24, 24) and reduced (4, 6, 6) widths, fp32 and bf16,
   at an image's grid positions, random positions and text positions;
   three equal coordinates against plain RoPE; grid against text
   positions); ``text_mrope_positions``; ``Attention`` with (B, S, 3)
   positions on the full path and the chunked loop (S 20 past q_chunk
   8), its prefill cache and decode steps; the mask's rank rule.
2. qwen2-vl-7b at full width, shapes only: parameter and LoRA trees,
   7,615,616,512 parameters, d = 16,515,156, fingerprint
   ``5ecc74948787cc41``.
3. The reduced vlm (2 layers, d_model 128, 4 heads / kv 2, head_dim 32,
   sections (4, 6, 6), LoRA rank 4, fp32), each request an image of a 2
   × 4 grid (the config's 8 vision tokens, seeded embeddings) before 12
   text tokens at Qwen2-VL's positions: forward logits; prefill and
   four decode steps (logits and every cache leaf); prefill + decode
   against the full forward; one MaTU round, both downlink layouts, both
   routes, every LoRA site fused, kernel-9 calls counted, greedy tokens
   (``chip_smoke.served_generate``) against JAX's ``route_batch`` +
   ``prefill_step`` + ``decode_fn``.

Tolerances: M-RoPE angles within an ulp of JAX's (the frequencies'
fp32 ``pow`` rounds otherwise than XLA's in a few slots); fp32 pieces
(rotary outputs, attention outputs and caches) rtol 1e-5 / atol 1e-6
(that ulp, and torch's fp32 sin and cos differ from XLA's by an ulp in
a few percent of elements, and the projections sum in another order);
fp32 logits and caches of a
whole stack rtol 1e-4 / atol 1e-5 (the bar of the other families'
tests); bf16 outputs within 2^-7 of the output scale, one bf16 ulp at
the largest magnitude (an ulp of the fp32 rotation can round to the
other bf16 neighbour); within the port, three equal coordinates give
plain RoPE's bits; ``kpos``, packed words, route leaves and greedy
tokens identical.
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
from repro.nn.attention import Attention as JAttention  # noqa: E402
from repro.nn.rope import apply_rope as j_apply_rope  # noqa: E402
from repro.nn.rope import rope_angles as j_rope_angles  # noqa: E402
from repro.nn.rope import text_mrope_positions as j_text_pos  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import route_batch as j_route_batch  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.configs.base import PORTED_ARCHS, load_arch  # noqa: E402
from repro_torch.core.client import ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.nn.attention import Attention  # noqa: E402
from repro_torch.nn.rope import (apply_rope, rope_angles,  # noqa: E402
                                 text_mrope_positions)
from repro_torch.serve import ModulatorStore, route_batch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import served_generate, vlm_positions  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "qwen2-vl-7b"
RTOL, ATOL = 1e-5, 1e-6            # one piece in fp32
LM_RTOL, LM_ATOL = 1e-4, 1e-5      # a whole stack in fp32
BF16_TOL = 2.0 ** -7
BASE = 1e6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (head_dim, sections): the full width's and the reduced config's
WIDTHS = {"full": (128, (16, 24, 24)), "reduced": (32, (4, 6, 6))}
GRID = (2, 4)                      # the reduced config's 8 vision tokens
N_TASKS, PROMPT, N_NEW = 4, 12, 5
N_IMG = GRID[0] * GRID[1]
S_ALL = N_IMG + PROMPT
CLIENT_TASKS = [[0, 1], [1, 2], [2, 3], [0, 3], [0, 2], [1, 3]]
IDS = [2, 0, 3, 2]
SITES = sorted(f"units/blk/{s}" for s in ("mixer/wq", "mixer/wo",
                                          "ffn/down"))


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


def grid_positions(b, grid, n_txt):
    """Qwen2-VL's positions of an image on ``grid`` followed by n_txt
    text tokens (``chip_smoke.vlm_positions``), as int32 numpy."""
    return vlm_positions(torch, b, grid, n_txt).numpy().copy()


def positions_of(kind, b, s, seed=0):
    """(B, S, 3) int32 positions: an image of 8 patches on a 2 × 4 grid
    and text after it ("grid"), uniform in [0, 5000) ("random"), or text
    positions 100.. on all three coordinates ("text")."""
    if kind == "grid":
        return grid_positions(b, GRID, s - N_IMG)
    if kind == "random":
        return np.random.default_rng(seed).integers(
            0, 5000, (b, s, 3)).astype(np.int32)
    pos = np.broadcast_to(np.arange(100, 100 + s, dtype=np.int32), (b, s))
    return np.repeat(pos[..., None], 3, axis=-1)


# ---------------------------------------------------------------------------
# 1. the pieces
# ---------------------------------------------------------------------------

def test_vlm_positions_layout():
    """The image's patches at (0, row, column) of its grid, the text
    after it from max(rows, columns) on all three coordinates."""
    pos = grid_positions(2, GRID, 3)
    assert pos.shape == (2, 11, 3) and pos.dtype == np.int32
    np.testing.assert_array_equal(pos[1, :8], [
        [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3],
        [0, 1, 0], [0, 1, 1], [0, 1, 2], [0, 1, 3]])
    np.testing.assert_array_equal(pos[0, 8:], [[4] * 3, [5] * 3, [6] * 3])
    full = grid_positions(1, (32, 32), 128)[0]
    assert full.shape == (1152, 3)
    np.testing.assert_array_equal(full[1023], [0, 31, 31])
    np.testing.assert_array_equal(full[1024], [32, 32, 32])


@pytest.mark.parametrize("kind", ["grid", "random", "text"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_mrope_angles_are_sections_of_each_coordinates_angles(width, kind):
    """Section i's frequency slots take their phase from coordinate i:
    the port's M-RoPE angles equal, bit for bit, its plain angles of each
    coordinate sliced to that section, and JAX's built the same way
    (JAX's M-RoPE computes its angles so, op for op) within an ulp
    (torch's fp32 ``pow`` for the frequencies differs from XLA's by an
    ulp in a few slots)."""
    hd, sec = WIDTHS[width]
    pos = positions_of(kind, 2, 20)
    got = rope_angles(torch.from_numpy(pos), hd, BASE, sec).numpy()
    mine, want, off = [], [], 0
    for i, n in enumerate(sec):
        mine.append(rope_angles(torch.from_numpy(pos[..., i]), hd,
                                BASE).numpy()[..., off:off + n])
        want.append(np.asarray(j_rope_angles(jnp.asarray(pos[..., i]), hd,
                                             BASE))[..., off:off + n])
        off += n
    assert got.shape == (2, 20, hd // 2)
    np.testing.assert_array_equal(got, np.concatenate(mine, -1))
    np.testing.assert_allclose(got, np.concatenate(want, -1), rtol=2.0 ** -22,
                               atol=0)


@pytest.mark.parametrize("kind", ["grid", "random", "text"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_apply_rope_mrope_matches_jax(width, dtype, kind):
    hd, sec = WIDTHS[width]
    jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(hd)
    jx = jnp.asarray(rng.standard_normal((3, 20, 4, hd)), jdt)
    pos = positions_of(kind, 3, 20, seed=1)
    want = j_apply_rope(jx, jnp.asarray(pos), base=BASE, mrope_sections=sec)
    got = apply_rope(tensor_from_numpy(np.asarray(jx)), torch.from_numpy(pos),
                     base=BASE, mrope_sections=sec)
    assert got.shape == (3, 20, 4, hd)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_equal_coordinates_are_plain_rope_and_the_grid_is_not(width, dtype):
    """Three equal coordinates give plain RoPE's bits (in the port, as in
    JAX), so text positions alone cannot show M-RoPE; an image's grid
    positions rotate otherwise than text positions at the same slots."""
    hd, sec = WIDTHS[width]
    _, tdt = DTYPES[dtype]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 20, 4, hd)).astype(np.float32)).to(tdt)
    flat = torch.arange(20)[None].expand(2, 20)
    plain = apply_rope(x, flat, base=BASE)
    lifted = apply_rope(x, text_mrope_positions(flat), base=BASE,
                        mrope_sections=sec)
    assert torch.equal(lifted, plain)
    jx = jnp.asarray(x.float().numpy(), DTYPES[dtype][0])
    jflat = jnp.asarray(flat.numpy())
    np.testing.assert_array_equal(
        np.asarray(j_apply_rope(jx, j_text_pos(jflat), base=BASE,
                                mrope_sections=sec)).astype(np.float32),
        np.asarray(j_apply_rope(jx, jflat, base=BASE)).astype(np.float32))
    grid = apply_rope(x, torch.from_numpy(positions_of("grid", 2, 20)),
                      base=BASE, mrope_sections=sec)
    differ = (grid != plain).any(-1).any(-1)        # (B, S) rows rotated
    assert differ[:, 1:N_IMG].all()                 # patches past (0, 0, 0)
    assert differ[:, N_IMG:].all()                  # text from 4, not 8


def test_text_mrope_positions_match_jax():
    pos = np.random.default_rng(3).integers(0, 9000, (3, 7)).astype(np.int32)
    got = text_mrope_positions(torch.from_numpy(pos))
    assert got.shape == (3, 7, 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_text_pos(jnp.asarray(pos))))


def test_mrope_refuses_bad_positions_and_sections():
    x = torch.zeros((1, 5, 2, 32))
    with pytest.raises(ValueError, match="coordinates"):
        apply_rope(x, torch.zeros((1, 5), dtype=torch.int32),
                   mrope_sections=(4, 6, 6))
    with pytest.raises(ValueError, match="sum"):
        apply_rope(x, torch.zeros((1, 5, 3), dtype=torch.int32),
                   mrope_sections=(4, 6, 8))


def attn_pair(seed, q_chunk=512):
    """JAX and port ``Attention`` (d 128, 4 heads over 2 KV heads,
    head_dim 32, QKV bias, sections (4, 6, 6)), the same parameters and
    LoRA (b perturbed)."""
    kw = dict(qkv_bias=True, rope_base=BASE, mrope_sections=(4, 6, 6))
    ja = JAttention(128, 4, 2, **kw)
    ta = Attention(128, 4, 2, q_chunk=q_chunk, **kw)
    jp = ja.init(jax.random.PRNGKey(seed))
    jl = perturbed(ja.lora_init(jax.random.PRNGKey(seed + 1), 4), seed + 2)
    return ja, jp, jl, ta, to_torch(jp), to_torch(jl)


@pytest.mark.parametrize("q_chunk", [512, 8], ids=["full", "chunked"])
def test_attention_with_3d_positions_matches_jax(q_chunk):
    """Self-attention at an image's grid positions then text (S 20;
    q_chunk 8: chunks of 8, 8 and 4), its prefill cache (``kpos``
    0..19, as JAX's) and three decode steps at positions 20..22 (rope
    at (pos, pos, pos), as JAX's ``decode_step``)."""
    ja, jp, jl, ta, tp, tl = attn_pair(4, q_chunk)
    x = np.random.default_rng(5).standard_normal((3, 23, 128)).astype(
        np.float32)
    pos = positions_of("grid", 3, 20)
    impl = "full" if q_chunk == 512 else "chunked"
    jy = ja(jp, jnp.asarray(x[:, :20]), positions=jnp.asarray(pos),
            lora=jl, impl=impl, q_chunk=q_chunk)
    y = ta(tp, torch.from_numpy(x[:, :20]), positions=torch.from_numpy(pos),
           lora=tl, impl=impl)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    jc = ja.init_cache(3, 26)
    tc = ta.init_cache(3, 26)
    jy, jc = ja.prefill(jp, jnp.asarray(x[:, :20]), jc,
                        positions=jnp.asarray(pos), lora=jl, q_chunk=q_chunk)
    yp, _ = ta.prefill(tp, torch.from_numpy(x[:, :20]), tc,
                       positions=torch.from_numpy(pos), lora=tl)
    np.testing.assert_allclose(yp.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tc["kpos"].numpy(),
                                  np.asarray(jc["kpos"]))
    np.testing.assert_array_equal(tc["kpos"][:20].numpy(), np.arange(20))
    for t in range(20, 23):
        jy, jc = ja.decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                jnp.int32(t), lora=jl)
        y, _ = ta.decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tc, t,
                              lora=tl)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                                   atol=ATOL)
        for f in ("k", "v"):
            np.testing.assert_allclose(tc[f].numpy(), np.asarray(jc[f]),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tc["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_mask_positions_follow_the_rank_rule(impl, monkeypatch):
    """The causal mask reads ``positions[0]`` for (B, S) positions only;
    for (B, S, 3) positions (or none) it reads 0..S-1, as JAX does
    (its ``rope_pos`` rule), on the full path and in every chunk."""
    seen = []
    real = Attention._mask

    def spy(self, q_pos, k_pos):
        seen.append((q_pos.clone(), k_pos.clone()))
        return real(self, q_pos, k_pos)

    monkeypatch.setattr(Attention, "_mask", spy)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 20, 128)).astype(np.float32))
    _, _, _, ta, tp, _ = attn_pair(7, q_chunk=8)
    ta(tp, x, positions=torch.from_numpy(positions_of("grid", 2, 20)),
       impl=impl)
    q_all = torch.cat([q for q, _ in seen])
    assert torch.equal(q_all, torch.arange(20))
    assert all(torch.equal(k, torch.arange(20)) for _, k in seen)
    seen.clear()
    plain = Attention(128, 4, 2, qkv_bias=True, rope_base=BASE, q_chunk=8)
    flat = torch.arange(100, 120)[None].expand(2, 20)
    plain(tp, x, positions=flat, impl=impl)
    assert torch.equal(torch.cat([q for q, _ in seen]), flat[0])
    assert all(torch.equal(k, flat[0]) for _, k in seen)


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
                  "rope_base", "tie_embeddings", "head_dim",
                  "mrope_sections", "vision_tokens", "lora_rank",
                  "sliding_window_long"):
            assert getattr(j, f) == getattr(t, f), (reduce, f)
        assert t.lora_targets() == j.lora_targets()
    assert load_arch(ARCH).dtype == torch.bfloat16
    assert load_arch(ARCH).reduced().dtype == torch.float32


def test_full_width_trees_manifest_and_fingerprint_match_jax():
    """qwen2-vl-7b at full width: the same 7,615,616,512 parameters in
    the same paths and shapes, 9 LoRA leaves on the three sites, d =
    16,515,156 and fingerprint ``5ecc74948787cc41`` in both packages;
    every site's factor is word-aligned, so all take the fused route;
    the attention rotates by sections (16, 24, 24) and the model makes
    (B, S, 3) default positions."""
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
    assert sum(int(np.prod(s)) for s, _ in tshapes.values()) == 7_615_616_512
    space = TaskVectorSpace.from_tree(m.lora_init(device="meta"))
    assert space.d == jspace.d == 16_515_156
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint == "5ecc74948787cc41"
    assert [l.path for l in space.leaves] == [
        f"{s}/{f}" for s in SITES for f in ("a", "alpha", "b")]
    m.cfg.check_lora_targets([l.path for l in space.leaves])
    for l in space.leaves:
        if l.path.endswith(("/a", "/b")):
            assert (l.size // 32) % bitpack.WORD_BITS == 0
    attn = m.model.unit_blocks[0][1].mixer
    assert attn.mrope_sections == (16, 24, 24) and attn.head_dim == 128
    assert m.model.mrope
    assert m.model._default_positions(2, 5).shape == (2, 5, 3)


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        load_arch(ARCH).build()


# ---------------------------------------------------------------------------
# 3. the reduced vlm: model, round, store, routes
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
    images = (0.02 * rng.standard_normal((N_TASKS, N_IMG, m.cfg.d_model))
              ).astype(np.float32)
    return dict(jm=jm, jparams=jparams, jlora0=jlora0, jlora=jlora, m=m,
                params=params_from_numpy(m, to_np(jparams)),
                lora0=lora_from_numpy(m, to_np(jlora0)),
                lora=lora_from_numpy(m, to_np(jlora)), tokens=tokens,
                images=images, pos=grid_positions(N_TASKS, GRID, PROMPT))


def batches(r, n_txt=PROMPT, pos=None):
    """The (JAX, port) prefill batches: images, the first n_txt text
    tokens, and their positions (default: the grid layout)."""
    pos = r["pos"][:, :N_IMG + n_txt] if pos is None else pos
    jb = {"tokens": jnp.asarray(r["tokens"][:, :n_txt]),
          "extra_embeds": jnp.asarray(r["images"]),
          "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(r["tokens"][:, :n_txt].copy()),
          "extra_embeds": torch.from_numpy(r["images"]),
          "positions": torch.from_numpy(np.ascontiguousarray(pos))}
    return jb, tb


def test_params_and_lora_carry_across_leaf_for_leaf():
    """Every converted leaf equals the JAX leaf, in a bf16 model too; a
    tree missing a leaf or with a leaf of another shape is refused."""
    import dataclasses
    r = rig()
    jm16 = dataclasses.replace(j_load_arch(ARCH).reduced(),
                               dtype=jnp.bfloat16).build()
    m16 = dataclasses.replace(load_arch(ARCH).reduced(),
                              dtype=torch.bfloat16).build(device="cpu")
    jp16 = jm16.init(jax.random.PRNGKey(2))
    p16 = params_from_numpy(m16, to_np(jp16))
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
    del bad["units"]["blk"]["mixer"]["wq"]["b"]
    with pytest.raises(ValueError, match="paths differ"):
        params_from_numpy(r["m"], bad)
    bad = to_np(r["jlora"])
    down = bad["units"]["blk"]["ffn"]["down"]
    down["a"] = down["a"][:, 1:]
    with pytest.raises(ValueError, match="shape"):
        lora_from_numpy(r["m"], bad)


@pytest.mark.parametrize("kind", ["grid", "default"])
@pytest.mark.parametrize("with_lora", [False, True])
def test_forward_logits_match_jax(with_lora, kind):
    """8 prepended vision embeddings and 12 tokens: logits (B, 20, V) at
    the grid positions and at the default (B, S, 3) positions."""
    r = rig()
    jb, tb = batches(r)
    if kind == "default":
        jb["positions"] = tb["positions"] = None
    jl, _ = r["jm"].model.forward(
        r["jparams"], jb["tokens"], lora=r["jlora"] if with_lora else None,
        positions=jb["positions"], extra_embeds=jb["extra_embeds"])
    tl = r["m"].forward(r["params"], tb["tokens"],
                        lora=r["lora"] if with_lora else None,
                        extra_embeds=tb["extra_embeds"],
                        positions=tb["positions"])
    assert tl.shape == (N_TASKS, S_ALL, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)


def test_grid_positions_change_the_logits():
    """The same image and tokens at the grid positions and at text
    positions 0..19 give other logits in the port, and JAX's at each."""
    r = rig()
    flat = np.repeat(np.broadcast_to(np.arange(S_ALL, dtype=np.int32),
                                     (N_TASKS, S_ALL))[..., None], 3, -1)
    out = {}
    for kind, pos in (("grid", None), ("text", flat)):
        jb, tb = batches(r, pos=pos)
        out[kind] = r["m"].forward(r["params"], tb["tokens"], lora=r["lora"],
                                   extra_embeds=tb["extra_embeds"],
                                   positions=tb["positions"])
        jl, _ = r["jm"].model.forward(
            r["jparams"], jb["tokens"], lora=r["jlora"],
            positions=jb["positions"], extra_embeds=jb["extra_embeds"])
        np.testing.assert_allclose(out[kind].numpy(), np.asarray(jl),
                                   rtol=LM_RTOL, atol=LM_ATOL)
    gap = (out["grid"] - out["text"]).abs().amax(-1)        # (B, S)
    assert (gap[:, 0] == 0).all()          # (0, 0, 0) in both layouts
    assert (gap[:, 1:] > 1e-3).all()


def test_prefill_then_decode_logits_and_caches_match_jax():
    """Prefill of the image and 12 tokens at the grid positions into a
    28-slot cache, then four decode steps at positions 20..23: logits at
    each step and every cache leaf (k, v, kpos)."""
    r = rig()
    jm, m = r["jm"], r["m"]
    jc = jm.init_cache(N_TASKS, 28)
    tc = m.init_cache(N_TASKS, 28)
    blk = tc["blk"]
    assert blk["k"].shape == (2, N_TASKS, 28, 2, 32)
    jb, tb = batches(r)
    jl, jc = jm.prefill_step(r["jparams"], r["jlora"], jb, jc)
    tl, _ = m.prefill_step(r["params"], r["lora"], tb, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL)
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for pos in range(S_ALL, S_ALL + 4):
        jl, jc = jm.decode_fn(r["jparams"], r["jlora"],
                              {"tokens": jnp.asarray(nxt)}, jc,
                              jnp.int32(pos))
        tl, _ = m.decode_fn(r["params"], r["lora"],
                            {"tokens": torch.from_numpy(nxt)}, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL)
        for f in ("k", "v"):
            np.testing.assert_allclose(blk[f].numpy(),
                                       np.asarray(jc["blk"][f]),
                                       rtol=LM_RTOL, atol=LM_ATOL,
                                       err_msg=f)
        np.testing.assert_array_equal(blk["kpos"].numpy(),
                                      np.asarray(jc["blk"]["kpos"]))
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    want = np.where(np.arange(28) < S_ALL + 4, np.arange(28), -1)
    np.testing.assert_array_equal(blk["kpos"].numpy(), np.stack([want] * 2))


def test_prefill_and_decode_equal_the_full_forward():
    """The port holds itself as the JAX package's test_serving holds
    JAX: the image and 9 tokens prefilled, then three decode steps, give
    the full forward's logits at S - 4 .. S - 1.  A decode step rotates
    at its slot on all three coordinates (the JAX package's rule), so
    the forward's text tokens sit at their slots here."""
    r = rig()
    m = r["m"]
    pos = r["pos"].copy()
    pos[:, N_IMG:] = np.arange(N_IMG, S_ALL)[None, :, None]
    _, tb = batches(r, pos=pos)
    full = m.forward(r["params"], tb["tokens"], lora=r["lora"],
                     extra_embeds=tb["extra_embeds"],
                     positions=tb["positions"])
    cache = m.init_cache(N_TASKS, 28)
    _, pre = batches(r, PROMPT - 3, pos[:, :-3])
    got = [m.prefill_step(r["params"], r["lora"], pre, cache)[0]]
    toks = tb["tokens"]
    for j in range(PROMPT - 3, PROMPT):
        got.append(m.decode_fn(r["params"], r["lora"],
                               {"tokens": toks[:, j:j + 1]}, cache,
                               N_IMG + j)[0])
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
    assert space.d == 7_174
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
def test_every_site_fused_and_six_kernel9_calls_a_layer(packed, monkeypatch):
    """All three sites take the fused route (words, base and τ bitwise
    JAX router's, λ and α to rtol 1e-5); a prefill of the image and the
    prompt and a decode step each call kernel 9 2·3·L times, at S = 20
    and S = 1."""
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
    cache = m.init_cache(N_TASKS, 28)
    logits, _ = m.prefill_step(r["params"], tree, batches(r)[1], cache,
                               mode="ref")
    assert calls == [S_ALL] * 6 * n
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    m.decode_fn(r["params"], tree, {"tokens": tok}, cache, S_ALL, mode="ref")
    assert calls[6 * n:] == [1] * 6 * n


@functools.lru_cache(maxsize=None)
def jax_tokens(packed, fused):
    """JAX's greedy loop: ``route_batch``, ``prefill_step`` of the image,
    prompt and grid positions, then ``decode_fn`` at positions 20.."""
    r = rig()
    jstore, _ = stores(packed)
    jm = r["jm"]
    lora = j_route_batch(jstore, IDS, fused=fused)
    cache = jm.init_cache(N_TASKS, S_ALL + N_NEW + 8)
    logits, cache = jm.prefill_step(r["jparams"], lora, batches(r)[0], cache)
    out = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for pos in range(S_ALL, S_ALL + N_NEW - 1):
        logits, cache = jm.decode_fn(r["jparams"], lora,
                                     {"tokens": out[-1][:, None]}, cache,
                                     jnp.int32(pos))
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return np.concatenate([r["tokens"], np.asarray(jnp.stack(out, 1))], 1)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_greedy_tokens_match_jax(packed, fused):
    """A mixed batch (tasks 2, 0, 3, 2) through the port's store, router,
    model (plain versions) and ``chip_smoke.served_generate``'s greedy loop
    gives JAX's tokens on the same downlink layout, on both routes."""
    r = rig()
    _, store = stores(packed)
    _, tb = batches(r)
    out = served_generate(torch, r["m"], r["params"],
                          route_batch(store, IDS, fused=fused), tb, N_NEW,
                          mode="ref").numpy()
    assert out.shape == (N_TASKS, PROMPT + N_NEW)
    np.testing.assert_array_equal(out, jax_tokens(packed, fused))
