"""The port's xlstm-1.3b serving path against the JAX package's, on the
CPU, at the reduced config (one (mLSTM, sLSTM) unit, d_model 128, 4
heads, chunk 16, LoRA rank 4, fp32): the JAX model's parameters and
adapters are carried into the port with ``params_from_numpy`` /
``lora_from_numpy``; one real MaTU round runs in both packages on the
same numpy uploads; the port's ``serving_downlink`` → ``ModulatorStore``
→ ``MultiTenantDecoder.generate`` is held against the JAX package's run
of the same downlink layout.  Prompts span three mLSTM chunks (40
tokens: 16 + 16 + a ragged 8).

Tolerances: logits rtol 1e-4, atol 1e-5 (fp32 sums in other orders);
cache state rtol 1e-4, atol 1e-5; round task vectors rtol 1e-5; packed
words, bf16 downlink vectors and greedy tokens identical.
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
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.server import MaTUServer as JServer  # noqa: E402
from repro.core.server import MaTUServerConfig as JServerCfg  # noqa: E402
from repro.core.unify import unify_with_modulators  # noqa: E402
from repro.kernels import bitpack as jbitpack  # noqa: E402
from repro.serve import GenerationConfig as JGenCfg  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import MultiTenantDecoder as JDecoder  # noqa: E402
from repro.serve import route_batch as j_route_batch  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.configs.base import SHAPES, load_arch  # noqa: E402
from repro_torch.core.client import ClientDownlink, ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve import (GenerationConfig, ModulatorStore,  # noqa: E402
                               MultiTenantDecoder, route_batch)

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-1.3b"
RTOL, ATOL = 1e-4, 1e-5
N_TASKS, PROMPT = 4, 40
# clients' task sets: every task held by two or three clients
CLIENT_TASKS = [[0, 1], [1, 2], [2, 3], [0, 3], [0, 2], [1, 3]]
IDS = [2, 0, 3, 2]
GEN = GenerationConfig(max_new_tokens=5)
J_GEN = JGenCfg(max_new_tokens=5)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=1)
def rig():
    """Reduced xlstm in both packages with the same parameters; lora0 as
    initialised (b = 0) and a LoRA tree with b ~ 0.05 N(0, 1)."""
    jm = j_load_arch(ARCH).reduced().build(J_SHAPES["decode_32k"])
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora0 = jm.lora_init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    jlora = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                      x.dtype)
                      if str(p[-1].key) == "b" else x), jlora0)
    m = load_arch(ARCH).reduced().build(SHAPES["decode_32k"], device="cpu")
    tokens = np.random.default_rng(3).integers(1, m.cfg.vocab, (N_TASKS,
                                                                PROMPT))
    return dict(jm=jm, jparams=jparams, jlora0=jlora0, jlora=jlora, m=m,
                params=params_from_numpy(m, to_np(jparams)),
                lora0=lora_from_numpy(m, to_np(jlora0)),
                lora=lora_from_numpy(m, to_np(jlora)), tokens=tokens)


def test_configs_match_jax():
    for reduce in (False, True):
        j, t = j_load_arch(ARCH), load_arch(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "tie_embeddings", "mlstm_chunk",
                  "lora_rank", "sliding_window_long"):
            assert getattr(j, f) == getattr(t, f), (reduce, f)
    full = load_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab,
            full.mlstm_chunk, full.lora_rank) == (48, 2048, 4, 50304, 256, 16)
    assert full.dtype == torch.bfloat16
    assert full.reduced().mlstm_chunk == 16


def test_full_width_manifest_and_parameters_match_jax():
    """Full width, shapes only: the same 1,815,676,928 parameters, the
    same 12 LoRA manifest leaves (4 sites x a, b, alpha, stacked over 24
    units, ``slstm/ffn_down/a`` of (24, 2730, 16)), d = 12,058,464 and
    the same fingerprint in both packages; the router's per-layer bit
    slices of every leaf, several at offsets inside a word, bitwise."""
    jm = j_load_arch(ARCH).build()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jspace = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                             jax.random.PRNGKey(1)))
    m = load_arch(ARCH).build(device="cpu")
    tp = m.init(device="meta")
    jshapes = {"/".join(str(k.key) for k in p): tuple(x.shape)
               for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    tshapes = {"/".join(p): tuple(x.shape)
               for p, x in _leaves(tp)}
    assert tshapes == jshapes
    assert sum(int(np.prod(s)) for s in tshapes.values()) == 1_815_676_928
    space = TaskVectorSpace.from_tree(m.lora_init(device="meta"))
    assert space.d == jspace.d == 12_058_464
    assert len(space.leaves) == 12
    assert space.by_path("units/slstm/ffn_down/a").shape == (24, 2730, 16)
    assert space.manifest_text() == jspace.manifest_text()
    assert space.fingerprint == jspace.fingerprint
    m.cfg.check_lora_targets([l.path for l in space.leaves])
    assert space.by_path("units/mlstm/down/b").offset % 32 == 24
    assert space.by_path("units/slstm/ffn_down/b").offset % 32 == 8
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (2, jbitpack.packed_width(space.d)),
                         dtype=np.uint32)
    tw, jw = bitpack.words_from_numpy(words), jnp.asarray(words)
    for leaf in space.leaves:
        per = leaf.size // leaf.shape[0]
        for start in (leaf.offset, leaf.offset + per, leaf.offset + 23 * per):
            np.testing.assert_array_equal(
                bitpack.words_to_numpy(bitpack.slice_bits(tw, start, per)),
                np.asarray(jbitpack.slice_bits(jw, start, per)),
                err_msg=f"{leaf.path} at bit {start}")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("with_lora", [False, True])
def test_forward_logits_match_jax(with_lora):
    r = rig()
    jl, _ = r["jm"].model.forward(r["jparams"], jnp.asarray(r["tokens"]),
                                  lora=r["jlora"] if with_lora else None)
    tl = r["m"].forward(r["params"], torch.from_numpy(r["tokens"]),
                        lora=r["lora"] if with_lora else None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_prefill_then_decode_logits_and_cache_match_jax():
    """Prefill over 40 tokens (three chunks, the last ragged) fills the
    port's cache in place with the state JAX returns; three decode
    steps agree in logits and state."""
    r = rig()
    jm, m = r["jm"], r["m"]
    b = N_TASKS
    jc = jm.init_cache(b, 64)
    jl, jc = jm.prefill_step(r["jparams"], r["jlora"],
                             {"tokens": jnp.asarray(r["tokens"])}, jc)
    tc = m.init_cache(b, 64)
    tl, tc2 = m.prefill_step(r["params"], r["lora"],
                             {"tokens": torch.from_numpy(r["tokens"])}, tc)
    assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)

    def same_cache():
        for name in ("mlstm", "slstm"):
            assert tc[name].keys() == jc[name].keys()
            for key in tc[name]:
                np.testing.assert_allclose(
                    tc[name][key].numpy(), np.asarray(jc[name][key]),
                    rtol=RTOL, atol=ATOL, err_msg=f"{name}/{key}")

    same_cache()
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for pos in (PROMPT, PROMPT + 1, PROMPT + 2):
        jl, jc = jm.decode_fn(r["jparams"], r["jlora"],
                              {"tokens": jnp.asarray(nxt)}, jc,
                              jnp.int32(pos))
        tl, _ = m.decode_fn(r["params"], r["lora"],
                            {"tokens": torch.from_numpy(nxt)}, tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    same_cache()


# ---------------------------------------------------------------------------
# one round, the serving downlink, the store and the decoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def rounds():
    """One MaTU round in each package on the same uploads: every client
    unifies its tasks' vectors (0.05 N(0, 1), numpy) with the JAX
    package's ``unify_with_modulators``, and both servers take the same
    unified vector, masks and λ."""
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


def downlinks(packed):
    """The JAX round's serving downlink, and the port's from the same
    task vectors (the port's own round agrees to fp32 tolerance)."""
    jspace, space, jserver, _ = rounds()
    jdl = jserver.serving_downlink(packed=packed,
                                   fingerprint=jspace.fingerprint)
    port = MaTUServer(MaTUServerConfig(n_tasks=N_TASKS), device="cpu")
    port.last_task_vectors = torch.from_numpy(
        np.array(jserver.last_task_vectors))
    return jdl, port.serving_downlink(packed=packed,
                                      fingerprint=space.fingerprint)


def test_round_and_serving_downlink_match_jax():
    """The port's round gives JAX's task vectors (rtol 1e-5); on the same
    task vectors, the packed downlink is bitwise JAX's (bf16 vector and
    words) and the bool one carries the same bits."""
    _, _, jserver, server = rounds()
    np.testing.assert_allclose(server.last_task_vectors.numpy(),
                               np.asarray(jserver.last_task_vectors),
                               rtol=1e-5, atol=1e-6)
    jdl, dl = downlinks(packed=True)
    np.testing.assert_array_equal(dl.unified.view(torch.int16).numpy(),
                                  np.asarray(jdl.unified).view(np.int16))
    np.testing.assert_array_equal(bitpack.words_to_numpy(dl.masks),
                                  np.asarray(jdl.masks))
    np.testing.assert_allclose(dl.lams.numpy(), np.asarray(jdl.lams),
                               rtol=1e-5)
    assert dl.packed and not torch.equal(dl.masks, torch.zeros_like(
        dl.masks))
    jdb, db = downlinks(packed=False)
    np.testing.assert_array_equal(db.masks.numpy(), np.asarray(jdb.masks))
    np.testing.assert_allclose(db.unified.numpy(), np.asarray(jdb.unified),
                               rtol=0, atol=0)
    assert torch.equal(bitpack.pack_bits(db.masks), dl.masks)


def stores(packed):
    r = rig()
    jspace, space, _, _ = rounds()
    jdl, dl = downlinks(packed)
    jstore = JStore(jspace, r["jlora0"])
    jstore.ingest(jdl)
    store = ModulatorStore(space, r["lora0"], capacity=N_TASKS, device="cpu")
    store.ingest(dl)
    return jstore, store


def _sites(node, prefix=""):
    if not isinstance(node, dict):
        return
    if "a" in node and "b" in node:
        yield prefix, node
        return
    for k in node:
        yield from _sites(node[k], f"{prefix}/{k}")


def test_fused_route_matches_jax_bitwise():
    """The xlstm manifest's four sites: per-layer words, base and τ
    bitwise against the JAX router; λ, α and the dense-routed leaves
    (built with λ) to rtol 1e-5, as the downlink's λ agrees;
    ``slstm/ffn_down`` (170 x 4 = 680 bits a layer, not word-aligned) is
    dense-routed in both."""
    jstore, store = stores(packed=True)
    jt = dict(_sites(j_route_batch(jstore, IDS, fused=True)))
    tt = dict(_sites(route_batch(store, IDS, fused=True)))
    assert jt.keys() == tt.keys() == {"/units/mlstm/up", "/units/mlstm/down",
                                      "/units/slstm/wx",
                                      "/units/slstm/ffn_down"}
    assert not isinstance(tt["/units/slstm/ffn_down"]["a"], dict)
    for path, site in tt.items():
        js = jt[path]
        if not isinstance(site["a"], dict):
            for f in ("a", "b", "alpha"):           # leaf0 + λ·m⊙τ
                np.testing.assert_allclose(site[f].numpy(), np.asarray(js[f]),
                                           rtol=1e-5, atol=1e-7)
            continue
        for f in ("a", "b"):
            for part in ("base", "tau"):
                np.testing.assert_array_equal(site[f][part].numpy(),
                                              np.asarray(js[f][part]))
            np.testing.assert_array_equal(
                bitpack.words_to_numpy(site[f]["words"]),
                np.asarray(js[f]["words"]))
        for f in ("lam", "alpha"):
            np.testing.assert_allclose(site[f].numpy(), np.asarray(js[f]),
                                       rtol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_tokens(packed, fused):
    r = rig()
    jstore, _ = stores(packed)
    dec = JDecoder(r["jm"], r["jparams"], jstore, fused=fused, cfg=J_GEN)
    return np.asarray(dec.generate(jnp.asarray(r["tokens"]), IDS))


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_decoder_tokens_match_jax(packed, fused):
    """A mixed batch (tasks 2, 0, 3, 2) through the port's store and
    decoder gives the JAX decoder's tokens on the same downlink layout,
    on both routes."""
    r = rig()
    _, store = stores(packed)
    dec = MultiTenantDecoder(r["m"], r["params"], store, fused=fused,
                             cfg=GEN, device="cpu")
    out = dec.generate(torch.from_numpy(r["tokens"]), IDS)
    assert out.shape == (N_TASKS, PROMPT + GEN.max_new_tokens)
    np.testing.assert_array_equal(out.numpy(), jax_tokens(packed, fused))


def test_store_rebuilds_the_downlink_layouts_alike():
    """Packed and bool downlinks of the same round give the same resident
    mask words, and ingest refuses a downlink of another layout."""
    _, packed = stores(True)
    _, dense = stores(False)
    for t in range(N_TASKS):
        assert torch.equal(packed.mask_words(t), dense.mask_words(t))
    _, dl = downlinks(True)
    with pytest.raises(ValueError, match="layout"):
        packed.ingest(ClientDownlink(dl.unified, dl.masks, dl.lams,
                                     fingerprint="0" * 16))
