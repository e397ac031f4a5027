"""The port's serving path against the JAX package's, on the CPU:
``bitpack.slice_bits``, the plain versions of kernels 8 and 9
(``ref.masked_agg_ref``, ``ref.modulated_matmul_ref``), the layout
handshake, ``MaTUServer.serving_downlink``, ``ModulatorStore``,
``route_batch`` and ``MultiTenantDecoder`` at the reduced qwen2-0.5b
config (2 layers, d_model 128, fp32).  Inputs come from numpy seeds and
go to both packages.

Parity bar (tolerances stated per test): packed words, mask bits, m̂,
the routed λ / α and the fused effective weights bitwise; τ̂ and the
kernel-9 product to rtol 1e-5 (fp32 sums in another order); greedy
tokens identical.
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
from repro.core.client import ClientDownlink as JDownlink  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.server import MaTUServer as JServer  # noqa: E402
from repro.core.server import MaTUServerConfig as JServerCfg  # noqa: E402
from repro.fed.strategies import Upload as JUploadS  # noqa: E402
from repro.kernels import bitpack as jbitpack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import GenerationConfig as JGenCfg  # noqa: E402
from repro.serve import ModulatorStore as JStore  # noqa: E402
from repro.serve import MultiTenantDecoder as JDecoder  # noqa: E402
from repro.serve import route_batch as j_route_batch  # noqa: E402
from repro_torch.common.tree import (TaskVectorLayoutError,  # noqa: E402
                                     TaskVectorSpace, tree_add)
from repro_torch.configs.base import SHAPES, load_arch  # noqa: E402
from repro_torch.core.client import ClientDownlink  # noqa: E402
from repro_torch.core.client import ClientUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.core.unify import modulate  # noqa: E402
from repro_torch.fed.strategies import MaTUStrategy, Upload  # noqa: E402
from repro_torch.kernels import bitpack, ops, ref  # noqa: E402
from repro_torch.models.convert import (lora_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve import (GenerationConfig, ModulatorStore,  # noqa: E402
                               MultiTenantDecoder, generate, route_batch)
from repro_torch.serve.generate import _sample  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

N_TASKS = 4
GEN = GenerationConfig(max_new_tokens=5)
J_GEN = JGenCfg(max_new_tokens=5)
RTOL, ATOL = 1e-5, 1e-6


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_downlink(jdl, fingerprint="same"):
    """A JAX downlink carried into the port as numpy."""
    fp = jdl.fingerprint if fingerprint == "same" else fingerprint
    uni = torch.from_numpy(np.array(jdl.unified, np.float32))
    if jdl.packed:
        return ClientDownlink(uni.to(torch.bfloat16),
                              bitpack.words_from_numpy(np.asarray(jdl.masks)),
                              torch.from_numpy(np.array(jdl.lams)),
                              fingerprint=fp)
    return ClientDownlink(uni, torch.from_numpy(np.array(jdl.masks)),
                          torch.from_numpy(np.array(jdl.lams)),
                          fingerprint=fp)


@functools.lru_cache(maxsize=1)
def rig():
    """Reduced qwen2 in both packages (same parameters and lora0) and one
    real server round in each, one single-task client per task, on the
    same numpy task vectors."""
    jm = j_load_arch("qwen2-0.5b").reduced().build(J_SHAPES["decode_32k"])
    jparams = jm.init(jax.random.PRNGKey(0))
    jlora0 = jm.lora_init(jax.random.PRNGKey(1))
    jspace = JSpace.from_tree(jlora0)
    m = load_arch("qwen2-0.5b").reduced().build(SHAPES["decode_32k"],
                                                device="cpu")
    params = params_from_numpy(m, to_np(jparams))
    lora0 = lora_from_numpy(m, to_np(jlora0))
    space = TaskVectorSpace.from_tree(lora0)
    assert space.fingerprint == jspace.fingerprint
    d = space.d
    rng = np.random.default_rng(7)
    vecs = (0.05 * rng.standard_normal((N_TASKS, d))).astype(np.float32)
    jserver = JServer(JServerCfg(n_tasks=N_TASKS))
    jserver.round([JUpload(t, [t], jnp.asarray(vecs[t]),
                           jnp.ones((1, d), bool), jnp.ones((1,)), [64],
                           fingerprint=jspace.fingerprint)
                   for t in range(N_TASKS)])
    server = MaTUServer(MaTUServerConfig(n_tasks=N_TASKS), device="cpu")
    server.round([ClientUpload(t, [t], torch.from_numpy(vecs[t]),
                               torch.ones((1, d), dtype=torch.bool),
                               torch.ones(1), [64],
                               fingerprint=space.fingerprint)
                  for t in range(N_TASKS)])
    prompts = rng.integers(1, m.cfg.vocab, (N_TASKS, 8)).astype(np.int32)
    jdl = jserver.serving_downlink(packed=True,
                                   fingerprint=jspace.fingerprint)
    return dict(jm=jm, jparams=jparams, jlora0=jlora0, jspace=jspace,
                jserver=jserver, jdl=jdl, m=m, params=params, lora0=lora0,
                space=space, server=server, prompts=prompts)


def port_store(capacity=8, packed=True):
    """The port's store on the JAX round's downlink (the same bits in
    both packages)."""
    r = rig()
    dl = r["jdl"] if packed else r["jserver"].serving_downlink(
        packed=False, fingerprint=r["jspace"].fingerprint)
    store = ModulatorStore(r["space"], r["lora0"], capacity=capacity,
                           device="cpu")
    store.ingest(port_downlink(dl))
    return store


# ---------------------------------------------------------------------------
# kernel layer: slice_bits and the plain versions of kernels 8 and 9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,length", [(0, 992), (37, 129), (32, 64),
                                          (991, 1), (100, 0), (982, 10)])
def test_slice_bits_matches_jax(start, length):
    rng = np.random.default_rng(start * 1000 + length)
    bits = rng.random((3, 992)) < 0.5
    words = bitpack.pack_bits_np(bits)
    got = bitpack.slice_bits(bitpack.words_from_numpy(words), start, length)
    want = np.asarray(jbitpack.slice_bits(jnp.asarray(words), start, length))
    np.testing.assert_array_equal(bitpack.words_to_numpy(got), want)
    np.testing.assert_array_equal(
        want, bitpack.pack_bits_np(bits[:, start:start + length]))


@pytest.mark.parametrize("start,length", [(1, 64), (31, 33), (8, 40),
                                          (24, 95)])
def test_slice_bits_with_bit_31_set(start, length):
    """Words whose bit 31 is set: an arithmetic shift of int32 would
    smear it into the high bits of the merged word."""
    words = np.array([[0xFFFFFFFF, 0x80000000, 0x80000001, 0xFFFF0000,
                       0x7FFFFFFF]], np.uint32)
    got = bitpack.slice_bits(bitpack.words_from_numpy(words), start, length)
    bits = bitpack.unpack_bits_np(words, 160)
    np.testing.assert_array_equal(
        bitpack.words_to_numpy(got),
        bitpack.pack_bits_np(bits[:, start:start + length]))


def test_slice_bits_at_the_full_width_manifest_offsets():
    """qwen2-0.5b's LoRA manifest (d = 3,588,168): every leaf and the
    per-layer factor slices the router takes, several at offsets that
    are not word-aligned (``ffn/down/b`` at bit 24, ``mixer/wq/b`` at
    bit 8), bitwise against JAX."""
    jm = j_load_arch("qwen2-0.5b").build()
    space = JSpace.from_tree(jax.eval_shape(jm.lora_init,
                                            jax.random.PRNGKey(1)))
    assert space.by_path("units/blk/ffn/down/b").offset % 32 == 24
    assert space.by_path("units/blk/mixer/wq/b").offset % 32 == 8
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (2, jbitpack.packed_width(space.d)),
                         dtype=np.uint32)
    tw, jw = bitpack.words_from_numpy(words), jnp.asarray(words)
    cuts = [(l.offset, l.size) for l in space.leaves]
    for l in space.leaves:
        if len(l.shape) == 3:
            per = l.size // l.shape[0]
            cuts += [(l.offset + i * per, per) for i in (0, 1, 23)]
    for start, length in cuts:
        np.testing.assert_array_equal(
            bitpack.words_to_numpy(bitpack.slice_bits(tw, start, length)),
            np.asarray(jbitpack.slice_bits(jw, start, length)),
            err_msg=f"slice ({start}, {length})")


def mm_inputs(seed, b=3, s=5, k=32, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, k)).astype(np.float32)
    base = rng.standard_normal((k, n)).astype(np.float32)
    tau = rng.standard_normal((k, n)).astype(np.float32)
    words = bitpack.pack_bits_np(rng.random((b, k * n)) < 0.6)
    lam = rng.standard_normal(b).astype(np.float32)
    return x, base, tau, words, lam


def port_mm(x, base, tau, words, lam):
    return (torch.from_numpy(x), torch.from_numpy(base), torch.from_numpy(tau),
            bitpack.words_from_numpy(words), torch.from_numpy(lam))


@pytest.mark.parametrize("mode", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("seed,k,n", [(0, 32, 16), (1, 16, 96), (2, 48, 8)])
def test_modulated_matmul_ref_matches_jax(mode, seed, k, n):
    """Plain version against JAX's oracle and its Pallas kernel
    (interpret): rtol 1e-5 — the product sums in another order."""
    args = mm_inputs(seed, k=k, n=n)
    want = jops.modulated_matmul(*map(jnp.asarray, args), mode=mode)
    got = ops.modulated_matmul(*port_mm(*args), mode="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # a CPU tensor under the default dispatch takes the plain version
    assert torch.equal(ops.modulated_matmul(*port_mm(*args)), got)


@pytest.mark.parametrize("seed", [3, 4])
def test_modulated_weight_build_bitwise_vs_jax_eager(seed):
    """The effective weight ``base + (λ·m)·τ``: bitwise against JAX's
    eager oracle, and ``x = I`` makes every product output equal it bit
    for bit."""
    x, base, tau, words, lam = mm_inputs(seed, k=32, n=16)
    bits = jbitpack.unpack_bits(jnp.asarray(words), 32 * 16,
                                jnp.float32).reshape(3, 32, 16)
    want = (jnp.asarray(base)[None] + jnp.asarray(lam)[:, None, None] * bits
            * jnp.asarray(tau)[None])
    tb, tt, tw, tl = port_mm(x, base, tau, words, lam)[1:]
    w = ref.modulated_weight_ref(tb, tt, tw, tl)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want))
    eye = torch.eye(32).expand(3, 32, 32).contiguous()
    assert torch.equal(ref.modulated_matmul_ref(eye, tb, tt, tw, tl), w)
    # ... and bitwise the materialised adapter leaf lora0 + λ·where(m, τ, 0)
    m = bitpack.unpack_bits(tw, 32 * 16).reshape(3, 32, 16)
    adapter = tb[None] + tl[:, None, None] * torch.where(m, tt[None], 0.0)
    assert torch.equal(w, adapter)


def test_modulated_matmul_rejects_misaligned():
    with pytest.raises(ValueError, match="word-aligned"):
        ops.modulated_matmul(torch.zeros(1, 2, 3), torch.zeros(3, 5),
                             torch.zeros(3, 5),
                             torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(1), mode="ref")
    with pytest.raises(ValueError, match="word-aligned"):
        ops.modulated_matmul(torch.zeros(1, 2, 3), torch.zeros(3, 5),
                             torch.zeros(3, 5),
                             torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(1))


def agg_inputs(seed, n=7, d=300, mask_dtype=np.bool_):
    """Single-task inputs with one non-member row (γ = 0) that carries a
    nonzero mask, and zeros in the unified rows."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d)).astype(np.float32)
    u[rng.random((n, d)) < 0.1] = 0.0
    masks = rng.random((n, d)) < 0.7
    lams = (rng.random(n) + 0.5).astype(np.float32)
    sizes = rng.integers(10, 200, n).astype(np.float32)
    sizes[2] = 0.0                      # γ = 0: a non-member with a mask
    gam = (sizes / sizes.sum()).astype(np.float32)
    return u, masks.astype(mask_dtype), lams, gam


@pytest.mark.parametrize("mode", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("seed,mask_dtype", [(0, np.bool_), (1, np.float32)])
def test_masked_agg_ref_matches_jax(mode, seed, mask_dtype):
    """m̂ bitwise, τ̂ rtol 1e-5 (JAX weights γ·(λ·u), the port (γ·λ)·u)."""
    u, masks, lams, gam = agg_inputs(seed, mask_dtype=mask_dtype)
    jt, jm = jops.masked_agg(jnp.asarray(u), jnp.asarray(masks),
                             jnp.asarray(lams), jnp.asarray(gam), rho=0.4,
                             mode=mode)
    tt, tm = ops.masked_agg(torch.from_numpy(u), torch.from_numpy(masks),
                            torch.from_numpy(lams), torch.from_numpy(gam),
                            rho=0.4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mask_dtype", [np.bool_, np.float32])
def test_masked_agg_single_equals_batched_row(mask_dtype):
    """The single-task entry is bitwise the batched Eq. 3+4's row of the
    same task fed with members = γ > 0; the γ = 0 row adds nothing."""
    u, masks, lams, gam = agg_inputs(5, mask_dtype=mask_dtype)
    tu, tm = torch.from_numpy(u), torch.from_numpy(masks)
    tl, tg = torch.from_numpy(lams), torch.from_numpy(gam)
    tau, m_hat = ops.masked_agg(tu, tm, tl, tg, mode="ref")
    mem = tg > 0
    bt, bm = ops.masked_agg_batched(tu, ((tm != 0) & mem[:, None])[:, None],
                                    tl[:, None], tg[:, None], mem[:, None],
                                    mode="ref")
    assert torch.equal(tau, bt[0]) and torch.equal(m_hat, bm[0])
    keep = np.arange(len(gam)) != 2       # drop the γ = 0 row
    t2, m2 = ops.masked_agg(tu[keep], tm[keep], tl[keep], tg[keep])
    assert torch.equal(t2, tau) and torch.equal(m2, m_hat)


# ---------------------------------------------------------------------------
# layout handshake and the serving handoff
# ---------------------------------------------------------------------------

def test_verify_layouts_raises_on_a_mismatch():
    strat = MaTUStrategy(3, 64, device="cpu")
    ups = [Upload(0, [0, 1], torch.zeros(2, 64), [5, 5], fingerprint="a"),
           Upload(1, [2], torch.zeros(1, 64), [5])]
    strat.verify_layouts(ups)                 # no expectations yet
    strat.use_layouts({0: "a", 1: "a", 2: "b"})
    strat.verify_layouts(ups)                 # unstamped uploads pass
    ups[1].fingerprint = "c"
    with pytest.raises(TaskVectorLayoutError, match="task 2"):
        strat.verify_layouts(ups)
    with pytest.raises(TaskVectorLayoutError):
        strat.aggregate(ups)
    # the JAX package's check agrees on the same uploads
    from repro.fed.strategies import MaTUStrategy as JStrategy
    js = JStrategy(3, 64)
    js.use_layouts({0: "a", 1: "a", 2: "b"})
    with pytest.raises(Exception, match="task 2"):
        js.verify_layouts([JUploadS(u.client_id, u.task_ids,
                                    np.zeros((len(u.task_ids), 64)),
                                    u.data_sizes, fingerprint=u.fingerprint)
                           for u in ups])


def test_serving_downlink_matches_jax():
    """After the same round: the task vectors agree to rtol 1e-5; fed the
    JAX round's own task vectors, the packed downlink's bf16 unified and
    words are bitwise JAX's and λ within rtol 1e-5; the bool layout
    carries the same bits."""
    r = rig()
    jtv = np.asarray(r["jserver"].last_task_vectors)
    server = r["server"]
    np.testing.assert_allclose(server.last_task_vectors.numpy(), jtv,
                               rtol=RTOL, atol=ATOL)
    own = server.serving_downlink(fingerprint="f")
    port = MaTUServer(MaTUServerConfig(n_tasks=N_TASKS), device="cpu")
    port.last_task_vectors = torch.from_numpy(jtv.copy())
    for dl in (own, port.serving_downlink(fingerprint="f")):
        assert dl.fingerprint == "f" and dl.packed
        np.testing.assert_array_equal(
            dl.unified.view(torch.int16).numpy(),
            np.asarray(r["jdl"].unified).view(np.int16))
        np.testing.assert_array_equal(bitpack.words_to_numpy(dl.masks),
                                      np.asarray(r["jdl"].masks))
        np.testing.assert_allclose(dl.lams.numpy(), np.asarray(r["jdl"].lams),
                                   rtol=RTOL)
    dense = port.serving_downlink(packed=False)
    assert dense.fingerprint is None and dense.masks.dtype == torch.bool
    assert torch.equal(bitpack.pack_bits(dense.masks),
                       port.serving_downlink().masks)
    # the coded handoff: bf16 unified and the Golomb-Rice stream, byte
    # for byte the JAX server's on the same task vectors
    coded = port.serving_downlink(code_masks=True, fingerprint="f")
    jcoded = r["jserver"].serving_downlink(code_masks=True)
    assert coded.coded and coded.fingerprint == "f"
    assert coded.masks.numpy().tobytes() == np.asarray(jcoded.masks).tobytes()
    assert torch.equal(coded.unified.view(torch.int16),
                       port.serving_downlink().unified.view(torch.int16))
    assert torch.equal(coded.mask_row(slice(0, N_TASKS)),
                       port.serving_downlink().masks)
    with pytest.raises(ValueError, match="completed round"):
        MaTUServer(MaTUServerConfig(n_tasks=2),
                   device="cpu").serving_downlink()


# ---------------------------------------------------------------------------
# store: ingest layouts, fingerprint handshake, LRU, storage
# ---------------------------------------------------------------------------

def test_store_ingest_layouts_agree():
    packed, dense = port_store(packed=True), port_store(packed=False)
    for t in range(N_TASKS):
        assert torch.equal(packed.mask_words(t), dense.mask_words(t))
        assert packed.mask_words(t).dtype == torch.int32
        assert torch.equal(packed.lam(t), dense.lam(t))
    # the packed store's deltas are the JAX store's, bit for bit
    r = rig()
    jstore = JStore(r["jspace"], r["jlora0"])
    jstore.ingest(r["jdl"])
    for t in range(N_TASKS):
        np.testing.assert_array_equal(packed.delta(t).numpy(),
                                      np.asarray(jstore.delta(t)))


def test_store_fingerprint_handshake():
    r = rig()
    store = ModulatorStore(r["space"], r["lora0"], device="cpu")
    with pytest.raises(TaskVectorLayoutError, match="mismatch"):
        store.ingest(port_downlink(r["jdl"], fingerprint="0" * 16))
    with pytest.raises(TaskVectorLayoutError, match="unstamped"):
        store.ingest(port_downlink(r["jdl"], fingerprint=None))
    assert store.ingest(port_downlink(r["jdl"], fingerprint=None),
                        unchecked=True) == list(range(N_TASKS))
    short = ClientDownlink(torch.zeros(10), torch.zeros(1, 1,
                           dtype=torch.int32), torch.ones(1),
                           fingerprint=r["space"].fingerprint)
    with pytest.raises(TaskVectorLayoutError, match="coords"):
        store.ingest(short)


def test_store_lru_eviction_and_rebuild():
    store = port_store(capacity=2)
    a0 = store.adapter(0)
    store.adapter(1)
    assert store.cached_task_ids() == [0, 1]
    store.adapter(0)
    assert store.cached_task_ids() == [1, 0]
    store.adapter(2)
    assert store.cached_task_ids() == [0, 2]
    assert store.hits == 1 and store.misses == 3
    store.adapter(0)
    a1 = store.adapter(1)                 # rebuilt after its eviction
    rebuilt = store.adapter(1)
    assert store.materializations == 4 and store.hits == 3
    assert all(torch.equal(x, y) for x, y in zip(
        _leaves(a1), _leaves(rebuilt)))
    assert all(torch.equal(x, y) for x, y in zip(
        _leaves(a0), _leaves(store.adapter(0))))
    with pytest.raises(KeyError, match="no resident modulator"):
        store.adapter(99)


def _leaves(tree):
    from repro_torch.common.tree import tree_leaves
    return tree_leaves(tree)


def test_store_capacity_validation():
    r = rig()
    with pytest.raises(ValueError, match="capacity"):
        ModulatorStore(r["space"], r["lora0"], capacity=0, device="cpu")


def test_storage_report_at_t30_matches_jax():
    r = rig()
    T = 30
    rng = np.random.default_rng(0)
    d = r["space"].d
    words = rng.integers(0, 2 ** 32, (T, bitpack.packed_width(d)),
                         dtype=np.uint32)
    uni = rng.standard_normal(d).astype(np.float32)
    jdl = JDownlink(jnp.asarray(uni).astype(jnp.bfloat16), jnp.asarray(words),
                    jnp.ones((T,), jnp.float32),
                    fingerprint=r["jspace"].fingerprint)
    jstore = JStore(r["jspace"], r["jlora0"])
    jstore.ingest(jdl)
    store = ModulatorStore(r["space"], r["lora0"], device="cpu")
    store.ingest(port_downlink(jdl))
    want, got = jstore.storage_report(), store.storage_report()
    assert got == want
    assert got["tasks"] == T and got["ratio"] >= 5.0


# ---------------------------------------------------------------------------
# routing and generation
# ---------------------------------------------------------------------------

def _sites(node, prefix=""):
    if not isinstance(node, dict):
        return
    if "a" in node and "b" in node:
        yield prefix, node
        return
    for k in node:
        yield from _sites(node[k], f"{prefix}/{k}")


def test_fused_route_matches_jax_bitwise():
    """Per-layer words, λ and α of every fused site, and the dense-routed
    leaves, bitwise against the JAX router on the same downlink."""
    r = rig()
    ids = [0, 3, 1, 2]
    jstore = JStore(r["jspace"], r["jlora0"])
    jstore.ingest(r["jdl"])
    jt = dict(_sites(j_route_batch(jstore, ids, fused=True)))
    tt = dict(_sites(route_batch(port_store(), ids, fused=True)))
    assert jt.keys() == tt.keys() and tt
    for path, site in tt.items():
        js = jt[path]
        for f in ("a", "b"):
            np.testing.assert_array_equal(
                bitpack.words_to_numpy(site[f]["words"]),
                np.asarray(js[f]["words"]))
            np.testing.assert_array_equal(site[f]["base"].numpy(),
                                          np.asarray(js[f]["base"]))
            np.testing.assert_array_equal(site[f]["tau"].numpy(),
                                          np.asarray(js[f]["tau"]))
        np.testing.assert_array_equal(site["lam"].numpy(),
                                      np.asarray(js["lam"]))
        np.testing.assert_array_equal(site["alpha"].numpy(),
                                      np.asarray(js["alpha"]))
    jd = dict(_sites(j_route_batch(jstore, ids)))
    for path, site in _sites(route_batch(port_store(), ids)):
        for f in ("a", "b", "alpha"):
            np.testing.assert_array_equal(site[f].numpy(),
                                          np.asarray(jd[path][f]))


def test_fused_weight_equals_dense_adapter_bitwise():
    """x = I through the fused site's plain kernel version gives the
    dense-routed adapter leaf, bit for bit (fp32, no fma contraction)."""
    store = port_store()
    ids = [2, 0, 1, 3]
    fused = dict(_sites(route_batch(store, ids, fused=True)))
    dense = dict(_sites(route_batch(store, ids)))
    for path, site in fused.items():
        for f in ("a", "b"):
            fs = site[f]
            k = fs["base"].shape[1]
            eye = torch.eye(k).expand(len(ids), k, k).contiguous()
            for layer in range(fs["base"].shape[0]):
                w = ops.modulated_matmul(eye, fs["base"][layer],
                                         fs["tau"][layer],
                                         fs["words"][layer],
                                         site["lam"][layer])
                assert torch.equal(w, dense[path][f][layer]), (path, f)


@functools.lru_cache(maxsize=1)
def jax_tokens():
    r = rig()
    jstore = JStore(r["jspace"], r["jlora0"])
    jstore.ingest(r["jdl"])
    dec = JDecoder(r["jm"], r["jparams"], jstore, cfg=J_GEN)
    return np.asarray(dec.generate(jnp.asarray(r["prompts"]), [0, 3, 1, 2]))


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_decoder_tokens_match_jax(fused):
    """Fused and dense-routed decode give identical tokens, equal to the
    JAX decoder's on the same downlink."""
    r = rig()
    dec = MultiTenantDecoder(r["m"], r["params"], port_store(), fused=fused,
                             cfg=GEN, device="cpu")
    out = dec.generate(torch.from_numpy(r["prompts"]), [0, 3, 1, 2])
    np.testing.assert_array_equal(out.numpy(), jax_tokens())


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_mixed_batch_bitwise_equals_single_tenant(packed):
    """A mixed dense-routed batch equals single-tenant decode — the same
    prompts under one task's dense unpacked modulator as a plain 2-D
    LoRA tree — row for row, bit for bit (prefill logits and tokens).
    The single-tenant runs keep the batch shape: the CPU BLAS takes a
    gemv path for one row, which sums in another order."""
    r = rig()
    store = port_store(packed=packed)
    ids = [0, 1, 2, 3]
    prompts = torch.from_numpy(r["prompts"])
    m, params = r["m"], r["params"]
    mixed, _ = m.prefill_step(params, route_batch(store, ids),
                              {"tokens": prompts}, m.init_cache(N_TASKS, 16))
    out = MultiTenantDecoder(m, params, store, cfg=GEN,
                             device="cpu").generate(prompts, ids)
    for row, t in enumerate(ids):
        delta = modulate(store.unified, store.mask_words(t), store.lam(t))
        lora_t = tree_add(r["lora0"], r["space"].unflatten(delta))
        one, _ = m.prefill_step(params, lora_t, {"tokens": prompts},
                                m.init_cache(N_TASKS, 16))
        assert torch.equal(mixed[row], one[row])
        single = generate(m, params, lora_t, prompts, GEN)
        assert torch.equal(out[row], single[row])


def test_plain_mode_matches_default_dispatch_on_cpu():
    r = rig()
    prompts = torch.from_numpy(r["prompts"])
    outs = [MultiTenantDecoder(r["m"], r["params"], port_store(), fused=True,
                               cfg=GEN, mode=mode,
                               device="cpu").generate(prompts, [1, 1, 0, 2])
            for mode in (None, "ref")]
    assert torch.equal(outs[0], outs[1])


def test_decoder_validates_batch():
    r = rig()
    dec = MultiTenantDecoder(r["m"], r["params"], port_store(), cfg=GEN,
                             device="cpu")
    prompts = torch.from_numpy(r["prompts"])
    with pytest.raises(ValueError, match="task ids"):
        dec.generate(prompts, [0, 1])
    with pytest.raises(KeyError, match="no resident modulator"):
        dec.generate(prompts, [0, 1, 2, 99])
    with pytest.raises(ValueError, match="at least one"):
        route_batch(port_store(), [])


def test_unaligned_sites_fall_back_to_dense_routed():
    """At rank 3 over d_model 120, every factor (120·3 = 360 bits) is
    unaligned: the fused route takes dense-routed leaves site by site,
    and decodes the tokens of the dense route."""
    cfg = load_arch("qwen2-0.5b").reduced()
    cfg.d_model, cfg.lora_rank = 120, 3
    m = cfg.build(device="cpu")
    params, lora0 = m.init(0), m.lora_init(1)
    space = TaskVectorSpace.from_tree(lora0)
    rng = np.random.default_rng(1)
    server = MaTUServer(MaTUServerConfig(n_tasks=2), device="cpu")
    server.last_task_vectors = torch.from_numpy(
        (0.05 * rng.standard_normal((2, space.d))).astype(np.float32))
    store = ModulatorStore(space, lora0, device="cpu")
    store.ingest(server.serving_downlink(fingerprint=space.fingerprint))
    tree = route_batch(store, [1, 0], fused=True)
    assert not any(isinstance(s["a"], dict) for _, s in _sites(tree))
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 6)))
    outs = [MultiTenantDecoder(m, params, store, fused=f, cfg=GEN,
                               device="cpu").generate(prompts, [1, 0])
            for f in (False, True)]
    assert torch.equal(outs[0], outs[1])


class _FakeModel:
    """Constant-logit decode stack: isolates the sampling loop."""

    def __init__(self, vocab=101):
        g = torch.Generator().manual_seed(9)
        self.logits = torch.randn((1, vocab), generator=g)

    def init_cache(self, b, max_len):
        return {}

    def prefill_step(self, params, lora, batch, cache, mode=None):
        return self.logits.expand(batch["tokens"].shape[0], -1), cache

    def decode_fn(self, params, lora, batch, cache, pos, mode=None):
        return self.logits.expand(batch["tokens"].shape[0], -1), cache


def test_generate_samples_from_two_streams():
    """At temperature > 0 the prefill sample and the decode steps draw
    from two generator streams split off the caller's; draws differ."""
    model = _FakeModel()
    cfg = GenerationConfig(max_new_tokens=12, temperature=1.0, top_k=20)
    out = generate(model, {}, {}, torch.ones((1, 4), dtype=torch.int32), cfg,
                   rng=torch.Generator().manual_seed(42))
    draws = out[0, 4:].tolist()
    assert len(set(draws)) > 1
    top = set(torch.topk(model.logits[0], 20).indices.tolist())
    assert set(draws) <= top
    rng = torch.Generator().manual_seed(42)
    s0, _ = torch.randint(0, 2 ** 62, (2,), generator=rng).tolist()
    first = _sample(model.logits, cfg, torch.Generator().manual_seed(s0))
    assert draws[0] == int(first[0])
    again = generate(model, {}, {}, torch.ones((1, 4), dtype=torch.int32),
                     cfg, rng=torch.Generator().manual_seed(42))
    assert torch.equal(out, again)


def test_generate_stops_at_eos():
    model = _FakeModel()
    eos = int(torch.argmax(model.logits))
    out = generate(model, {}, {}, torch.ones((2, 3), dtype=torch.int32),
                   GenerationConfig(max_new_tokens=4, eos_id=eos))
    assert (out[:, 3:] == eos).all()
