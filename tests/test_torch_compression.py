"""The port's entropy-coded mask wire against the JAX package's, on the
CPU: the Golomb-Rice coder's streams byte for byte (the density and
width grid, the raw escape, ``_with_sizes``, every ``CodedStreamError``
case, tiny chunks on 1 and 4 workers), the accounting helpers, and the
coded layer through the stack — coded uploads and downlinks, the coded
bool and packed rounds against the raw ones, downlink streams and the
serving handoff against JAX's ``ref`` round, ``MaTUClient``, the
strategy's coded wire and the store's coded ingest."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fed.compression as jc  # noqa: E402
import repro_torch.fed.compression as tc  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.client import MaTUClient as JClient  # noqa: E402
from repro.core.engine import EngineConfig as JEngCfg  # noqa: E402
from repro.core.engine import RoundEngine as JEngine  # noqa: E402
from repro.core.server import MaTUServer as JServer  # noqa: E402
from repro.core.server import MaTUServerConfig as JServerCfg  # noqa: E402
from repro.fed import strategies as jstr  # noqa: E402
from repro.kernels.bitpack import pack_bits_np as j_pack_bits_np  # noqa: E402
from repro.kernels.bitpack import scatter_bits_np as j_scatter  # noqa: E402
from repro_torch.common.tree import TaskVectorSpace  # noqa: E402
from repro_torch.core import MaTUClient  # noqa: E402
from repro_torch.core.client import ClientDownlink, ClientUpload  # noqa: E402
from repro_torch.core.engine import (EngineConfig, RoundEngine,  # noqa: E402
                                     pack_uploads)
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402
from repro_torch.core.unify import unify_with_modulators  # noqa: E402
from repro_torch.fed import strategies as tstr  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from repro_torch.serve.store import ModulatorStore  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

HDR = tc.HEADER_BYTES
DENSITIES = [0.0, 1e-3, 0.25, 0.5, 0.75, 1.0, "one_bit"]
WIDTHS = [1, 31, 33, 4099]


def _rows(rng, d, p, k=3):
    """(k, d) bool rows of density ``p`` ("one_bit": one set bit each)."""
    if p == "one_bit":
        m = np.zeros((k, d), bool)
        m[np.arange(k), rng.integers(0, d, k)] = True
        return m
    return rng.random((k, d)) < p


def _same_bytes(a, b):
    assert a.dtype == b.dtype == np.uint8
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the coder: byte for byte
# ---------------------------------------------------------------------------

def test_scatter_bits_np_matches_jax():
    rng = np.random.default_rng(0)
    for n_bytes in (0, 1, 7, 100):
        pos = rng.integers(0, max(8 * n_bytes, 1), 3 * n_bytes) \
            if n_bytes else np.zeros(0, np.int64)
        _same_bytes(bitpack.scatter_bits_np(pos, n_bytes),
                    j_scatter(pos, n_bytes))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("p", DENSITIES)
def test_streams_byte_identical_to_jax(d, p):
    """Scalar records, the batched stream, its record sizes and both
    decoders, at every density of the grid and widths on either side of
    a word boundary."""
    rng = np.random.default_rng(d)
    words = bitpack.pack_bits_np(_rows(rng, d, p))
    np.testing.assert_array_equal(words, j_pack_bits_np(_rows(
        np.random.default_rng(d), d, p)))
    for row in words:
        s = tc.rice_encode_words(row, d)
        _same_bytes(s, jc.rice_encode_words(row, d))
        got, used = tc.rice_decode_words(s, d)
        assert used == s.size and np.array_equal(got, row)
        assert s.size <= HDR + 4 * bitpack.packed_width(d)
    stream, sizes = tc.encode_mask_rows_with_sizes(words, d)
    j_stream, j_sizes = jc.encode_mask_rows_with_sizes(words, d)
    _same_bytes(stream, j_stream)
    np.testing.assert_array_equal(sizes, j_sizes)
    _same_bytes(tc.encode_mask_rows(words, d),
                tc.encode_mask_rows_reference(words, d))
    _same_bytes(tc.encode_mask_rows(words[0], d),
                jc.encode_mask_rows(words[0], d))
    np.testing.assert_array_equal(tc.decode_mask_rows(stream, d, 3), words)
    np.testing.assert_array_equal(
        tc.decode_mask_rows_reference(stream, d, 3), words)
    # the record sizes split the stream into the per-row records
    off = 0
    for i, z in enumerate(sizes):
        np.testing.assert_array_equal(
            tc.decode_mask_rows(stream[off:off + int(z)], d, 1)[0], words[i])
        off += int(z)


def test_raw_escape_and_empty_rows_match_jax():
    rng = np.random.default_rng(2)
    d = 1 << 14
    words = bitpack.pack_bits_np(rng.random((2, d)) < 0.5)
    s = tc.encode_mask_rows(words, d)
    _same_bytes(s, jc.encode_mask_rows(words, d))
    assert s.size == 2 * (HDR + 4 * bitpack.packed_width(d))
    assert s[0] & 0x02                             # the raw-escape bit
    for ones in (False, True):                     # n = 0: header only
        w = bitpack.pack_bits_np(np.full((1, 100), ones))
        e = tc.encode_mask_rows(w, 100)
        assert e.size == HDR
        _same_bytes(e, jc.encode_mask_rows(w, 100))
    assert tc.encode_mask_rows_with_sizes(np.zeros((0, 4), np.uint32),
                                          100)[0].size == 0
    with pytest.raises(ValueError, match="packed_width"):
        tc.encode_mask_rows(np.zeros((1, 3), np.uint32), 100)


def test_measured_accounting_matches_jax():
    rng = np.random.default_rng(3)
    for d, p in ((9999, 0.3), (1 << 16, 0.75), (64, 1.0)):
        mask = rng.random(d) < p
        assert tc.golomb_encode_bits(mask) == jc.golomb_encode_bits(mask)
        assert tc.mask_entropy_bits(mask) == jc.mask_entropy_bits(mask)
        words = bitpack.pack_bits_np(mask)
        assert tc.coded_mask_bits(words, d) == jc.coded_mask_bits(words, d)
        assert tc.coded_mask_bits(mask[None], d) == jc.coded_mask_bits(
            mask[None], d)
        stream = tc.encode_mask_rows(words, d)
        assert tc.coded_mask_bits(stream, d) == 8 * stream.size
    assert tc.golomb_encode_bits(np.ones(64, bool)) == 8 * HDR
    # biased masks go under a bit a coordinate, near the Shannon bound
    mask = rng.random(1 << 18) < 0.75
    assert tc.golomb_encode_bits(mask) < min(
        8 * 4 * bitpack.packed_width(mask.size),
        1.05 * tc.mask_entropy_bits(mask))


def test_bf16_transport_and_compressed_uplink_bits_match_jax():
    rng = np.random.default_rng(4)
    d, k = 3000, 3
    v = rng.standard_normal(d).astype(np.float32)
    q, cos = tc.quantize_bf16(torch.from_numpy(v))
    jq, jcos = jc.quantize_bf16(jnp.asarray(v))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(cos, jcos, rtol=1e-6)
    assert cos > 0.999
    masks = rng.random((k, d)) < 0.75
    words = bitpack.pack_bits_np(masks)
    stream = tc.encode_mask_rows(words, d)
    t_v, j_v = torch.from_numpy(v), jnp.asarray(v)
    for t_m, j_m, kw in (
            (torch.from_numpy(masks), jnp.asarray(masks), {}),
            (bitpack.words_from_numpy(words), jnp.asarray(words), {}),
            (torch.from_numpy(stream), jnp.asarray(stream), {"n_rows": k}),
            (bitpack.words_from_numpy(words), jnp.asarray(words),
             {"use_entropy_bound": True}),
            (torch.from_numpy(stream), jnp.asarray(stream),
             {"n_rows": k, "use_entropy_bound": True})):
        assert tc.compressed_uplink_bits(t_v, t_m, **kw) == \
            jc.compressed_uplink_bits(j_v, j_m, **kw)
    with pytest.raises(ValueError, match="n_rows"):
        tc.compressed_uplink_bits(t_v, torch.from_numpy(stream))


# ---------------------------------------------------------------------------
# malformed streams: CodedStreamError exactly where JAX raises it
# ---------------------------------------------------------------------------

def _bad_streams():
    rng = np.random.default_rng(5)
    d = 700
    words = bitpack.pack_bits_np(rng.random((2, d)) < 0.8)
    stream = tc.encode_mask_rows(words, d)
    absurd = stream.copy()
    absurd[1:5] = np.array([255, 255, 255, 127], np.uint8)
    raw = tc.encode_mask_rows(bitpack.pack_bits_np(rng.random((1, d)) < 0.5),
                              d)
    return d, {
        "truncated header": (stream[:HDR - 2], 2),
        "truncated payload": (stream[:-1], 2),
        "run count past the stream": (absurd, 2),
        "trailing garbage": (np.concatenate([stream, np.array(
            [7, 7, 7], np.uint8)]), 2),
        "trailing bytes after fewer rows": (stream, 1),
        "bytes after zero rows": (stream, 0),
        "truncated raw payload": (raw[:-3], 1),
    }


@pytest.mark.parametrize("case", sorted(_bad_streams()[1]))
def test_malformed_streams_raise_coded_stream_error(case):
    d, cases = _bad_streams()
    bad, k = cases[case]
    assert issubclass(tc.CodedStreamError, ValueError)
    with pytest.raises(jc.CodedStreamError):
        jc.decode_mask_rows(bad, d, k)
    with pytest.raises(tc.CodedStreamError):
        tc.decode_mask_rows(bad, d, k)
    if k:     # the scalar reference raises what JAX's reference raises
        with pytest.raises(ValueError) as want:
            jc.decode_mask_rows_reference(bad, d, k)
        with pytest.raises(ValueError) as got:
            tc.decode_mask_rows_reference(bad, d, k)
        assert type(got.value).__name__ == type(want.value).__name__


def test_fuzzed_streams_decode_or_raise_as_jax_does():
    """Truncated or bit-flipped streams: the port raises CodedStreamError
    exactly when JAX does, and otherwise decodes the same words."""
    rng = np.random.default_rng(99)
    d = 513
    typed = 0
    for _ in range(60):
        k = int(rng.integers(1, 4))
        words = bitpack.pack_bits_np(np.stack(
            [rng.random(d) < float(rng.choice([0.05, 0.5, 0.9]))
             for _ in range(k)]))
        bad = tc.encode_mask_rows(words, d)
        if rng.random() < 0.5 and bad.size > 1:
            bad = bad[:int(rng.integers(0, bad.size))]
        else:
            pos = int(rng.integers(bad.size * 8))
            bad[pos // 8] ^= np.uint8(1 << (pos % 8))
        try:
            want = jc.decode_mask_rows(bad, d, k)
        except jc.CodedStreamError:
            with pytest.raises(tc.CodedStreamError):
                tc.decode_mask_rows(bad, d, k)
            typed += 1
            continue
        np.testing.assert_array_equal(tc.decode_mask_rows(bad, d, k), want)
    assert typed > 0


@pytest.mark.parametrize("workers", ["1", "4"])
def test_tiny_chunks_on_the_pool_are_byte_invisible(monkeypatch, workers):
    rng = np.random.default_rng(11)
    d = 257
    words = bitpack.pack_bits_np(
        np.stack([rng.random(d) < rng.random() for _ in range(50)]))
    want = jc.encode_mask_rows_reference(words, d)
    monkeypatch.setenv("REPRO_CODER_WORKERS", workers)
    monkeypatch.setattr(tc, "_ENC_CHUNK_BITS", 512)
    monkeypatch.setattr(tc, "_DEC_WINDOW_BYTES", 64)
    monkeypatch.setattr(tc, "_DEC_DENSE_BITS", 1024)
    assert (tc._coder_pool() is None) == (workers == "1")
    stream, sizes = tc.encode_mask_rows_with_sizes(words, d)
    _same_bytes(stream, want)
    np.testing.assert_array_equal(sizes, jc.encode_mask_rows_with_sizes(
        words, d)[1])
    np.testing.assert_array_equal(tc.decode_mask_rows(stream, d, 50), words)


# ---------------------------------------------------------------------------
# the coded layer through the stack
# ---------------------------------------------------------------------------

N_TASKS, D = 5, 1000


def _wire_round(seed, n_clients=4):
    """The same uploads in four forms: port raw / coded, JAX raw / coded
    (bf16 vector, packed words or their Golomb-Rice stream)."""
    rng = np.random.default_rng(seed)
    out = {"raw": [], "coded": [], "jraw": [], "jcoded": []}
    for cid in range(n_clients):
        k = int(rng.integers(1, 4))
        tasks = sorted(rng.choice(N_TASKS, size=k, replace=False).tolist())
        tv = rng.standard_normal((k, D)).astype(np.float32)
        unified, masks, lams = unify_with_modulators(torch.from_numpy(tv))
        words_np = bitpack.pack_bits_np(masks.numpy())
        stream = tc.encode_mask_rows(words_np, D)
        vec = unified.to(torch.bfloat16)
        sizes = [100] * k
        out["raw"].append(ClientUpload(cid, tasks, vec,
                                       bitpack.words_from_numpy(words_np),
                                       lams, sizes))
        out["coded"].append(ClientUpload(cid, tasks, vec,
                                         torch.from_numpy(stream), lams,
                                         sizes))
        jvec = jnp.asarray(vec.float().numpy()).astype(jnp.bfloat16)
        jl = jnp.asarray(lams.numpy())
        out["jraw"].append(JUpload(cid, tasks, jvec, jnp.asarray(words_np),
                                   jl, sizes))
        out["jcoded"].append(JUpload(cid, tasks, jvec, jnp.asarray(stream),
                                     jl, sizes))
    return out


def test_coded_upload_accounting_and_dense_masks():
    w = _wire_round(5)
    for raw, coded, jcoded in zip(w["raw"], w["coded"], w["jcoded"]):
        assert coded.coded and not coded.packed and not raw.coded
        k = len(coded.task_ids)
        assert coded.uplink_bits() == 16 * D + 8 * coded.masks.numel() + 32 * k
        assert coded.uplink_bits() == jcoded.uplink_bits()
        assert coded.uplink_bits() <= raw.uplink_bits() + 8 * HDR * k
        assert torch.equal(coded.masks_dense(), raw.masks_dense())
        assert coded.masks_dense() is coded.masks_dense()     # cached


@pytest.mark.parametrize("packed", [True, False])
def test_coded_round_equals_raw_round_bitwise(packed):
    """pack_uploads decodes coded uploads into the raw uploads' slot
    tensors; the coded round's outputs and its decoded downlinks equal
    the raw round's, bit for bit, in the packed and the bool layout."""
    w = _wire_round(6)
    b_raw = pack_uploads(w["raw"], N_TASKS, packed=packed, device="cpu")
    b_cod = pack_uploads(w["coded"], N_TASKS, packed=packed, device="cpu")
    assert torch.equal(b_raw.slot_masks, b_cod.slot_masks)
    assert torch.equal(b_raw.unified, b_cod.unified)
    eng = RoundEngine(EngineConfig(n_tasks=N_TASKS), device="cpu")
    downs_raw, out_raw = eng.round(w["raw"], packed=packed)
    downs_cod, out_cod = eng.round(w["coded"], packed=packed,
                                   code_masks=True)
    for f in ("task_vectors", "tau_hats", "similarity", "down_lams"):
        assert torch.equal(getattr(out_raw, f), getattr(out_cod, f)), f
    for cid, raw in downs_raw.items():
        dl = downs_cod[cid]
        k = int(dl.lams.shape[0])
        assert dl.coded and dl.masks.dtype == torch.uint8
        assert torch.equal(dl.masks_dense(), raw.masks_dense())
        want = raw.masks if packed else bitpack.pack_bits(raw.masks)
        assert torch.equal(dl.mask_row(k - 1), want[k - 1])
        assert torch.equal(dl.mask_row(slice(0, k)), want)
        assert dl.downlink_bits() <= (bitpack.wire_bits(D, k, vec_bytes_per_elem=
                                                        dl.unified.element_size())
                                      + 8 * HDR * k)


def test_downlink_streams_byte_identical_to_jax_ref():
    """The coded round's per-client downlink streams equal the JAX
    engine's (``mode="ref"``, coded uploads in, coded downlinks out)
    byte for byte, as do their measured bits."""
    w = _wire_round(7)
    eng = RoundEngine(EngineConfig(n_tasks=N_TASKS), device="cpu")
    downs, _ = eng.round(w["coded"], code_masks=True)
    jdowns, _ = JEngine(JEngCfg(n_tasks=N_TASKS)).round(
        w["jcoded"], mode="ref", code_masks=True)
    assert set(downs) == set(jdowns)
    for cid, dl in downs.items():
        _same_bytes(dl.masks.numpy(), np.asarray(jdowns[cid].masks))
        assert dl.downlink_bits() == jdowns[cid].downlink_bits()
        np.testing.assert_array_equal(
            dl.unified.view(torch.int16).numpy(),
            np.asarray(jdowns[cid].unified).view(np.int16))


def test_server_round_and_serving_handoff_coded():
    """``MaTUServer.round(code_masks=True)`` and the coded serving
    handoff: the stream is JAX's byte for byte, its decoded words the
    packed handoff's, and a store ingests the same words and λ from it
    as from the raw handoff."""
    w = _wire_round(8)
    server = MaTUServer(MaTUServerConfig(n_tasks=N_TASKS), device="cpu")
    downs = server.round(w["coded"], code_masks=True)
    assert all(dl.coded for dl in downs.values())
    jserver = JServer(JServerCfg(n_tasks=N_TASKS))
    jserver.round(w["jcoded"])
    # the handoff on the JAX round's own task vectors
    server.last_task_vectors = torch.from_numpy(
        np.asarray(jserver.last_task_vectors).copy())
    coded = server.serving_downlink(code_masks=True, fingerprint="f")
    raw = server.serving_downlink(fingerprint="f")
    _same_bytes(coded.masks.numpy(),
                np.asarray(jserver.serving_downlink(code_masks=True).masks))
    assert torch.equal(coded.unified.view(torch.int16),
                       raw.unified.view(torch.int16))
    assert torch.equal(coded.mask_row(slice(0, N_TASKS)), raw.masks)
    space = TaskVectorSpace.from_tree({"w": torch.zeros(D)})
    stores = []
    for dl in (raw, coded):
        dl.fingerprint = space.fingerprint
        store = ModulatorStore(space, {"w": torch.zeros(D)}, device="cpu")
        assert store.ingest(dl) == list(range(N_TASKS))
        stores.append(store)
    for t in range(N_TASKS):
        assert torch.equal(stores[0].mask_words(t), stores[1].mask_words(t))
        assert torch.equal(stores[0].lam(t), stores[1].lam(t))
        assert torch.equal(stores[0].delta(t), stores[1].delta(t))


def test_store_ingest_of_a_coded_downlink_with_task_ids():
    rng = np.random.default_rng(9)
    words = bitpack.pack_bits_np(rng.random((3, D)) < 0.75)
    uni = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    lams = torch.tensor([1.5, 2.0, 0.5])
    space = TaskVectorSpace.from_tree({"w": torch.zeros(D)})
    coded = ClientDownlink(uni.to(torch.bfloat16),
                           torch.from_numpy(tc.encode_mask_rows(words, D)),
                           lams, fingerprint=space.fingerprint)
    store = ModulatorStore(space, {"w": torch.zeros(D)}, device="cpu")
    assert store.ingest(coded, task_ids=[7, 2, 4]) == [7, 2, 4]
    for i, t in enumerate([7, 2, 4]):
        assert torch.equal(store.mask_words(t),
                           bitpack.words_from_numpy(words[i]))
        assert torch.equal(store.lam(t), lams[i])
    assert coded._words is not None            # decoded once, cached


@pytest.mark.parametrize("code_masks", [False, True])
def test_matu_client_run_round_matches_jax(code_masks):
    """``MaTUClient.run_round`` with a deterministic trainer (its task's
    downlinked τ plus a fixed offset), raw and coded, against JAX's
    client; then ``receive`` and ``task_vector_init`` through a coded
    downlink."""
    rng = np.random.default_rng(10)
    d = 777
    offsets = {t: (0.1 * rng.standard_normal(d)).astype(np.float32)
               for t in (1, 3)}

    def t_trainer(t, tv, generator):
        assert isinstance(generator, torch.Generator)
        return tv + torch.from_numpy(offsets[t])

    def j_trainer(t, tv, key):
        return tv + jnp.asarray(offsets[t])

    client = MaTUClient(4, [1, 3], [50, 60], d, t_trainer,
                        code_masks=code_masks)
    jclient = JClient(4, [1, 3], [50, 60], d, j_trainer,
                      code_masks=code_masks)
    up = client.run_round(torch.Generator().manual_seed(0))
    jup = jclient.run_round(jax.random.PRNGKey(0))
    assert up.coded == jup.coded == code_masks
    assert up.uplink_bits() == jup.uplink_bits()
    np.testing.assert_allclose(up.lams.numpy(), np.asarray(jup.lams),
                               rtol=1e-6)
    if code_masks:
        _same_bytes(up.masks.numpy(), np.asarray(jup.masks))
        np.testing.assert_array_equal(
            up.unified.view(torch.int16).numpy(),
            np.asarray(jup.unified).view(np.int16))
    else:
        np.testing.assert_array_equal(up.masks.numpy(), np.asarray(jup.masks))
        np.testing.assert_array_equal(up.unified.numpy(),
                                      np.asarray(jup.unified))
    # the next round starts from a coded downlink, decoded on use
    words = bitpack.pack_bits_np(up.masks_dense().numpy())
    dl = ClientDownlink(up.unified.to(torch.bfloat16),
                        torch.from_numpy(tc.encode_mask_rows(words, d)),
                        up.lams)
    client.receive(dl)
    raw = ClientDownlink(dl.unified, bitpack.words_from_numpy(words), up.lams)
    for i in range(2):
        want = MaTUClient(4, [1, 3], [50, 60], d)
        want.receive(raw)
        assert torch.equal(client.task_vector_init(i),
                           want.task_vector_init(i))
    assert not MaTUClient(0, [0], [1], d).task_vector_init(0).any()
    with pytest.raises(ValueError, match="needs d"):
        MaTUClient(0, [0], [1])


def test_matu_client_layout_handshake():
    space = TaskVectorSpace.from_tree({"w": torch.zeros(40)})
    client = MaTUClient(0, [0], [1], space=space)
    assert client.d == 40 and client.fingerprint == space.fingerprint
    client.verify_layout(space.fingerprint)
    with pytest.raises(ValueError):
        client.verify_layout("0" * 16)


def _scripted_uploads(rng, n_tasks=5, d=2048, n=6):
    out = []
    for cid in range(n):
        k = int(rng.integers(2, 4))
        tasks = sorted(rng.choice(n_tasks, size=k, replace=False).tolist())
        out.append((cid, tasks, rng.standard_normal((k, d)).astype(
            np.float32), [100] * k))
    return out


def test_matu_strategy_coded_wire_equals_raw_and_matches_jax():
    """``MaTUStrategy(code_masks=True)``: the same server results as the
    raw wire bit for bit, every coded upload decodes to the raw upload's
    words, coded bits never above raw + a header a row, and the measured
    bits equal the JAX strategy's on the same uploads, two rounds (the
    second starts from the coded downlinks)."""
    rng = np.random.default_rng(8)
    n_tasks, d = 5, 2048
    ups = _scripted_uploads(rng)
    res = {cm: tstr.MaTUStrategy(n_tasks, d, code_masks=cm, device="cpu")
           for cm in (False, True)}
    jres = jstr.MaTUStrategy(n_tasks, d, code_masks=True)
    for r in range(2):
        # round r's uploads: the raw wire's task_init plus fixed noise
        t_ups = [tstr.Upload(c, ts, torch.from_numpy(tv) + torch.stack(
            [res[False].task_init(c, t) for t in ts]), sz)
            for c, ts, tv, sz in ups]
        for strat in res.values():
            strat.aggregate_batch(tstr.RoundBatch.from_uploads(t_ups,
                                                               n_tasks))
        j_ups = [jstr.Upload(c, ts, jnp.asarray(u.task_vectors.numpy()), sz)
                 for (c, ts, _, sz), u in zip(ups, t_ups)]
        jres.aggregate_batch(jstr.RoundBatch.from_uploads(j_ups, n_tasks))
        raw, coded = res[False], res[True]
        for t in range(n_tasks):
            assert torch.equal(raw.eval_vectors(t)[0],
                               coded.eval_vectors(t)[0])
        assert torch.equal(raw.server.last_similarity,
                           coded.server.last_similarity)
        for u_raw, u_cod in zip(raw._last_uploads, coded._last_uploads):
            k = len(u_cod.task_ids)
            assert u_cod.coded and u_raw.packed
            words = tc.decode_mask_rows(u_cod.masks.numpy(), d, k)
            assert torch.equal(bitpack.words_from_numpy(words), u_raw.masks)
            assert u_cod.uplink_bits() <= u_raw.uplink_bits() + 8 * HDR * k
        for c, ts, _, _ in ups:
            assert coded.downlinks[c].coded
            assert torch.equal(coded.downlinks[c].mask_row(slice(None)),
                               raw.downlinks[c].masks)
            for t in ts:
                assert torch.equal(raw.task_init(c, t), coded.task_init(c, t))
        assert coded.uplink_bits(t_ups) == jres.uplink_bits(j_ups)
        assert coded.downlink_bits() == jres.downlink_bits()
        assert coded.uplink_bits(t_ups) < raw.uplink_bits(t_ups)


def test_matu_strategy_compress_is_accounting_only():
    rng = np.random.default_rng(12)
    n_tasks, d = 5, 2048
    ups = _scripted_uploads(rng)
    t_ups = [tstr.Upload(c, ts, torch.from_numpy(tv), sz)
             for c, ts, tv, sz in ups]
    j_ups = [jstr.Upload(c, ts, jnp.asarray(tv), sz) for c, ts, tv, sz in ups]
    plain = tstr.MaTUStrategy(n_tasks, d, device="cpu")
    comp = tstr.MaTUStrategy(n_tasks, d, compress=True, device="cpu")
    jcomp = jstr.MaTUStrategy(n_tasks, d, compress=True)
    for s in (plain, comp):
        s.aggregate(t_ups)
    jcomp.aggregate(j_ups)
    assert all(u.packed for u in comp._last_uploads)
    assert comp.uplink_bits(t_ups) == jcomp.uplink_bits(j_ups)
    assert comp.uplink_bits(t_ups) < plain.uplink_bits(t_ups)
    assert comp.downlink_bits() == plain.downlink_bits()
