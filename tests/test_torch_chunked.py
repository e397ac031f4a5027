"""The port's chunked population round, on the CPU.

* ``RoundEngine.round_chunked`` ≡ the port's monolithic ``round`` bit for
  bit (every output tensor, every downlink, the wire bits) for chunks of
  1, a non-divisor of N and more than N, both layouts, with staleness and
  with coded downlinks (streams byte-identical); a factory read twice, a
  sink, and the error cases.
* Against the JAX package's ``round_chunked(mode="ref")`` at the engine
  bar of ``tests/test_torch_engine.py``: alpha_num (its dtype too),
  n_held, m̂ bitwise; τ̂, task vectors, λ to rtol 1e-5; S within 1 ulp;
  downlink mask bits ≥ 99.999 % equal, bf16 within one ulp.
* ``alpha_num``'s dtype keyed on next_pow2(N), as JAX's, at N = 32, 129
  and 200.
* ``MaTUServer.round_legacy`` (the per-task oracle, sharing no code with
  the engine) against JAX's, and the chunked round against it, at that
  bar.
* ``MaTUStrategy(chunk_clients=3)`` ≡ the batched strategy bitwise,
  also with ``pipeline=True`` and with ``code_masks=True``.
* ``PopulationSimulator`` against JAX's: evaluation rounds, fault
  counters and wire bits equal; alignment and ``_tv_host`` to rtol 1e-5
  (atol 1e-7); run to run bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.client import ClientUpload as JUpload  # noqa: E402
from repro.core.server import MaTUServer as JServer  # noqa: E402
from repro.core.server import MaTUServerConfig as JServerConfig  # noqa: E402
from repro.core.unify import (  # noqa: E402
    unify_with_modulators as j_unify_with_modulators)
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.client import ClientUpload as TUpload  # noqa: E402
from repro_torch.core.server import MaTUServer, MaTUServerConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6
OUT_FIELDS = ("task_vectors", "tau_hats", "similarity", "alpha_num",
              "n_held", "m_hats_dense")


def make_uploads(seed, n, n_tasks, d, k_hi):
    """Ragged uploads built by JAX's client unify, the unified vectors
    rounded to bf16 at the wire: (JAX uploads, the same as port
    uploads)."""
    rng = np.random.default_rng(seed)
    jups, tups = [], []
    for cid in range(n):
        k = int(rng.integers(1, k_hi + 1))
        tasks = sorted(rng.choice(n_tasks, size=k, replace=False).tolist())
        uni, masks, lams = j_unify_with_modulators(jnp.asarray(
            rng.standard_normal((k, d)), jnp.float32))
        uni = np.array(uni.astype(jnp.bfloat16).astype(jnp.float32))
        sizes = rng.integers(10, 200, size=k).tolist()
        jups.append(JUpload(cid, tasks, jnp.asarray(uni), masks, lams, sizes))
        tups.append(TUpload(cid, tasks, torch.from_numpy(uni),
                            torch.from_numpy(np.array(masks)),
                            torch.from_numpy(np.array(lams)), sizes))
    return jups, tups


def bits(x):
    """A tensor's bit pattern, so -0.0 differs from 0.0."""
    if x.dtype in (torch.float32, torch.bfloat16):
        return x.view(torch.int32 if x.dtype == torch.float32
                      else torch.int16)
    return x


def assert_same(a, b, ctx):
    assert (a is None) == (b is None), ctx
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, ctx
        assert torch.equal(bits(a), bits(b)), ctx


def assert_outputs_same(out_a, out_b, ctx):
    for f in OUT_FIELDS:
        assert_same(getattr(out_a, f), getattr(out_b, f), f"{ctx}: {f}")


def assert_downlinks_same(downs_a, downs_b, ctx):
    assert downs_a.keys() == downs_b.keys(), ctx
    for cid, da in downs_a.items():
        for f in ("unified", "masks", "lams"):
            assert_same(getattr(da, f), getattr(downs_b[cid], f),
                        f"{ctx}: client {cid} {f}")


def engine(n_tasks, **kw):
    return teng.RoundEngine(teng.EngineConfig(n_tasks=n_tasks, **kw),
                            device="cpu")


N, T, D = 11, 6, 1000


@pytest.fixture(scope="module")
def ragged():
    return make_uploads(7, N, T, D, 3)


@pytest.mark.parametrize("wire", ["raw", "stale", "coded"])
@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_chunked_bitwise_monolithic(ragged, packed, chunk, wire):
    """Chunks of 1, 3 (not a divisor of 11) and 64 (> N) on a ragged
    round at d = 1,000 (not a word multiple): every output, every
    downlink (coded streams byte for byte) and the wire bits equal the
    monolithic round's."""
    _, ups = ragged
    kw = dict(packed=packed, code_masks=wire == "coded",
              staleness=[i % 3 for i in range(N)] if wire == "stale"
              else None)
    eng = engine(T)
    downs_m, out_m = eng.round(ups, **kw)
    downs_c, out_c, stats = eng.round_chunked(ups, chunk_clients=chunk, **kw)
    ctx = f"chunk {chunk} {'packed' if packed else 'bool'} {wire}"
    assert_outputs_same(out_m, out_c, ctx)
    assert_downlinks_same(downs_m, downs_c, ctx)
    assert out_c.down_unified is None and out_c.down_masks is None
    assert stats == {
        "uplink_bits": teng.pack_uploads(ups, T, packed=packed,
                                         device="cpu").wire_bits(),
        "downlink_bits": sum(dl.downlink_bits() for dl in downs_m.values()),
        "n_clients": N, "n_chunks": -(-N // chunk), "chunk_clients": chunk}
    if wire == "coded":
        assert all(dl.coded for dl in downs_c.values())


def assert_engine_bar(jo, to, jdowns, tdowns, ctx):
    """The port's round against JAX's at the engine bar."""
    if to.alpha_num is not None:
        assert to.alpha_num.numpy().dtype == np.asarray(jo.alpha_num).dtype
        np.testing.assert_array_equal(to.alpha_num.numpy(),
                                      np.asarray(jo.alpha_num), ctx)
        np.testing.assert_array_equal(to.n_held.numpy(),
                                      np.asarray(jo.n_held), ctx)
    np.testing.assert_array_equal(to.m_hats.numpy(), np.asarray(jo.m_hats),
                                  ctx)
    for f in ("tau_hats", "task_vectors"):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   np.asarray(getattr(jo, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{ctx}: {f}")
    s_t = to.similarity.numpy()
    s_j = np.asarray(jo.similarity, np.float32)
    assert np.abs(s_t.view(np.int32) - s_j.view(np.int32)).max() <= 1, ctx
    assert tdowns.keys() == jdowns.keys()
    for cid, jdl in jdowns.items():
        tdl = tdowns[cid]
        assert (tdl.masks_dense().numpy()
                == np.asarray(jdl.masks_dense())).mean() >= 0.99999, ctx
        if tdl.unified.dtype == torch.bfloat16:
            ulp = np.abs(tdl.unified.view(torch.int16).numpy().astype(int)
                         - np.asarray(jdl.unified).view(np.int16).astype(int))
            assert ulp.max() <= 1, ctx
        else:
            np.testing.assert_allclose(tdl.unified.numpy(),
                                       np.asarray(jdl.unified), rtol=RTOL,
                                       atol=ATOL, err_msg=ctx)
        np.testing.assert_allclose(tdl.lams.numpy(), np.asarray(jdl.lams),
                                   rtol=RTOL, atol=ATOL, err_msg=ctx)


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_chunked_matches_jax(ragged, packed, stale):
    jups, tups = ragged
    stal = [i % 3 for i in range(N)] if stale else None
    jd, jo, jstats = jeng.RoundEngine(jeng.EngineConfig(
        n_tasks=T)).round_chunked(jups, chunk_clients=3, mode="ref",
                                  packed=packed, staleness=stal)
    td, to, tstats = engine(T).round_chunked(tups, chunk_clients=3,
                                             packed=packed, staleness=stal)
    assert tstats == jstats
    assert_engine_bar(jo, to, jd, td, f"packed={packed} stale={stale}")


@pytest.mark.parametrize("n", [32, 129, 200])
def test_alpha_num_dtype_matches_jax(n):
    """JAX pads a round to next_pow2(N) rows and keys alpha_num's dtype
    on that: uint8 to 128 clients, int32 from 129.  The port's monolithic
    and chunked rounds key the same way."""
    jups, tups = make_uploads(n, n, 4, 64, 2)
    _, jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=4)).round(
        jups, mode="ref")
    _, to = engine(4).round(tups)
    _, tc, _ = engine(4).round_chunked(tups, chunk_clients=50)
    want = np.asarray(jo.alpha_num).dtype
    assert want == (np.uint8 if n <= 128 else np.int32)
    assert to.alpha_num.numpy().dtype == want
    assert tc.alpha_num.numpy().dtype == want
    np.testing.assert_array_equal(to.alpha_num.numpy(),
                                  np.asarray(jo.alpha_num))
    assert_same(to.alpha_num, tc.alpha_num, f"n={n}")


def test_round_legacy_matches_jax():
    """A round of 6 clients over 3 tasks (JAX's per-task loop compiles
    once for each member count)."""
    jups, tups = make_uploads(3, 6, 3, 300, 2)
    jserver = JServer(JServerConfig(n_tasks=3))
    jd = jserver.round_legacy(jups)
    tserver = MaTUServer(MaTUServerConfig(n_tasks=3), device="cpu")
    td = tserver.round_legacy(tups)
    np.testing.assert_allclose(tserver.last_task_vectors.numpy(),
                               np.asarray(jserver.last_task_vectors),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tserver.last_similarity.numpy(),
                               np.asarray(jserver.last_similarity),
                               rtol=RTOL, atol=ATOL)
    assert td.keys() == jd.keys()
    for cid, jdl in jd.items():
        assert np.array_equal(td[cid].masks.numpy(), np.asarray(jdl.masks))
        np.testing.assert_allclose(td[cid].unified.numpy(),
                                   np.asarray(jdl.unified), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(td[cid].lams.numpy(),
                                   np.asarray(jdl.lams), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_chunked_matches_round_legacy(ragged, packed):
    """The chunked round (``MaTUServer.round_chunked`` on the wire,
    the engine's bool layout) against the per-task oracle, which shares
    none of its code: task vectors, S and λ to fp32 tolerance, downlink
    mask bits ≥ 99.999 % equal, bf16 downlinks within one ulp of the
    oracle's fp32 vectors rounded."""
    _, ups = ragged
    server = MaTUServer(MaTUServerConfig(n_tasks=T), device="cpu")
    legacy = server.round_legacy(ups)
    tv_l, sim_l = server.last_task_vectors, server.last_similarity
    if packed:
        downs, _ = server.round_chunked(ups, chunk_clients=4)
        tv, sim = server.last_task_vectors, server.last_similarity
    else:
        downs, out, _ = server.engine.round_chunked(ups, chunk_clients=4,
                                                    packed=False)
        tv, sim = out.task_vectors, out.similarity
    np.testing.assert_allclose(tv.numpy(), tv_l.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(sim.numpy(), sim_l.numpy(), rtol=RTOL,
                               atol=ATOL)
    for cid, ldl in legacy.items():
        dl = downs[cid]
        assert (dl.masks_dense() == ldl.masks).float().mean() >= 0.99999
        if packed:
            ulp = (dl.unified.view(torch.int16).int()
                   - ldl.unified.to(torch.bfloat16).view(torch.int16).int())
            assert ulp.abs().max() <= 1
        else:
            np.testing.assert_allclose(dl.unified.numpy(),
                                       ldl.unified.numpy(), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(dl.lams.numpy(), ldl.lams.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_chunked_factory_and_sink():
    """A factory is read exactly twice; the sink's chunks are disjoint,
    their union is the monolithic downlinks, the returned dict is
    empty."""
    _, ups = make_uploads(11, 10, 4, 512, 2)
    eng = engine(4)
    downs_m, out_m = eng.round(ups)
    calls = []

    def factory():
        calls.append(1)
        return iter(ups)

    chunks = []
    downs_c, out_c, stats = eng.round_chunked(factory, chunk_clients=4,
                                              sink=chunks.append)
    assert len(calls) == 2 and downs_c == {}
    assert len(chunks) == stats["n_chunks"] == 3
    union = {}
    for links in chunks:
        assert not set(links) & set(union)
        union.update(links)
    assert_outputs_same(out_m, out_c, "sink")
    assert_downlinks_same(downs_m, union, "sink")


@pytest.mark.parametrize("case", ["chunk0", "empty", "k_max", "unstable"])
def test_chunked_rejects_bad_streams(case):
    _, ups = make_uploads(0, 6, 4, 256, 2)
    eng = engine(4)
    flips = []

    def unstable():
        flips.append(1)
        return iter(ups if len(flips) == 1 else ups[::-1])

    arg, kw, match = {
        "chunk0": (ups, dict(chunk_clients=0), "chunk_clients"),
        "empty": ([], dict(chunk_clients=4), "empty round"),
        "k_max": (ups, dict(chunk_clients=4, k_max=1), "k_max"),
        "unstable": (unstable, dict(chunk_clients=4), "different round"),
    }[case]
    if case == "k_max":
        assert max(len(u.task_ids) for u in ups) == 2
    with pytest.raises(ValueError, match=match):
        eng.round_chunked(arg, **kw)


@pytest.mark.parametrize("variant", ["plain", "pipeline", "coded"])
def test_strategy_chunked_bitwise_batched(variant):
    """``MaTUStrategy(chunk_clients=3)`` against the batched strategy over
    two rounds (the second from the downlinks): every task's vector, the
    downlinks, the uplink and downlink bits, bitwise."""
    from repro_torch.fed.strategies import MaTUStrategy, RoundBatch, Upload
    rng = np.random.default_rng(13)
    n, n_tasks, d = 7, 5, 384
    clients = []
    for cid in range(n):
        k = int(rng.integers(1, 3))
        clients.append((cid, sorted(rng.choice(n_tasks, size=k,
                                               replace=False).tolist()),
                        rng.integers(10, 100, size=k).tolist()))
    kw = dict(pipeline=variant == "pipeline", code_masks=variant == "coded",
              device="cpu")
    mono = MaTUStrategy(n_tasks, d, **kw)
    chun = MaTUStrategy(n_tasks, d, chunk_clients=3, **kw)
    for _ in range(2):
        noise = torch.from_numpy(rng.standard_normal((n, 2, d)).astype(
            np.float32))
        ups = {}
        for name, s in (("mono", mono), ("chun", chun)):
            ups[name] = [Upload(c, ts, torch.stack(
                [s.task_init(c, t) for t in ts]) + noise[i, :len(ts)], sz)
                for i, (c, ts, sz) in enumerate(clients)]
            s.aggregate_batch(RoundBatch.from_uploads(ups[name], n_tasks))
        for t in range(n_tasks):
            assert_same(mono.eval_vectors(t)[0], chun.eval_vectors(t)[0],
                        f"task {t}")
        assert mono.uplink_bits(ups["mono"]) == chun.uplink_bits(ups["chun"])
        assert mono.downlink_bits() == chun.downlink_bits()
        assert_downlinks_same(mono.downlinks, chun.downlinks, variant)
    assert chun._pending is None


POP_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_population_simulator_matches_jax(dropout):
    """PopulationSplit(64 clients, 4 tasks, 2 a client), d 256, 8 clients a
    round in chunks of 4, 6 rounds: JAX's evaluation rounds, fault
    counters and wire bits exactly, its alignment and task vectors to
    rtol 1e-5; two port runs bitwise."""
    from repro.data.dirichlet import PopulationSplit as JSplit
    from repro.fed.simulator import FedConfig as JFedConfig
    from repro.fed.simulator import PopulationSimulator as JPopSim
    from repro_torch.data.dirichlet import PopulationSplit
    from repro_torch.fed.simulator import FedConfig, PopulationSimulator
    kw = dict(d=256, clients_per_round=8, chunk_clients=4,
              dropout_prob=dropout)
    jsim = JPopSim(JFedConfig(rounds=6, seed=0),
                   JSplit(n_clients=64, n_tasks=4, tasks_per_client=2,
                          seed=0), **kw)
    jh = jsim.run()

    def run():
        sim = PopulationSimulator(
            FedConfig(rounds=6, seed=0),
            PopulationSplit(n_clients=64, n_tasks=4, tasks_per_client=2,
                            seed=0), device="cpu", **kw)
        return sim, sim.run()

    (s1, h1), (s2, h2) = run(), run()
    assert h1.rounds == jh.rounds == [5, 6]
    assert h1.fault_counts == jh.fault_counts
    if dropout:
        assert sum(fc["dropped"] for fc in h1.fault_counts) > 0
    assert h1.uplink_bits_per_round == jh.uplink_bits_per_round
    assert h1.downlink_bits_per_round == jh.downlink_bits_per_round
    for ta, tb in zip(h1.task_acc, jh.task_acc):
        assert ta.keys() == tb.keys()
        np.testing.assert_allclose([ta[t] for t in ta], [tb[t] for t in ta],
                                   **POP_TOL)
    np.testing.assert_allclose(h1.mean_acc, jh.mean_acc, **POP_TOL)
    np.testing.assert_allclose(s1._tv_host, np.asarray(jsim._tv_host),
                               **POP_TOL)
    assert h1.mean_acc[-1] > 0.55
    assert h1.mean_acc == h2.mean_acc
    assert np.array_equal(s1._tv_host.view(np.int32),
                          s2._tv_host.view(np.int32))
    assert len(h1.phase_us) == 6
    assert all({"derive", "round", "pack"} <= set(ph) for ph in h1.phase_us)
