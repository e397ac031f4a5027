"""Async MaTU rounds in the port against the JAX package, on the CPU:
the staleness-weighted round (``ops.matu_round_slots(_packed)`` with
``slot_weights``, ``RoundEngine.round(staleness=)``),
``AsyncMaTUStrategy.aggregate_admitted`` over scripted ticks (staleness,
a corrupting trace, an all-quarantined tick, a dark task, a skipped
tick), and the simulator's event-clock fault counters for one trace;
then the port's own laws: an ideal trace ≡ sync and the deferred drain ≡
no drain, bit for bit, on the raw and the coded wire; corruption without
the coded wire raises; skip-and-carry; phases one behind under the
pipeline; a fault for one client moves no other client's upload.

Bars: the engine's (``tests/test_torch_engine.py``): alpha_num, n_held,
quarantine sets, task ages and wire bits exact; vectors, similarity and
λ to rtol 1e-5, atol 1e-6; downlink bits ≥ 99.999 % equal and bf16
within one ulp.  Weights of ones are bitwise ``None``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_constellation as j_make_constellation)
from repro.fed import simulator as jsim  # noqa: E402
from repro.fed import strategies as jstr  # noqa: E402
from repro.fed import systems as jsys  # noqa: E402
from repro.fed.compression import decode_mask_rows  # noqa: E402
from repro.fed.testbed import MLPBackbone as JMLP  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data.dirichlet import dirichlet_split  # noqa: E402
from repro_torch.data.synthetic import make_constellation  # noqa: E402
from repro_torch.fed import strategies as tstr  # noqa: E402
from repro_torch.fed.simulator import FedConfig, FedSimulator  # noqa: E402
from repro_torch.fed.systems import ClientSystems, FaultModel  # noqa: E402
from repro_torch.fed.testbed import MLPBackbone  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from test_torch_bool_round import (assert_bool_round_close,  # noqa: E402
                                   jax_bool_round, port_round_from,
                                   ragged_uploads)
from test_torch_engine import (assert_round_close, jax_packed,  # noqa: E402
                               make_round, port_packed_from)

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6
N_TASKS, N_CLIENTS = 5, 5
OUT_FIELDS = ("task_vectors", "tau_hats", "similarity", "down_unified",
              "down_masks", "down_lams", "alpha_num", "n_held",
              "m_hats_dense")


def staleness_weights(n, k, stale):
    w = np.ones((n, k), np.float32)
    w[:] = (np.float32(0.5) ** np.asarray(stale, np.float32))[:, None]
    return w


def assert_outputs_equal(a, b):
    for name in OUT_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# the weighted round
# ---------------------------------------------------------------------------

WEIGHTED_ROUNDS = [
    # seed, n, k, t, d, unheld
    (0, 6, 4, 7, 1000, 1),
    (3, 3, 2, 3, 33, 1),
]


@pytest.mark.parametrize("layout", ["packed", "bool"])
@pytest.mark.parametrize("mode", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("seed,n,k,t_,d,unheld", WEIGHTED_ROUNDS)
def test_slot_weighted_round_matches_jax(layout, mode, seed, n, k, t_, d,
                                         unheld):
    """Slots weighted 0.5**s (s = 0, 1, 2 by client) through the port's
    round against JAX's ``run_packed`` with the same weights; weights of
    ones give the unweighted round bitwise, and the weights bite."""
    tv, valid, tasks, sizes, cids, tids = make_round(seed, n, k, t_, d,
                                                     unheld)
    w = staleness_weights(n, k, [i % 3 for i in range(n)])
    if layout == "packed":
        jp = jax_packed(tv, valid, tasks, sizes, cids, tids, t_, d)
        tp = port_packed_from(jp, d)
    else:
        jp = jax_bool_round(tv, valid, tasks, sizes, cids, tids, t_, d)
        tp = port_round_from(jp, d)
    jp.slot_weights = jnp.asarray(w)
    jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t_)).run_packed(
        jp, mode=mode)
    eng = teng.RoundEngine(teng.EngineConfig(n_tasks=t_), device="cpu")
    plain = eng.run_packed(tp)
    tp.slot_weights = torch.from_numpy(w)
    to = eng.run_packed(tp)
    if layout == "packed":
        assert_round_close(jo, to, d, valid)
    else:
        assert_bool_round_close(jo, to, valid)
    assert not torch.equal(to.task_vectors, plain.task_vectors)
    tp.slot_weights = torch.ones((n, k))
    assert_outputs_equal(eng.run_packed(tp), plain)


def test_round_with_staleness_matches_jax():
    """``RoundEngine.round(staleness=)`` on ragged uploads (bool masks
    and packed words mixed) against JAX's: the weights padded with ones
    to the slot grid; all-zero staleness is bitwise no staleness."""
    t_, d = 5, 300
    jups, tups = ragged_uploads(11, 8, t_, d, packed_every=2)
    stale = [0, 1, 2, 0, 3, 1, 0, 2]
    jd, jo = jeng.RoundEngine(jeng.EngineConfig(n_tasks=t_)).round(
        jups, staleness=stale)
    eng = teng.RoundEngine(teng.EngineConfig(n_tasks=t_), device="cpu")
    td, to = eng.round(tups, staleness=stale)
    batch = teng.pack_uploads(tups, t_, device="cpu")
    valid = batch.slot_valid.numpy()
    assert_round_close(jo, to, d, valid)
    for cid, jdl in jd.items():
        assert td[cid].downlink_bits() == jdl.downlink_bits()
    _, zero = eng.round(tups, staleness=[0] * 8)
    assert_outputs_equal(zero, eng.round(tups)[1])


# ---------------------------------------------------------------------------
# AsyncMaTUStrategy.aggregate_admitted over scripted ticks
# ---------------------------------------------------------------------------

D = 300
# (client, tasks, sizes) of the scripted ticks; task 4 is never held
CLIENTS = [(0, [0, 1], [40, 60]), (1, [1, 2], [50, 30]),
           (2, [0, 3], [70, 20]), (3, [2, 3], [25, 45])]
# corrupt draws at this seed for the tick's (client, dispatch) pairs:
# clients 0 and 3 are tampered, 1 and 2 are not
CORRUPT_SEED = 6


def _ticks():
    """(clients, staleness, dispatch rounds, FaultModel or None) a tick;
    None in place of a tick is a skipped round."""
    return [
        (CLIENTS, [0, 1, 2, 0], None, None),
        (CLIENTS, [0, 0, 1, 0], [1, 1, 0, 1],
         dict(corrupt_prob=0.5, seed=CORRUPT_SEED)),
        (CLIENTS[:2], [0, 1], [2, 1], dict(corrupt_prob=1.0, seed=1)),
        None,
        (CLIENTS[:1], [1], None, None),     # tasks 2 and 3 go dark
    ]


def _assert_downlink_close(tdl, jdl, d, k):
    assert tdl.downlink_bits() == jdl.downlink_bits()
    jw = (decode_mask_rows(np.asarray(jdl.masks), d, k) if jdl.coded
          else np.asarray(jdl.masks))
    tw = bitpack.words_to_numpy(tdl.mask_row(slice(0, k)))
    agree = bitpack.unpack_bits_np(tw, d) == bitpack.unpack_bits_np(jw, d)
    assert agree.mean() >= 0.99999
    ulp = np.abs(tdl.unified.view(torch.int16).numpy().astype(np.int32)
                 - np.asarray(jdl.unified).view(np.int16).astype(np.int32))
    assert ulp.max() <= 1
    np.testing.assert_allclose(tdl.lams.numpy(), np.asarray(jdl.lams),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("code_masks", [False, True])
def test_aggregate_admitted_scripted_ticks_match_jax(code_masks):
    js = jstr.AsyncMaTUStrategy(N_TASKS, D, code_masks=code_masks)
    ts = tstr.AsyncMaTUStrategy(N_TASKS, D, code_masks=code_masks,
                                device="cpu")
    rng = np.random.default_rng(23)
    quarantined = []
    for r, tick in enumerate(_ticks()):
        if tick is None:
            js.skip_round()
            ts.skip_round()
            assert ts.uplink_bits([]) == js.uplink_bits([]) == 0
            assert ts.downlink_bits() == js.downlink_bits() == 0
        else:
            clients, stale, dispatch, faults = tick
            if faults is not None and not code_masks:
                continue     # corruption needs the coded wire (tested below)
            j_ups, t_ups = [], []
            for c, tasks, sizes in clients:
                base = np.stack([np.asarray(js.task_init(c, t), np.float32)
                                 for t in tasks])
                for i, t in enumerate(tasks):
                    np.testing.assert_allclose(ts.task_init(c, t).numpy(),
                                               base[i], rtol=RTOL, atol=ATOL)
                tv = (base + 0.1 * rng.standard_normal(base.shape)).astype(
                    np.float32)
                j_ups.append(jstr.Upload(c, tasks, jnp.asarray(tv), sizes))
                t_ups.append(tstr.Upload(c, tasks, torch.from_numpy(tv),
                                         sizes))
            j_sys = t_sys = None
            if faults is not None:
                j_sys = jsys.ClientSystems(4, jsys.FaultModel(**faults))
                t_sys = ClientSystems(4, FaultModel(**faults))
            n_j = js.aggregate_admitted(
                jstr.RoundBatch.from_uploads(j_ups, N_TASKS), stale, j_sys,
                dispatch)
            n_t = ts.aggregate_admitted(
                tstr.RoundBatch.from_uploads(t_ups, N_TASKS), stale, t_sys,
                dispatch)
            assert n_t == n_j
            assert ts.uplink_bits(t_ups) == js.uplink_bits(j_ups)
            assert ts.downlink_bits() == js.downlink_bits()
            for u in ts._last_uploads:
                if u.client_id in ts.last_quarantined:
                    continue
                k = len(u.task_ids)
                _assert_downlink_close(ts.downlinks[u.client_id],
                                       js.downlinks[u.client_id], D, k)
        assert ts.last_quarantined == js.last_quarantined
        quarantined.append(set(ts.last_quarantined))
        np.testing.assert_array_equal(ts.task_age, js.task_age)
        for t in range(N_TASKS):
            np.testing.assert_allclose(ts.eval_vectors(t)[0].numpy(),
                                       np.asarray(js.eval_vectors(t)[0]),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ts.similarity, js.similarity, rtol=RTOL,
                                   atol=ATOL)
    # never-held task 4 stays zero; dark tasks 2, 3 aged through the
    # skip (and, coded, the all-quarantined tick)
    assert not ts.eval_vectors(4)[0].any()
    if code_masks:
        assert quarantined[1:3] == [{0, 3}, {0, 1}]
        assert list(ts.task_age) == [0, 0, 3, 3, 5]
    else:
        assert list(ts.task_age) == [0, 0, 2, 2, 3]


def test_corruption_without_the_coded_wire_raises():
    ts = tstr.AsyncMaTUStrategy(N_TASKS, D, device="cpu")
    ups = [tstr.Upload(0, [0], torch.ones((1, D)), [4])]
    with pytest.raises(ValueError, match="code_masks"):
        ts.aggregate_admitted(tstr.RoundBatch.from_uploads(ups, N_TASKS), [0],
                              ClientSystems(1, FaultModel(corrupt_prob=1.0)),
                              [0])


# ---------------------------------------------------------------------------
# the simulator's event clock
# ---------------------------------------------------------------------------

def _setting():
    con = make_constellation(n_tasks=N_TASKS, n_groups=2, feat_dim=16,
                             n_classes=4, seed=0)
    split = dirichlet_split(n_clients=N_CLIENTS, n_tasks=N_TASKS,
                            n_classes=4, zeta_t=0.5, tasks_per_client=2,
                            seed=0)
    return con, split, MLPBackbone(16, hidden=24, lora_rank=4)


def _cfg(**kw):
    base = dict(rounds=4, participation=1.0, local_steps=2, batch_size=16,
                local_data=64, eval_every=2)
    base.update(kw)
    return FedConfig(**base)


# a trace that drops, crashes, straggles, goes stale (client 1's base
# delay 2 against max_staleness 1), corrupts, admits staleness 1 and
# skips a tick (every client is forced to drop at tick 2)
TRACE = dict(faults=dict(dropout=0.25, straggler_frac=0.25,
                         straggler_delay=1, crash_prob=0.1, crash_rounds=2,
                         corrupt_prob=0.25, seed=3),
             base_delay=[0, 2, 0, 0, 0],
             forced_dropouts={(c, 2) for c in range(N_CLIENTS)})


def test_fault_counts_match_jax():
    """One fault trace through the port's simulator and JAX's at ξ = 1:
    ``History.fault_counts`` equal row for row (every counter is a
    function of the trace alone)."""
    con, split, bb = _setting()
    kw = dict(rounds=5, local_steps=1, max_staleness=1, eval_every=5)
    th = FedSimulator(
        _cfg(**kw), con, split, bb,
        tstr.AsyncMaTUStrategy(N_TASKS, bb.d, code_masks=True, device="cpu"),
        systems=ClientSystems(N_CLIENTS, FaultModel(**TRACE["faults"]),
                              TRACE["base_delay"], TRACE["forced_dropouts"]),
        device="cpu").run()
    jbb = JMLP(16, hidden=24, lora_rank=4)
    jcon = j_make_constellation(n_tasks=N_TASKS, n_groups=2, feat_dim=16,
                                n_classes=4, seed=0)
    jh = jsim.FedSimulator(
        jsim.FedConfig(**dict(dict(participation=1.0, batch_size=16,
                                   local_data=64), **kw)),
        jcon, split, jbb,
        jstr.AsyncMaTUStrategy(N_TASKS, jbb.d, code_masks=True),
        systems=jsys.ClientSystems(N_CLIENTS,
                                   jsys.FaultModel(**TRACE["faults"]),
                                   TRACE["base_delay"],
                                   TRACE["forced_dropouts"])).run()
    assert th.fault_counts == jh.fault_counts
    tot = th.total_fault_counts
    for key in ("dropped", "crashed", "stragglers", "stale", "quarantined",
                "skipped"):
        assert tot[key] >= 1, (key, tot)
    assert th.uplink_bits_per_round[-1] > 0


def _last_wire(strat):
    ups = {u.client_id: (u.unified, u.masks, u.lams)
           for u in strat._last_uploads}
    downs = {c: (dl.unified, dl.masks, dl.lams)
             for c, dl in strat.downlinks.items()}
    return ups, downs


def _assert_wire_equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for c in x:
            for p, q in zip(x[c], y[c]):
                assert p.dtype == q.dtype and torch.equal(p, q), c


@pytest.mark.parametrize("code_masks", [False, True])
def test_ideal_async_and_pipeline_equal_sync_bitwise(code_masks):
    """Sync S, the deferred drain P and async A under the ideal trace:
    accuracies, measured bits, the task vectors, every client's last
    upload and every downlink bit for bit; A's counters clean."""
    con, split, bb = _setting()
    runs = {}
    for name, cls, pipeline, systems in (
            ("S", tstr.MaTUStrategy, False, None),
            ("P", tstr.MaTUStrategy, True, None),
            ("A", tstr.AsyncMaTUStrategy, True,
             ClientSystems.ideal(N_CLIENTS))):
        strat = cls(N_TASKS, bb.d, code_masks=code_masks, device="cpu")
        hist = FedSimulator(_cfg(pipeline=pipeline), con, split, bb, strat,
                            systems=systems, device="cpu").run()
        strat._drain()
        runs[name] = (hist, strat)
    hs, ss = runs["S"]
    for name in ("P", "A"):
        h, s = runs[name]
        assert h.task_acc == hs.task_acc
        assert h.uplink_bits_per_round == hs.uplink_bits_per_round
        assert h.downlink_bits_per_round == hs.downlink_bits_per_round
        assert torch.equal(s.server.last_task_vectors,
                           ss.server.last_task_vectors)
        _assert_wire_equal(_last_wire(s), _last_wire(ss))
    for row in runs["A"][0].fault_counts:
        assert row["sampled"] == row["admitted"] == N_CLIENTS
        assert row["dropped"] == row["stale"] == row["quarantined"] == 0


def test_sync_skip_round_carries():
    strat = tstr.MaTUStrategy(N_TASKS, D, device="cpu")
    strat.aggregate([tstr.Upload(0, [0, 1], torch.ones((2, D)), [4, 4])])
    before = strat.server.last_task_vectors.clone()
    down = strat.task_init(0, 1).clone()
    assert strat.uplink_bits([]) > 0
    strat.skip_round()
    assert torch.equal(strat.server.last_task_vectors, before)
    assert torch.equal(strat.task_init(0, 1), down)
    assert strat.uplink_bits([]) == 0 and strat.downlink_bits() == 0
    assert strat.last_phase_us == {}


def test_mean_phase_us_one_behind_under_pipeline():
    con, split, bb = _setting()
    for cls, systems in ((tstr.MaTUStrategy, None),
                         (tstr.AsyncMaTUStrategy,
                          ClientSystems.ideal(N_CLIENTS))):
        strat = cls(N_TASKS, bb.d, device="cpu")
        hist = FedSimulator(_cfg(rounds=3, pipeline=True), con, split, bb,
                            strat, systems=systems, device="cpu").run()
        assert hist.phase_us[0] == {}
        assert all({"pack", "device"} <= set(ph) for ph in hist.phase_us[1:])
        assert set(hist.mean_phase_us) >= {"pack", "device"}
        assert all(v > 0 for v in hist.mean_phase_us.values())
        # sync mode still records a counter row every round
        assert len(hist.fault_counts) == 3


def test_forced_dropout_moves_no_other_clients_upload():
    """Dropping client 0 in round 0 leaves every other client's round-0
    trained upload bit for bit as it was (each draw keyed by its own
    (client, round, task))."""
    con, split, bb = _setting()
    seen = {}
    for tag, forced in (("ideal", None), ("drop", {(0, 0)})):
        strat = tstr.AsyncMaTUStrategy(N_TASKS, bb.d, device="cpu")
        agg = strat.aggregate_admitted

        def spy(batch, *a, tag=tag, agg=agg):
            seen.setdefault(tag, {u.client_id: u.task_vectors.clone()
                                  for u in batch.uploads})
            return agg(batch, *a)

        strat.aggregate_admitted = spy
        FedSimulator(_cfg(rounds=1), con, split, bb, strat,
                     systems=ClientSystems(N_CLIENTS,
                                           forced_dropouts=forced),
                     device="cpu").run()
    assert set(seen["ideal"]) - set(seen["drop"]) == {0}
    for c, v in seen["drop"].items():
        assert torch.equal(v, seen["ideal"][c]), c
