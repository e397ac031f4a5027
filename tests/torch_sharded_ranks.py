"""The ranks of ``tests/test_torch_sharded_engine.py``: the port's
taskvec-sharded round on 8 gloo CPU ranks.

    python tests/torch_sharded_ranks.py WORKDIR

reads the uploads ``WORKDIR/uploads.pkl`` (written by the test, numpy
only), spawns 8 ranks that rendezvous through a file store in WORKDIR,
and has each rank write ``WORKDIR/report_<rank>.pkl``: for every check a
bool (sharded ≡ unsharded bit for bit, collective counts exact, …) and,
from rank 0, the sharded rounds' whole outputs as numpy for the test to
hold against the JAX package.  A rank that raises makes the script exit
nonzero (``torch.multiprocessing.spawn`` re-raises it).  Nothing here
imports JAX.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
CASES = [(5, 6, 1000, 3), (3, 4, 300, 2), (4, 5, 4096, 2)]
CHUNKS = (1, 3, 8)
# the collectives a rank could call; wrapped to count them
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "broadcast",
               "broadcast_object_list", "reduce", "gather", "scatter",
               "barrier", "send", "recv", "isend", "irecv")


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}.get(x.dtype, x.dtype))


def same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(bits(a.contiguous()), bits(b.contiguous())))


OUT_FIELDS = ("task_vectors", "tau_hats", "similarity", "alpha_num",
              "n_held", "m_hats_dense", "down_unified", "down_masks",
              "down_lams")


def same_out(a, b, fields=OUT_FIELDS) -> bool:
    return all(same(getattr(a, f), getattr(b, f)) for f in fields)


def same_links(a, b) -> bool:
    return a.keys() == b.keys() and all(
        same(getattr(a[c], f), getattr(b[c], f))
        for c in a for f in ("unified", "masks", "lams")) and all(
        a[c].downlink_bits() == b[c].downlink_bits() for c in a)


def to_uploads(rows):
    from repro_torch.core.client import ClientUpload
    return [ClientUpload(r["cid"], list(r["tasks"]),
                         torch.from_numpy(r["unified"]),
                         torch.from_numpy(r["masks"]),
                         torch.from_numpy(r["lams"]), list(r["sizes"]))
            for r in rows]


def numpy_out(out):
    return {f: (None if getattr(out, f) is None else
                getattr(out, f).float().numpy() if getattr(out, f).dtype
                == torch.bfloat16 else getattr(out, f).numpy())
            for f in OUT_FIELDS}


class Counted:
    """Counts the calls of every torch.distributed collective while
    active, and records each all_reduce's tensor (dtype, shape)."""

    def __init__(self):
        self.calls = {}
        self.reduced = []
        self._saved = {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def wrap(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                if _name == "all_reduce":
                    t = a[0] if a else kw["tensor"]
                    self.reduced.append((str(t.dtype), tuple(t.shape)))
                return _fn(*a, **kw)

            setattr(dist, name, wrap)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False


def run_checks(rank: int, work: str) -> dict:
    from repro_torch.core.engine import (EngineConfig, RoundEngine,
                                         batched_client_unify, gather_cols,
                                         pack_uploads, pad_d_for_shards)
    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_population_mesh,
                                         make_round_mesh)
    from repro_torch.nn import sharding

    with open(os.path.join(work, "uploads.pkl"), "rb") as f:
        data = pickle.load(f)
    meshes = {"debug4x2": make_debug_mesh((4, 2), device_type="cpu"),
              "pop_s2": make_population_mesh(slots=2, device_type="cpu"),
              "round8": make_round_mesh(8, device_type="cpu")}
    rep: dict = {"checks": {}, "outputs": {}, "counts": {}}
    chk = rep["checks"]
    refused = []
    for bad in (lambda: make_round_mesh(WORLD + 1, device_type="cpu"),
                lambda: make_population_mesh(3, device_type="cpu"),
                lambda: make_population_mesh(0, device_type="cpu"),
                lambda: make_debug_mesh((4, 4), device_type="cpu")):
        try:
            bad()
            refused.append(False)
        except ValueError:
            refused.append(True)
    chk["mesh/refusals"] = all(refused)

    # -- monolithic rounds: 3 cases x 2 layouts x 3 meshes -----------------
    for ci, (n, t, d, _) in enumerate(CASES):
        ups = to_uploads(data["cases"][ci])
        single = RoundEngine(EngineConfig(n_tasks=t), device="cpu")
        for packed in (True, False):
            lay = "packed" if packed else "bool"
            downs_s, out_s = single.round(ups, packed=packed)
            for mname, mesh in meshes.items():
                shard = RoundEngine(EngineConfig(n_tasks=t), device="cpu",
                                    mesh=mesh)
                downs_h, out_h = shard.round(ups, packed=packed)
                chk[f"round/{mname}/{ci}/{lay}"] = bool(
                    same_out(out_s, out_h) and same_links(downs_s, downs_h))
                if mname == "debug4x2":
                    rep["outputs"][f"{ci}/{lay}"] = numpy_out(out_h)

    # -- collectives of run_packed and of client unify ---------------------
    n, t, d, _ = CASES[0]
    ups = to_uploads(data["cases"][0])
    mesh = meshes["debug4x2"]
    eng = RoundEngine(EngineConfig(n_tasks=t), device="cpu", mesh=mesh)
    for packed in (True, False):
        batch = pack_uploads(ups, t, packed=packed, device="cpu", mesh=mesh)
        sharding.reset_collective_counts()
        with Counted() as c:
            out = eng.run_packed(batch)
        rep["counts"][f"run_packed/{'packed' if packed else 'bool'}"] = dict(
            calls=c.calls, reduced=c.reduced,
            psum=sharding.collective_counts(), d_pad=out.d_pad,
            width=int(out.task_vectors.shape[-1]),
            want_d_pad=pad_d_for_shards(d, 8))
    rng = np.random.default_rng(3)
    tv = torch.from_numpy(rng.standard_normal((6, 3, d)).astype(np.float32))
    valid = torch.from_numpy(rng.random((6, 3)) < 0.7)
    valid[:, 0] = True
    tv = tv * valid[:, :, None]
    for packed in (True, False):
        lay = "packed" if packed else "bool"
        plain = batched_client_unify(tv, valid, packed=packed, device="cpu")
        sharding.reset_collective_counts()
        with Counted() as c:
            uni, masks, lams = batched_client_unify(
                tv, valid, packed=packed, device="cpu", mesh=mesh)
        rep["counts"][f"client_unify/{lay}"] = dict(
            calls=c.calls, psum=sharding.collective_counts())
        whole = (gather_cols(uni, eng.layout, d),
                 gather_cols(masks, eng.layout, d, words=packed))
        chk[f"client_unify/{lay}/bitwise"] = bool(
            same(whole[0], plain[0]) and same(whole[1], plain[1])
            and same(lams, plain[2]))
        chk[f"client_unify/{lay}/lams_close"] = bool(torch.allclose(
            lams, plain[2], rtol=1e-4, atol=1e-5))

    # -- chunked rounds: 2 meshes x 2 layouts x chunks 1 / 3 / 8 (on the
    # first case's 5 clients: 3 a non-divisor, 8 more than N) -----------
    n, t, d, _ = CASES[0]
    ups = to_uploads(data["cases"][0])
    single = RoundEngine(EngineConfig(n_tasks=t), device="cpu")
    for packed in (True, False):
        lay = "packed" if packed else "bool"
        downs_m, out_m = single.round(ups, packed=packed)
        for mname in ("debug4x2", "pop_s2"):
            shard = RoundEngine(EngineConfig(n_tasks=t), device="cpu",
                                mesh=meshes[mname])
            for chunk in CHUNKS:
                seen = {}
                sharding.reset_collective_counts()
                with Counted() as c:
                    downs_c, out_c, stats = shard.round_chunked(
                        ups, chunk_clients=chunk, packed=packed,
                        sink=seen.update)
                counts = sharding.collective_counts()
                chk[f"chunked/{mname}/{lay}/{chunk}"] = bool(
                    same_out(out_m, out_c, OUT_FIELDS[:6])
                    and same_links(downs_m, seen) and not downs_c
                    and stats["downlink_bits"] == sum(
                        x.downlink_bits() for x in downs_m.values()))
                rep["counts"][f"chunked/{mname}/{lay}/{chunk}"] = dict(
                    psum=counts["psum"], n_chunks=stats["n_chunks"],
                    all_reduce=c.calls.get("all_reduce", 0))
    shard = RoundEngine(EngineConfig(n_tasks=t), device="cpu",
                        mesh=meshes["pop_s2"])
    downs_m, _ = single.round(ups, code_masks=True)
    downs_c, _, _ = shard.round_chunked(ups, chunk_clients=3,
                                        code_masks=True)
    chk["chunked/pop_s2/coded"] = bool(same_links(downs_m, downs_c))

    # -- round_stream on the debug mesh ------------------------------------
    ups0 = to_uploads(data["cases"][0])
    t0 = CASES[0][1]
    shard = RoundEngine(EngineConfig(n_tasks=t0), device="cpu", mesh=mesh)
    single = RoundEngine(EngineConfig(n_tasks=t0), device="cpu")
    ref = single.round(ups0, code_masks=True)
    ok = True
    for pipeline in (True, False):
        for downs, out, _ in shard.round_stream([ups0, ups0],
                                                code_masks=True,
                                                pipeline=pipeline):
            ok = ok and same_out(ref[1], out) and same_links(ref[0], downs)
    chk["round_stream/debug4x2"] = bool(ok)

    run_strategies(rep, meshes)
    return rep


def strategy_uploads(seed, n_clients, n_tasks, d):
    from repro_torch.fed.strategies import Upload
    rng = np.random.default_rng(seed)
    out = []
    for cid in range(n_clients):
        k = int(rng.integers(1, 4))
        tasks = sorted(rng.choice(n_tasks, size=k, replace=False).tolist())
        tvs = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
        out.append(Upload(cid, tasks, tvs,
                          rng.integers(10, 99, size=k).tolist()))
    return out


def wire(strat):
    ups = {u.client_id: (u.unified, u.masks, u.lams)
           for u in strat._last_uploads}
    downs = {c: (dl.unified, dl.masks, dl.lams)
             for c, dl in strat.downlinks.items()}
    return ups, downs


def same_wire(a, b) -> bool:
    """Every upload and downlink of ``a`` bitwise ``b``'s; where ``b``'s
    is a meta tensor (a sharded uplink record whose content no
    accounting reads), its dtype and shape."""
    def eq(p, q):
        if q.is_meta:
            return p.dtype == q.dtype and p.shape == q.shape
        return same(p, q)
    return all(x.keys() == y.keys() and all(
        eq(p, q) for c in x for p, q in zip(x[c], y[c]))
        for x, y in zip(a, b))


def run_strategies(rep: dict, meshes: dict) -> None:
    from repro_torch.data.dirichlet import PopulationSplit, dirichlet_split
    from repro_torch.data.synthetic import make_constellation
    from repro_torch.fed.simulator import (FedConfig, FedSimulator,
                                           PopulationSimulator)
    from repro_torch.fed.strategies import (AsyncMaTUStrategy, MaTUStrategy,
                                            RoundBatch)
    from repro_torch.fed.testbed import MLPBackbone
    from repro_torch.nn import sharding
    chk = rep["checks"]
    mesh = meshes["debug4x2"]

    # strategy level: the sharded batched path against the unsharded one
    n_tasks, d = 5, 1000
    uploads = strategy_uploads(7, 6, n_tasks, d)
    for name, kw, mname in (("plain", {}, "debug4x2"),
                            ("coded", {"code_masks": True}, "debug4x2"),
                            ("chunked", {"chunk_clients": 4}, "pop_s2"),
                            ("pipelined", {"pipeline": True}, "debug4x2")):
        plain = MaTUStrategy(n_tasks, d, device="cpu", **kw)
        plain.aggregate_batch(RoundBatch.from_uploads(uploads, n_tasks))
        plain._drain()
        shard = MaTUStrategy(n_tasks, d, device="cpu", mesh=meshes[mname],
                             **kw)
        sharding.reset_collective_counts()
        shard.aggregate_batch(RoundBatch.from_uploads(uploads, n_tasks))
        at_dispatch = sharding.collective_counts()["gather"]
        shard._drain()
        # a raw round gathers the downlink vectors and words and the task
        # vectors, all at the drain; a coded one its uplink words too
        rep["counts"][f"strategy/{name}"] = dict(
            at_dispatch=at_dispatch,
            gathers=sharding.collective_counts()["gather"])
        a = plain.server.last_task_vectors
        b = shard.server.last_task_vectors
        chk[f"strategy/{name}/tv_close"] = bool(
            torch.allclose(a, b, rtol=1e-4, atol=1e-5))
        chk[f"strategy/{name}/tv_bitwise"] = bool(same(a, b))
        chk[f"strategy/{name}/masks_equal"] = all(
            torch.equal(plain.downlinks[u.client_id].masks,
                        shard.downlinks[u.client_id].masks)
            for u in uploads)
        chk[f"strategy/{name}/wire_bitwise"] = bool(
            same_wire(wire(plain), wire(shard)))
        chk[f"strategy/{name}/bits"] = bool(
            plain.uplink_bits(uploads) == shard.uplink_bits(uploads)
            and plain.downlink_bits() == shard.downlink_bits() > 0)

    # the async server step: staleness-weighted slots on the mesh
    plain = AsyncMaTUStrategy(n_tasks, d, device="cpu")
    shard = AsyncMaTUStrategy(n_tasks, d, device="cpu")
    shard.use_mesh(mesh)
    stale = [0, 1, 0, 2, 1, 0]
    for s in (plain, shard):
        s.aggregate_admitted(RoundBatch.from_uploads(uploads, n_tasks),
                             stale)
        s._drain()
    chk["async/task_vecs_bitwise"] = bool(same(plain._task_vecs,
                                               shard._task_vecs))
    chk["async/wire_bitwise"] = bool(same_wire(wire(plain), wire(shard)))

    # simulator level: the same FedSimulator script, mesh threaded through
    con = make_constellation(n_tasks=4, n_groups=2, feat_dim=16, n_classes=4,
                             conflict_pairs=[(0, 1)], seed=0)
    split = dirichlet_split(n_clients=5, n_tasks=4, n_classes=4, zeta_t=0.0,
                            seed=0)
    cfg = FedConfig(rounds=2, local_steps=4, eval_every=2, seed=0,
                    batch_size=16, local_data=64)
    hists, strats = [], []
    for m in (None, mesh):
        bb = MLPBackbone(16, hidden=24, lora_rank=4)
        strat = MaTUStrategy(4, bb.d, device="cpu")
        hists.append(FedSimulator(cfg, con, split, bb, strat, device="cpu",
                                  mesh=m).run())
        strats.append(strat)
    h0, h1 = hists
    chk["fedsim/ran"] = len(h1.mean_acc) > 0 and h1.mean_downlink_bits > 0
    chk["fedsim/bits"] = bool(
        h0.uplink_bits_per_round == h1.uplink_bits_per_round
        and h0.downlink_bits_per_round == h1.downlink_bits_per_round)
    chk["fedsim/tv_close"] = bool(torch.allclose(
        strats[0].server.last_task_vectors,
        strats[1].server.last_task_vectors, rtol=1e-4, atol=1e-5))
    chk["fedsim/bitwise"] = bool(
        h0.task_acc == h1.task_acc
        and same(strats[0].server.last_task_vectors,
                 strats[1].server.last_task_vectors))

    # the population simulator on the (slots, data) mesh
    pops = []
    for m in (None, meshes["pop_s2"]):
        sim = PopulationSimulator(
            FedConfig(rounds=2, eval_every=1, seed=0),
            PopulationSplit(n_clients=1000, n_tasks=5, seed=0), d=700,
            clients_per_round=8, chunk_clients=3, dropout_prob=0.1,
            device="cpu", mesh=m)
        pops.append((sim, sim.run()))
    (s0, p0), (s1, p1) = pops
    chk["population/bitwise"] = bool(
        np.array_equal(s0._tv_host, s1._tv_host)
        and p0.uplink_bits_per_round == p1.uplink_bits_per_round
        and p0.downlink_bits_per_round == p1.downlink_bits_per_round
        and p0.fault_counts == p1.fault_counts)


def rank_main(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(work, 'store')}",
        rank=rank, world_size=WORLD)
    try:
        rep = run_checks(rank, work)
        with open(os.path.join(work, f"report_{rank}.pkl"), "wb") as f:
            pickle.dump(rep, f)
    finally:
        dist.destroy_process_group()


def failing_rank(rank: int, work: str) -> None:
    """Two ranks; rank 1 raises before the round's first collective."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(work, 'fail_store')}",
        rank=rank, world_size=2)
    try:
        if rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    work = sys.argv[1]
    if sys.argv[2:] == ["--fail"]:
        mp.spawn(failing_rank, args=(work,), nprocs=2)
    else:
        mp.spawn(rank_main, args=(work,), nprocs=WORLD)
