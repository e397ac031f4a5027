"""Federated simulation harness.

Runs R rounds of: client sampling (ξ) → per-(client, task) local
fine-tuning in flat task-vector space → strategy aggregation → global
per-task head averaging → periodic evaluation.  Produces per-task
accuracy, averages, the measured wire bits per round, the server step's
phases and the fault counters of every round.

Async & fault model
-------------------
``systems=ClientSystems(...)`` (:mod:`repro_torch.fed.systems`) switches
the loop to the event-clock mode: each round is a tick; sampled clients
train, but their uploads enter an ``AdmissionQueue`` with the arrival
tick ``dispatch + systems.delay(c, r)``, and the server drains what has
arrived by the current tick.  Crashed clients are never sampled,
dropouts never upload, and uploads older than ``FedConfig.max_staleness``
rounds are dropped as stale.  The drain goes to the strategy's
``aggregate_admitted`` with each upload's staleness where it has one
(``AsyncMaTUStrategy``), else to ``aggregate_batch``; a tick that admits
nothing calls ``strategy.skip_round()`` and records a 0-bit History row.
``History.fault_counts`` holds ``fed.systems.FAULT_KEYS`` for every
round (in sync mode: sampled == admitted, zeros elsewhere).  Under
``ClientSystems.ideal(n)`` every upload arrives in its dispatch tick in
selection order with staleness 0, so the async run is bit-identical to
the sync one.

Random draws are failure-invariant, like the JAX package's fold_in
chains: every draw comes from its own generator, seeded by a numpy
``SeedSequence`` of (seed, stream tag, ids…) — client selection by
(round), local data by (client, task), training by (client, round,
task), heads by (task).  The numbers differ from the JAX package's;
the laws are the same: a fault injected for one client moves no other
client's draw, and the async selection with every client available is
the sync selection.

Population mode
---------------
:class:`PopulationSimulator` is the client-axis scale-out harness: a
lazy :class:`~repro_torch.data.dirichlet.PopulationSplit` over
10^5–10^6 clients, per-round sampling, and the chunked server round
(``MaTUServer.round_chunked``), so a round's d-wide memory is O(chunk +
T·d) however many clients report.  Nothing per-client exists for the
clients not sampled: a sampled client's upload is derived on demand from
``(seed, round, client_id)`` and the round's global task vectors (the
engine's first pass reads its ids, tasks and sizes; its d-wide rows are
derived when the second pass packs them), and its downlink goes to a
sink instead of a cache, so neither the simulator nor the server grows
state with the population.  ``History`` rows are the
aggregate per-round scalars of the sync loop (measured wire bits, fault
counters, and in ``phase_us`` the host µs spent deriving uploads beside
the server step's); ``FedConfig.eval_every`` gates evaluation as in
:meth:`FedSimulator.run`.  Local "training" is the synthetic drift
``τ ← τ + step·(g_t − τ) + noise`` toward fixed hidden per-task targets
g_t, so convergence (cosine alignment to g_t, reported through
``History.task_acc``) means something without per-client model state.
Its draws are the JAX package's: numpy generators seeded by the same
tuples, so sampled ids, dropouts, targets and noise are equal there and
here; the unify runs on the device.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import TaskVectorLayoutError, pad_vector
from repro_torch.core.client import ClientUpload
from repro_torch.core.server import MaTUServer, MaTUServerConfig
from repro_torch.core.unify import unify_with_modulators
from repro_torch.data.dirichlet import FedSplit, PopulationSplit
from repro_torch.data.synthetic import (Constellation, eval_batch,
                                        sample_task_batch)
from repro_torch.fed.local import make_head, make_local_trainer
from repro_torch.fed.strategies import RoundBatch, Strategy, Upload
from repro_torch.fed.systems import (AdmissionQueue, ClientSystems,
                                     blank_fault_counters)
from repro_torch.fed.testbed import round_up_d

# stream tags of the seeded generators
_SELECT, _TRAIN, _DATA, _HEAD = 0, 1, 2, 3


def seeded_generator(*ids: int) -> torch.Generator:
    """A CPU generator seeded by a hash of ``ids`` (non-negative ints)."""
    seed = np.random.SeedSequence([int(i) for i in ids]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


@dataclass
class FedConfig:
    rounds: int = 20
    participation: float = 1.0       # ξ
    local_steps: int = 10            # E (steps per task per round)
    batch_size: int = 32
    local_data: int = 256            # samples per (client, task)
    lr: float = 5e-3
    prox_mu: float = 0.1             # FedProx's μ (strategies with needs_prox)
    eval_every: int = 5
    seed: int = 0
    # the strategy's deferred drain (MaTU; a no-op for the others):
    # bit-identical to False
    pipeline: bool = False
    # async mode: an upload older than this many rounds is dropped as
    # stale (History.fault_counts["stale"])
    max_staleness: int = 4


@dataclass
class History:
    rounds: List[int] = field(default_factory=list)
    task_acc: List[Dict[int, float]] = field(default_factory=list)
    mean_acc: List[float] = field(default_factory=list)
    uplink_bits_per_round: List[int] = field(default_factory=list)
    # measured off the downlink wire buffers where the strategy has them
    downlink_bits_per_round: List[int] = field(default_factory=list)
    # every round: the server step's host / device µs as the strategy
    # reports them ({} where it measures nothing).  Under pipeline=True
    # a round's phases complete at its drain, so entry r holds the last
    # round COMPLETED when round r was recorded: one behind.
    phase_us: List[Dict[str, float]] = field(default_factory=list)
    # every round: the fed.systems.FAULT_KEYS counters (clients sampled,
    # dropped, crashed, straggling; uploads stale, quarantined, still
    # buffered, admitted; skipped = 1 when nothing was admitted)
    fault_counts: List[Dict[str, int]] = field(default_factory=list)

    @property
    def total_fault_counts(self) -> Dict[str, int]:
        """The fault counters summed over the run."""
        out = blank_fault_counters()
        for row in self.fault_counts:
            for k, v in row.items():
                out[k] = out.get(k, 0) + int(v)
        return out

    @property
    def final_task_acc(self) -> Dict[int, float]:
        return self.task_acc[-1] if self.task_acc else {}

    @property
    def final_mean_acc(self) -> float:
        return self.mean_acc[-1] if self.mean_acc else 0.0

    @property
    def mean_uplink_bits(self) -> float:
        b = self.uplink_bits_per_round
        return float(np.mean(b)) if b else 0.0

    @property
    def mean_downlink_bits(self) -> float:
        b = self.downlink_bits_per_round
        return float(np.mean(b)) if b else 0.0

    @property
    def mean_phase_us(self) -> Dict[str, float]:
        """Each phase's mean µs over the rounds that reported it."""
        out: Dict[str, List[float]] = {}
        for ph in self.phase_us:
            for key, us in (ph or {}).items():
                out.setdefault(key, []).append(us)
        return {k: float(np.mean(v)) for k, v in out.items()}


class FedSimulator:
    def __init__(self, cfg: FedConfig, constellation: Constellation,
                 split: FedSplit, backbone, strategy: Strategy, *,
                 systems: Optional[ClientSystems] = None,
                 device: DeviceLike = "cuda", mesh=None):
        """``backbone``: one backbone shared by every client, or a
        per-client mapping (a dict ``{client_id: backbone}`` or a list),
        so one round mixes architectures.  Each client's delta flattens
        through its own manifest and is zero-padded to the round's
        common d (the largest d, rounded up to the word boundary);
        holders of one task must share a manifest fingerprint (checked
        here, and by the strategy before every aggregation), because
        their rows merge coordinate by coordinate.  Backbones are moved
        to ``device`` (``nn.Module.to``); the strategy must live on the
        same device.  ``systems`` switches ``run`` to the event-clock
        mode (module docstring, "Async & fault model").  ``mesh``: an
        optional taskvec mesh threaded to the strategy (MaTU's round then
        runs sharded, this process being one rank; every rank runs the
        same simulator with the same seeds)."""
        self.cfg = cfg
        self.con = constellation
        self.split = split
        self.strategy = strategy
        self.device = resolve_device(device)
        if strategy.device != self.device:
            raise ValueError(f"strategy runs on {strategy.device}, the "
                             f"simulator on {self.device}")
        self.n_clients = len(split.tasks)
        self.systems = systems
        if systems is not None and systems.n_clients != self.n_clients:
            raise ValueError(f"systems models {systems.n_clients} clients, "
                             f"split has {self.n_clients}")
        strategy.use_pipeline(cfg.pipeline)
        self.mesh = mesh
        if mesh is not None:
            strategy.use_mesh(mesh)
        dev = self.device

        # -- backbones: a per-client map; one shared object maps every
        # client to it, keeps its own d and puts no fingerprint on the wire
        self._mixed = isinstance(backbone, (dict, list, tuple))
        if isinstance(backbone, (list, tuple)):
            backbone = dict(enumerate(backbone))
        elif not self._mixed:
            backbone = dict.fromkeys(range(self.n_clients), backbone)
        missing = set(range(self.n_clients)) - set(backbone)
        if missing:
            raise ValueError(f"per-client backbones missing clients "
                             f"{sorted(missing)}")
        self.backbones: Dict[int, object] = {
            int(c): b.to(dev) for c, b in backbone.items()}
        self.d = (round_up_d(max(b.d for b in self.backbones.values()))
                  if self._mixed else backbone[0].d)

        # per-task layout agreement, and the backbone a task evaluates
        # through: every holder of a task flattens through one manifest
        self._task_backbone: Dict[int, object] = {}
        for t in range(self.con.n_tasks):
            bbs = [self.backbones[c] for c in range(self.n_clients)
                   if t in split.tasks[c]]
            if not bbs:
                continue
            fps = {b.fingerprint for b in bbs}
            if len(fps) > 1:
                raise TaskVectorLayoutError(
                    f"task {t} is held by clients with different "
                    f"task-vector layouts {sorted(fps)}; holders of "
                    f"one task must share a manifest")
            if len({b.feat_out for b in bbs}) > 1:
                raise ValueError(
                    f"task {t} holders disagree on feat_out; the "
                    f"shared head needs one feature width")
            self._task_backbone[t] = bbs[0]
        if self._mixed:
            strategy.use_layouts({t: b.fingerprint
                                  for t, b in self._task_backbone.items()})

        # one trainer per distinct backbone object, with the strategy's
        # proximal term (FedProx) or linearised features (NTK-FedAvg)
        self._trainers: Dict[int, object] = {}
        for bb in self.backbones.values():
            if id(bb) not in self._trainers:
                self._trainers[id(bb)] = make_local_trainer(
                    bb, steps=cfg.local_steps, batch_size=cfg.batch_size,
                    lr=cfg.lr,
                    prox_mu=cfg.prox_mu if strategy.needs_prox else 0.0,
                    linearize=strategy.needs_linearize)

        # pre-sampled local datasets (fixed size per (client, task))
        self.local_data: Dict[tuple, tuple] = {}
        for c in range(self.n_clients):
            for t in split.tasks[c]:
                x, y = sample_task_batch(
                    self.con.tasks[t], seeded_generator(cfg.seed, _DATA, c, t),
                    cfg.local_data, split.class_probs.get((c, t)))
                self.local_data[(c, t)] = (x.to(dev), y.to(dev))
        # global per-task heads (averaged among holders every round),
        # sized for the task's backbone
        self.heads: Dict[int, torch.Tensor] = {
            t: make_head(seeded_generator(cfg.seed, _HEAD, t),
                         self._backbone_for_task(t).feat_out,
                         self.con.n_classes).to(dev)
            for t in range(self.con.n_tasks)}
        self._eval_sets = {}
        for t in range(self.con.n_tasks):
            x, y = eval_batch(self.con.tasks[t])
            self._eval_sets[t] = (x.to(dev), y.to(dev))

    def _backbone_for_task(self, task_id: int):
        return self._task_backbone.get(task_id,
                                       next(iter(self.backbones.values())))

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def task_accuracy(self, task_id: int, tv: torch.Tensor) -> float:
        x, y = self._eval_sets[task_id]
        bb = self._backbone_for_task(task_id)
        logits = bb.features(tv[:bb.d], x) @ self.heads[task_id]
        return float(torch.mean((torch.argmax(logits, -1) == y).float()))

    def evaluate(self) -> Dict[int, float]:
        return {t: float(np.mean([self.task_accuracy(t, v)
                                  for v in self.strategy.eval_vectors(t)]))
                for t in range(self.con.n_tasks)}

    # -- local training -----------------------------------------------------
    def _train_client(self, c: int, r: int) -> Tuple[Upload, List[tuple]]:
        bb = self.backbones[c]
        trainer = self._trainers[id(bb)]
        tvs, sizes, head_pairs = [], [], []
        for t in self.split.tasks[c]:
            x, y = self.local_data[(c, t)]
            # wire edge: the strategy hands out the round's common-d
            # vector; this client's manifest covers the [0, bb.d) prefix
            tv0 = self.strategy.task_init(c, t)[:bb.d]
            tv, head, _loss = trainer(
                tv0, self.heads[t], x, y,
                seeded_generator(self.cfg.seed, _TRAIN, c, r, t))
            tvs.append(pad_vector(tv, self.d))
            sizes.append(self.split.data_sizes[(c, t)])
            head_pairs.append((t, head, sizes[-1]))
        fp = bb.fingerprint if self._mixed else None
        return (Upload(c, list(self.split.tasks[c]), torch.stack(tvs), sizes,
                       fingerprint=fp),
                head_pairs)

    # -- main loop ----------------------------------------------------------
    def _select(self, r: int, n_sel: int, counters: Dict[str, int]
                ) -> np.ndarray:
        """Round ``r``'s sampled clients.  In async mode only available
        clients are drawn from; when all are, the draw is the sync
        branch's (the ideal-trace parity anchor)."""
        rng = np.random.default_rng([self.cfg.seed, _SELECT, r])
        sysm = self.systems
        avail = (list(range(self.n_clients)) if sysm is None else
                 [c for c in range(self.n_clients) if sysm.available(c, r)])
        counters["crashed"] = self.n_clients - len(avail)
        if len(avail) == self.n_clients:
            return rng.choice(self.n_clients, n_sel, replace=False)
        if not avail:
            return np.asarray([], np.int64)
        idx = rng.choice(len(avail), min(n_sel, len(avail)), replace=False)
        return np.asarray(avail, np.int64)[idx]

    def run(self, verbose: bool = False) -> History:
        cfg = self.cfg
        hist = History()
        n_sel = max(1, int(round(cfg.participation * self.n_clients)))
        sysm = self.systems
        queue = AdmissionQueue() if sysm is not None else None
        for r in range(cfg.rounds):
            counters = blank_fault_counters()
            selected = self._select(r, n_sel, counters)
            counters["sampled"] = int(len(selected))

            # sync admits in place; async pushes into the admission
            # queue with the trace's arrival tick
            admitted: List[Upload] = []
            head_lists: List[list] = []
            staleness: List[int] = []
            dispatch_rounds: List[int] = []
            for c in selected:
                c = int(c)
                if sysm is not None and sysm.dropout(c, r):
                    counters["dropped"] += 1
                    continue
                upload, head_pairs = self._train_client(c, r)
                if sysm is None:
                    admitted.append(upload)
                    head_lists.append(head_pairs)
                    staleness.append(0)
                    continue
                delay = sysm.delay(c, r)
                if delay > 0:
                    counters["stragglers"] += 1
                queue.push(r + delay, r, (upload, head_pairs))
            if sysm is not None:
                for item in queue.pop_ready(r):
                    upload, head_pairs = item.payload
                    s = r - item.dispatch
                    if s > cfg.max_staleness:
                        counters["stale"] += 1
                        continue
                    admitted.append(upload)
                    head_lists.append(head_pairs)
                    staleness.append(s)
                    dispatch_rounds.append(item.dispatch)
                counters["buffered"] = len(queue)
            counters["admitted"] = len(admitted)

            if not admitted:
                # nothing reached the server this tick: skip and carry
                counters["skipped"] = 1
                self.strategy.skip_round()
            elif hasattr(self.strategy, "aggregate_admitted"):
                self.strategy.aggregate_admitted(
                    RoundBatch.from_uploads(admitted, self.con.n_tasks),
                    staleness, sysm,
                    dispatch_rounds if sysm is not None else None)
            else:
                self.strategy.aggregate_batch(
                    RoundBatch.from_uploads(admitted, self.con.n_tasks))
            quarantined = getattr(self.strategy, "last_quarantined",
                                  frozenset())
            counters["quarantined"] = len(quarantined)
            hist.fault_counts.append(counters)
            # under pipeline=True the round is still in flight here: this
            # is the last completed round's phases (History.phase_us)
            hist.phase_us.append(dict(self.strategy.last_phase_us or {}))

            # heads averaged over the admitted, non-quarantined uploads
            new_heads: Dict[int, list] = {}
            for upload, pairs in zip(admitted, head_lists):
                if upload.client_id in quarantined:
                    continue
                for t, head, size in pairs:
                    new_heads.setdefault(t, []).append((head, size))
            for t, pairs in new_heads.items():
                w = torch.tensor([p[1] for p in pairs], dtype=torch.float32,
                                 device=self.device)
                w = w / torch.sum(w)
                self.heads[t] = sum(wi * h for (h, _), wi in zip(pairs, w))

            bits = self.strategy.uplink_bits(admitted)
            if (r + 1) % cfg.eval_every == 0 or r == cfg.rounds - 1:
                acc = self.evaluate()
                hist.rounds.append(r + 1)
                hist.task_acc.append(acc)
                hist.mean_acc.append(float(np.mean(list(acc.values()))))
                hist.uplink_bits_per_round.append(bits)
                hist.downlink_bits_per_round.append(
                    self.strategy.downlink_bits())
                if verbose:
                    print(f"[{self.strategy.name}] round {r+1:3d} "
                          f"mean_acc={hist.mean_acc[-1]:.3f} bits={bits:,}")
        return hist


class _Derived(ClientUpload):
    """A population client's :class:`ClientUpload` whose unified vector,
    masks and λ come from ``derive`` on first read."""

    def __init__(self, client_id: int, task_ids: List[int],
                 data_sizes: List[int], derive):
        self.client_id, self.task_ids, self.data_sizes = (client_id, task_ids,
                                                          data_sizes)
        self.fingerprint, self._dense, self._derive = None, None, derive

    @functools.cached_property
    def _wire(self):
        return self._derive()

    unified = property(lambda self: self._wire[0])
    masks = property(lambda self: self._wire[1])
    lams = property(lambda self: self._wire[2])


# population-mode stream tags of the numpy generators, the JAX
# package's: disjoint from PopulationSplit's (0x11 / 0x22 / 0x33), so the
# simulator's draws never meet the split's under one seed
_POP_TARGET, _POP_UPDATE, _POP_DROP = 0x44, 0x55, 0x66


class PopulationSimulator:
    """Client-axis scale-out harness over a lazy population (module
    docstring, "Population mode").

    ``clients_per_round`` defaults to ``participation · n_clients``: set
    it (or a small ``FedConfig.participation``) for populations where
    training the whole cohort is not the point.  ``sink``: optional
    per-chunk downlink consumer; the default discards them, so no
    per-client state accumulates anywhere.  The server runs on
    ``device``; ``_tv_host`` is a host copy of its task vectors.
    ``mesh``: an optional taskvec mesh; the chunked round then runs
    sharded (d, and the slot rows on a ``make_population_mesh``), this
    process being one rank of it."""

    def __init__(self, cfg: FedConfig, split: PopulationSplit,
                 server_cfg: Optional[MaTUServerConfig] = None, *,
                 d: int = 4096, clients_per_round: Optional[int] = None,
                 chunk_clients: int = 64, step: float = 0.3,
                 noise: float = 1e-2, dropout_prob: float = 0.0,
                 code_masks: bool = False, sink=None,
                 device: DeviceLike = "cuda", mesh=None):
        self.cfg = cfg
        self.split = split
        self.d = int(d)
        self.n_tasks = split.n_tasks
        self.chunk_clients = int(chunk_clients)
        self.step = float(step)
        self.noise = float(noise)
        self.dropout_prob = float(dropout_prob)
        self.code_masks = code_masks
        self.sink = sink if sink is not None else (lambda links: None)
        self.clients_per_round = int(
            clients_per_round if clients_per_round is not None
            else max(1, round(cfg.participation * split.n_clients)))
        self.server = MaTUServer(
            server_cfg or MaTUServerConfig(n_tasks=split.n_tasks),
            device=device, mesh=mesh)
        self.device = self.server.device
        # hidden per-task targets the synthetic updates drift toward:
        # O(T·d), the round's own footprint class
        trg = np.random.default_rng((cfg.seed, _POP_TARGET)).standard_normal(
            (self.n_tasks, self.d)).astype(np.float32)
        self._targets = trg / np.linalg.norm(trg, axis=1, keepdims=True)
        self._tv_host = np.zeros((self.n_tasks, self.d), np.float32)
        self._derive_s = 0.0

    # -- lazy client derivation --------------------------------------------
    def _dropout(self, c: int, r: int) -> bool:
        return bool(self.dropout_prob > 0.0 and np.random.default_rng(
            (self.cfg.seed, _POP_DROP, int(r), int(c))).random()
            < self.dropout_prob)

    def _make_upload(self, c: int, r: int, tv: np.ndarray) -> "_Derived":
        """Client ``c``'s round-``r`` upload, derived from scratch: tasks
        and sizes from the lazy split, noise from the (seed, round,
        client) stream, drift from the global task vectors ``tv`` (frozen
        for the round, so the engine's two passes see the same uploads).
        The d-wide part is derived when first read: the engine's first
        pass reads ids, tasks and sizes only."""
        ts = self.split.tasks_for(c)
        sizes = [self.split.local_stats(c, t)[1] for t in ts]
        return _Derived(int(c), ts, sizes,
                        lambda: self._derive_rows(c, r, tv, ts))

    def _derive_rows(self, c: int, r: int, tv: np.ndarray,
                     ts: List[int]):
        """(unified, masks, lams) of client ``c``'s drifted task rows,
        the unify on the simulator's device."""
        t0 = time.perf_counter()
        rng = np.random.default_rng((self.cfg.seed, _POP_UPDATE,
                                     int(r), int(c)))
        rows = np.empty((len(ts), self.d), np.float32)
        for i, t in enumerate(ts):
            z = rng.standard_normal(self.d).astype(np.float32)
            rows[i] = tv[t] + self.step * (self._targets[t] - tv[t]) \
                + self.noise * z
        self._derive_s += time.perf_counter() - t0
        return unify_with_modulators(torch.from_numpy(rows).to(self.device))

    def _upload_factory(self, ids: List[int], r: int):
        tv = self._tv_host      # one snapshot for both engine passes

        def gen():
            for c in ids:
                yield self._make_upload(c, r, tv)

        return gen

    # -- evaluation ---------------------------------------------------------
    def evaluate(self) -> Dict[int, float]:
        """Per-task alignment of the server's task vector with its hidden
        target, mapped to [0, 1] (cosine → (1 + cos) / 2)."""
        out = {}
        for t in range(self.n_tasks):
            v, g = self._tv_host[t], self._targets[t]
            den = float(np.linalg.norm(v) * np.linalg.norm(g))
            out[t] = 0.5 * (1.0 + float(v @ g) / den) if den > 0 else 0.0
        return out

    # -- main loop ----------------------------------------------------------
    def run(self, verbose: bool = False) -> History:
        """``History.phase_us`` holds, a round, ``derive`` (host µs
        drawing the uploads' rows; ``pack`` reads the uploads, so it
        includes them), ``round`` (the server step's wall µs) and the
        engine's ``pack`` / ``decode`` / ``encode`` µs."""
        cfg = self.cfg
        hist = History()
        for r in range(cfg.rounds):
            counters = blank_fault_counters()
            ids = self.split.sample_round(r, self.clients_per_round)
            counters["sampled"] = int(len(ids))
            if self.dropout_prob > 0.0:
                keep = np.asarray([not self._dropout(int(c), r)
                                   for c in ids], bool)
                counters["dropped"] = int(len(ids) - keep.sum())
                ids = ids[keep]
            stats = {"uplink_bits": 0, "downlink_bits": 0}
            phase: Dict[str, float] = {}
            if len(ids):
                self._derive_s = 0.0
                t0 = time.perf_counter()
                _, stats = self.server.round_chunked(
                    self._upload_factory([int(c) for c in ids], r),
                    chunk_clients=self.chunk_clients,
                    code_masks=self.code_masks, sink=self.sink,
                    phase_us=phase)
                self._tv_host = self.server.last_task_vectors.cpu().numpy()
                phase["round"] = (time.perf_counter() - t0) * 1e6
                phase["derive"] = self._derive_s * 1e6
            else:
                counters["skipped"] = 1
            counters["admitted"] = int(len(ids))
            hist.fault_counts.append(counters)
            hist.phase_us.append(phase)
            if (r + 1) % cfg.eval_every == 0 or r == cfg.rounds - 1:
                acc = self.evaluate()
                hist.rounds.append(r + 1)
                hist.task_acc.append(acc)
                hist.mean_acc.append(float(np.mean(list(acc.values()))))
                hist.uplink_bits_per_round.append(stats["uplink_bits"])
                hist.downlink_bits_per_round.append(stats["downlink_bits"])
                if verbose:
                    print(f"[population] round {r+1:3d} "
                          f"align={hist.mean_acc[-1]:.3f} "
                          f"bits={stats['uplink_bits']:,}")
        return hist


def individual_baseline(cfg: FedConfig, constellation: Constellation,
                        backbone, *, steps_multiplier: int = 10,
                        seed: int = 0,
                        device: DeviceLike = "cuda") -> Dict[int, float]:
    """Per-task centralised fine-tuning (the paper's upper bound)."""
    dev = resolve_device(device)
    backbone = backbone.to(dev)
    trainer = make_local_trainer(backbone,
                                 steps=cfg.local_steps * steps_multiplier,
                                 batch_size=cfg.batch_size, lr=cfg.lr)
    out = {}
    for t in range(constellation.n_tasks):
        task = constellation.tasks[t]
        x, y = sample_task_batch(task, seeded_generator(seed, _DATA, t),
                                 cfg.local_data * 4)
        tv0 = torch.zeros((backbone.d,), dtype=torch.float32, device=dev)
        head0 = make_head(seeded_generator(seed, _HEAD, t), backbone.feat_out,
                          constellation.n_classes).to(dev)
        tv, head, _ = trainer(tv0, head0, x.to(dev), y.to(dev),
                              seeded_generator(seed, _TRAIN, t))
        xe, ye = eval_batch(task)
        with torch.no_grad():
            logits = backbone.features(tv, xe.to(dev)) @ head
        out[t] = float(torch.mean((torch.argmax(logits, -1)
                                   == ye.to(dev)).float()))
    return out
