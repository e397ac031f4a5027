"""Federated simulation harness (synchronous rounds).

Runs R rounds of: client sampling (ξ) → per-(client, task) local
fine-tuning in flat task-vector space → strategy aggregation → global
per-task head averaging → periodic evaluation.  Produces per-task
accuracy, averages, and the measured wire bits per round.

Random draws are failure-invariant, like the JAX package's fold_in
chains: every draw comes from its own generator, seeded by a numpy
``SeedSequence`` of (seed, stream tag, ids…) — client selection by
(round), local data by (client, task), training by (client, round,
task), heads by (task).  The numbers differ from the JAX package's;
the laws are the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import TaskVectorLayoutError, pad_vector
from repro_torch.data.dirichlet import FedSplit
from repro_torch.data.synthetic import (Constellation, eval_batch,
                                        sample_task_batch)
from repro_torch.fed.local import make_head, make_local_trainer
from repro_torch.fed.strategies import RoundBatch, Strategy, Upload
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


@dataclass
class History:
    rounds: List[int] = field(default_factory=list)
    task_acc: List[Dict[int, float]] = field(default_factory=list)
    mean_acc: List[float] = field(default_factory=list)
    uplink_bits_per_round: List[int] = field(default_factory=list)
    # measured off the downlink wire buffers where the strategy has them
    downlink_bits_per_round: List[int] = field(default_factory=list)

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


class FedSimulator:
    def __init__(self, cfg: FedConfig, constellation: Constellation,
                 split: FedSplit, backbone, strategy: Strategy, *,
                 device: DeviceLike = "cuda"):
        """``backbone``: one backbone shared by every client, or a
        per-client mapping (a dict ``{client_id: backbone}`` or a list),
        so one round mixes architectures.  Each client's delta flattens
        through its own manifest and is zero-padded to the round's
        common d (the largest d, rounded up to the word boundary);
        holders of one task must share a manifest fingerprint (checked
        here, and by the strategy before every aggregation), because
        their rows merge coordinate by coordinate.  Backbones are moved
        to ``device`` (``nn.Module.to``); the strategy must live on the
        same device."""
        self.cfg = cfg
        self.con = constellation
        self.split = split
        self.strategy = strategy
        self.device = resolve_device(device)
        if strategy.device != self.device:
            raise ValueError(f"strategy runs on {strategy.device}, the "
                             f"simulator on {self.device}")
        self.n_clients = len(split.tasks)
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
    def run(self, verbose: bool = False) -> History:
        cfg = self.cfg
        hist = History()
        n_sel = max(1, int(round(cfg.participation * self.n_clients)))
        for r in range(cfg.rounds):
            selected = np.random.default_rng([cfg.seed, _SELECT, r]).choice(
                self.n_clients, n_sel, replace=False)
            uploads, head_lists = [], []
            for c in selected:
                upload, head_pairs = self._train_client(int(c), r)
                uploads.append(upload)
                head_lists.append(head_pairs)
            self.strategy.aggregate_batch(
                RoundBatch.from_uploads(uploads, self.con.n_tasks))

            new_heads: Dict[int, list] = {}
            for pairs in head_lists:
                for t, head, size in pairs:
                    new_heads.setdefault(t, []).append((head, size))
            for t, pairs in new_heads.items():
                w = torch.tensor([p[1] for p in pairs], dtype=torch.float32,
                                 device=self.device)
                w = w / torch.sum(w)
                self.heads[t] = sum(wi * h for (h, _), wi in zip(pairs, w))

            bits = self.strategy.uplink_bits(uploads)
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
