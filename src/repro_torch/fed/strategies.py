"""Federated aggregation strategies: MaTU (synchronous, on the packed or
the entropy-coded wire) and the paper's baselines (Tables 1–2): FedAvg,
FedProx, NTK-FedAvg, TIES, FedPer and MaT-FL.

The simulator calls, per round:
  ``task_init(client, task)``       → τ to start local training from
  ``aggregate_batch(batch)``        → server step (strategy state)
  ``eval_vectors(task)``            → τ to evaluate for a task
  ``uplink_bits(uploads)``          → communicated bits this round
  ``downlink_bits()``               → measured downlink bits this round

Each strategy decides what is transmitted (MaTU: one unified vector +
modulators; the others: per-task adapters), and the uplink accounting
follows it.  ``needs_prox`` / ``needs_linearize`` tell the simulator to
train with FedProx's proximal term or NTK-FedAvg's linearised model.
Every strategy keeps its state on its ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import TaskVectorLayoutError
from repro_torch.core.baselines import (cosine_similarity_matrix,
                                        greedy_group, mean_rows, ties_merge,
                                        weighted_average)
from repro_torch.core.client import ClientDownlink, ClientUpload, paper_link_bits
from repro_torch.core.engine import (batched_client_unify, pack_from_slots,
                                     split_streams, valid_rows)
from repro_torch.core.server import MaTUServer, MaTUServerConfig
from repro_torch.core.unify import modulate
from repro_torch.kernels import bitpack
from repro_torch.kernels.ref import next_pow2

FLOAT_BITS = 32


@dataclass
class Upload:
    client_id: int
    task_ids: List[int]
    task_vectors: torch.Tensor  # (k, d) fine-tuned vectors, one per task
    data_sizes: List[int]
    # TaskVectorSpace fingerprint of the client's backbone (None for
    # homogeneous rounds), checked by Strategy.verify_layouts
    fingerprint: Optional[str] = None


@dataclass
class RoundBatch:
    """One round's uploads, with fixed-shape slot tensors built lazily
    on first access (on the device of the uploads' vectors)."""
    uploads: List[Upload]
    n_tasks: int
    k_max: int
    _packed: Optional[tuple] = None

    @classmethod
    def from_uploads(cls, uploads: List[Upload], n_tasks: int,
                     k_max: Optional[int] = None) -> "RoundBatch":
        k_max = k_max or next_pow2(max(len(u.task_ids) for u in uploads))
        return cls(list(uploads), n_tasks, k_max)

    def _pack(self) -> tuple:
        if self._packed is None:
            n = len(self.uploads)
            first = self.uploads[0].task_vectors
            d, dev = int(first.shape[-1]), first.device
            tvs = torch.zeros((n, self.k_max, d), dtype=torch.float32,
                              device=dev)
            valid = torch.zeros((n, self.k_max), dtype=torch.bool)
            tasks = torch.full((n, self.k_max), self.n_tasks,
                               dtype=torch.int32)
            sizes = torch.zeros((n, self.k_max), dtype=torch.float32)
            for i, u in enumerate(self.uploads):
                k = len(u.task_ids)
                tvs[i, :k] = u.task_vectors.to(dev, torch.float32)
                valid[i, :k] = True
                tasks[i, :k] = torch.as_tensor(u.task_ids, dtype=torch.int32)
                sizes[i, :k] = torch.as_tensor(u.data_sizes,
                                               dtype=torch.float32)
            self._packed = (tvs, valid.to(dev), tasks.to(dev), sizes.to(dev))
        return self._packed

    @property
    def task_vectors(self) -> torch.Tensor:  # (N, k_max, d) zero-padded
        return self._pack()[0]

    @property
    def valid(self) -> torch.Tensor:         # (N, k_max) bool
        return self._pack()[1]

    @property
    def slot_tasks(self) -> torch.Tensor:    # (N, k_max) int32; T sentinel
        return self._pack()[2]

    @property
    def slot_sizes(self) -> torch.Tensor:    # (N, k_max) fp32
        return self._pack()[3]

    @property
    def client_ids(self) -> List[int]:
        return [u.client_id for u in self.uploads]

    @property
    def task_ids(self) -> List[List[int]]:
        return [list(u.task_ids) for u in self.uploads]


class Strategy:
    name = "base"
    needs_prox = False          # clients add FedProx's proximal term
    needs_linearize = False     # clients train the linearised model

    def __init__(self, n_tasks: int, d: int, device: DeviceLike = "cuda"):
        self.n_tasks, self.d = n_tasks, d
        self.device = resolve_device(device)
        # task id -> expected TaskVectorSpace fingerprint (use_layouts)
        self.expected_layouts: Optional[Dict[int, str]] = None

    def task_init(self, client_id: int, task_id: int) -> torch.Tensor:
        raise NotImplementedError

    def use_layouts(self, task_fingerprints: Dict[int, str]) -> None:
        """Install the server's expected per-task layout fingerprints;
        every later round checks its uploads against them before
        aggregating (:meth:`verify_layouts`)."""
        self.expected_layouts = dict(task_fingerprints)

    def verify_layouts(self, uploads: List[Upload]) -> None:
        """Raise :class:`TaskVectorLayoutError` when an upload's manifest
        fingerprint disagrees with the expected one of any task it
        holds.  A no-op until :meth:`use_layouts`; uploads without a
        fingerprint pass."""
        exp = self.expected_layouts
        if not exp:
            return
        for u in uploads:
            fp = getattr(u, "fingerprint", None)
            if fp is None:
                continue
            for t in u.task_ids:
                want = exp.get(t)
                if want is not None and want != fp:
                    raise TaskVectorLayoutError(
                        f"client {u.client_id} uploads task {t} flattened "
                        f"through manifest {fp}, server expects {want}; "
                        f"refusing to aggregate")

    def aggregate(self, uploads: List[Upload]) -> None:
        raise NotImplementedError

    def aggregate_batch(self, batch: RoundBatch) -> None:
        """Server step from a pre-packed batch; the default unwraps to
        the ragged per-client path."""
        self.verify_layouts(batch.uploads)
        self.aggregate(batch.uploads)

    def eval_vectors(self, task_id: int) -> List[torch.Tensor]:
        raise NotImplementedError

    def uplink_bits(self, uploads: List[Upload]) -> int:
        # default: one fp32 adapter per task per client
        return sum(FLOAT_BITS * self.d * len(u.task_ids) for u in uploads)

    def downlink_bits(self) -> int:
        """Measured downlink wire bits of the last round (0 where the
        strategy has no explicit downlink tensors)."""
        return 0


class MaTUStrategy(Strategy):
    """Synchronous MaTU on the packed wire: one fused kernel call builds
    every client's upload (bf16 unified + packed mask words), the round
    engine runs Eq. 3–7 + downlink re-unification, and the downlinks
    seed the next round's ``task_init``.  Wire bits are measured off the
    buffers the engine computes on.

    ``code_masks`` ships the Golomb-Rice wire both ways
    (:mod:`repro_torch.fed.compression`): the uplink streams encode the
    very words the engine computes on, in one batched call; the
    downlinks are encoded in one batched call and decoded by the
    clients on use; bits are measured off the streams.  ``compress``
    is accounting only: the uplink bits become the coder's measured size
    for masks that travelled as raw packed words."""
    name = "matu"

    def __init__(self, n_tasks: int, d: int, *, rho: float = 0.4,
                 eps: float = 0.5, kappa: int = 3, cross_task: bool = True,
                 uniform_cross: bool = False, compress: bool = False,
                 code_masks: bool = False, device: DeviceLike = "cuda"):
        super().__init__(n_tasks, d, device)
        self.server = MaTUServer(MaTUServerConfig(
            n_tasks=n_tasks, rho=rho, eps=eps, kappa=kappa,
            cross_task=cross_task, uniform_cross=uniform_cross),
            device=self.device)
        self.downlinks: Dict[int, ClientDownlink] = {}
        self.client_tasks: Dict[int, List[int]] = {}
        self.code_masks = code_masks
        self.compress = compress
        self._last_uploads: List[ClientUpload] = []

    def task_init(self, client_id: int, task_id: int) -> torch.Tensor:
        dl = self.downlinks.get(client_id)
        if dl is None:
            return torch.zeros((self.d,), dtype=torch.float32,
                               device=self.device)
        i = self.client_tasks[client_id].index(task_id)
        return modulate(dl.unified, dl.mask_row(i), dl.lams[i])

    def aggregate(self, uploads: List[Upload]) -> None:
        self.aggregate_batch(RoundBatch.from_uploads(uploads, self.n_tasks))

    def aggregate_batch(self, batch: RoundBatch) -> None:
        self.verify_layouts(batch.uploads)
        unified, mask_words, lams = batched_client_unify(
            batch.task_vectors, batch.valid, device=self.device)
        packed = pack_from_slots(batch.client_ids, batch.task_ids, unified,
                                 mask_words, lams,
                                 batch.slot_tasks.to(self.device),
                                 batch.valid.to(self.device),
                                 batch.slot_sizes.to(self.device),
                                 self.n_tasks, d=self.d)
        out = self.server.start_round(packed)
        ks = [len(u.task_ids) for u in batch.uploads]
        if self.code_masks:
            # the coded uplink: every client's word rows, the bytes the
            # engine computes on, entropy-coded in ONE batched call and
            # split back per client by the record sizes
            from repro_torch.fed.compression import encode_mask_rows_with_sizes
            up_masks = split_streams(*encode_mask_rows_with_sizes(
                valid_rows(bitpack.words_to_numpy(mask_words), ks),
                self.d), ks)
        else:
            up_masks = [mask_words[i, :k] for i, k in enumerate(ks)]
        self._last_uploads = [
            ClientUpload(u.client_id, list(u.task_ids), unified[i],
                         up_masks[i], lams[i, :k], list(u.data_sizes))
            for i, (u, k) in enumerate(zip(batch.uploads, ks))]
        for u in batch.uploads:
            self.client_tasks[u.client_id] = list(u.task_ids)
        self.downlinks.update(self.server.finish_round(
            packed, out, code_masks=self.code_masks))

    def eval_vectors(self, task_id: int) -> List[torch.Tensor]:
        return [self.server.last_task_vectors[task_id]]

    def uplink_bits(self, uploads: List[Upload]) -> int:
        if self._last_uploads:
            if self.compress and not self.code_masks:
                # accounting only: the coder's measured size for masks
                # that travelled as raw packed words
                from repro_torch.fed.compression import compressed_uplink_bits
                return sum(compressed_uplink_bits(u.unified, u.masks)
                           for u in self._last_uploads)
            # measured: the bits of the wire buffers (bf16 vector +
            # packed words or coded streams + fp32 scalers)
            return sum(u.uplink_bits() for u in self._last_uploads)
        # paper accounting before any wire buffer exists
        return sum(paper_link_bits(self.d, len(u.task_ids), FLOAT_BITS)
                   for u in uploads)

    def downlink_bits(self) -> int:
        """Measured downlink wire bits of the clients served last round."""
        return sum(self.downlinks[u.client_id].downlink_bits()
                   for u in self._last_uploads)


class FedAvgStrategy(Strategy):
    name = "fedavg"

    def __init__(self, n_tasks: int, d: int, device: DeviceLike = "cuda"):
        super().__init__(n_tasks, d, device)
        self.global_v = torch.zeros((d,), dtype=torch.float32,
                                    device=self.device)

    def task_init(self, client_id: int, task_id: int) -> torch.Tensor:
        return self.global_v

    def aggregate(self, uploads: List[Upload]) -> None:
        vecs, weights = [], []
        for u in uploads:
            for i, _t in enumerate(u.task_ids):
                vecs.append(u.task_vectors[i].to(self.device))
                weights.append(float(u.data_sizes[i]))
        self.global_v = weighted_average(torch.stack(vecs),
                                         torch.tensor(weights))

    def eval_vectors(self, task_id: int) -> List[torch.Tensor]:
        return [self.global_v]


class FedProxStrategy(FedAvgStrategy):
    """FedProx: FedAvg's merge; clients add (μ/2)·‖τ − τ_anchor‖²."""
    name = "fedprox"
    needs_prox = True


class NTKFedAvgStrategy(FedAvgStrategy):
    """NTK-FedAvg: FedAvg's merge; clients train the model linearised at
    the pretrained point (``lin_features``)."""
    name = "ntk-fedavg"
    needs_linearize = True


class TIESStrategy(Strategy):
    name = "ties"

    def __init__(self, n_tasks: int, d: int, keep_frac: float = 0.2,
                 device: DeviceLike = "cuda"):
        super().__init__(n_tasks, d, device)
        self.keep_frac = keep_frac
        self.global_v = torch.zeros((d,), dtype=torch.float32,
                                    device=self.device)

    def task_init(self, client_id: int, task_id: int) -> torch.Tensor:
        return self.global_v

    def aggregate(self, uploads: List[Upload]) -> None:
        vecs = [u.task_vectors[i].to(self.device)
                for u in uploads for i in range(len(u.task_ids))]
        self.global_v = ties_merge(torch.stack(vecs).float(),
                                   keep_frac=self.keep_frac)

    def eval_vectors(self, task_id: int) -> List[torch.Tensor]:
        return [self.global_v]


class FedPerStrategy(Strategy):
    """FedPer: the shared slice ``[0, split_point)`` averaged globally,
    the personal slice (later layers) kept per client.  Heads are
    always personal in this harness."""
    name = "fedper"

    def __init__(self, n_tasks: int, d: int, split_point: int,
                 device: DeviceLike = "cuda"):
        super().__init__(n_tasks, d, device)
        self.split = split_point
        self.shared = torch.zeros((split_point,), dtype=torch.float32,
                                  device=self.device)
        self.personal: Dict[int, torch.Tensor] = {}
        self.holders: Dict[int, List[int]] = {t: [] for t in range(n_tasks)}

    def _zeros_personal(self) -> torch.Tensor:
        return torch.zeros((self.d - self.split,), dtype=torch.float32,
                           device=self.device)

    def task_init(self, client_id: int, task_id: int) -> torch.Tensor:
        pers = self.personal.get(client_id)
        return torch.cat([self.shared,
                          self._zeros_personal() if pers is None else pers])

    def aggregate(self, uploads: List[Upload]) -> None:
        shared_vecs, weights = [], []
        for u in uploads:
            mean_tv = mean_rows(u.task_vectors.to(self.device))
            shared_vecs.append(mean_tv[:self.split])
            weights.append(float(sum(u.data_sizes)))
            self.personal[u.client_id] = mean_tv[self.split:]
            for t in u.task_ids:
                if u.client_id not in self.holders[t]:
                    self.holders[t].append(u.client_id)
        self.shared = weighted_average(torch.stack(shared_vecs),
                                       torch.tensor(weights))

    def eval_vectors(self, task_id: int) -> List[torch.Tensor]:
        out = [torch.cat([self.shared, self.personal[c]])
               for c in self.holders[task_id] if c in self.personal]
        return out or [torch.cat([self.shared, self._zeros_personal()])]

    def uplink_bits(self, uploads: List[Upload]) -> int:
        # clients transmit only the shared slice (per task)
        return sum(FLOAT_BITS * self.split * len(u.task_ids) for u in uploads)


class MaTFLStrategy(Strategy):
    """MaT-FL (Cai et al. 2023): clients grouped by the cosine similarity
    of their mean updates; aggregation within groups only."""
    name = "mat-fl"

    def __init__(self, n_tasks: int, d: int, threshold: float = 0.0,
                 device: DeviceLike = "cuda"):
        super().__init__(n_tasks, d, device)
        self.threshold = threshold
        self.client_v: Dict[int, torch.Tensor] = {}
        self.holders: Dict[int, List[int]] = {t: [] for t in range(n_tasks)}

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.d,), dtype=torch.float32, device=self.device)

    def task_init(self, client_id: int, task_id: int) -> torch.Tensor:
        v = self.client_v.get(client_id)
        return self._zeros() if v is None else v

    def aggregate(self, uploads: List[Upload]) -> None:
        ids = [u.client_id for u in uploads]
        means = torch.stack([mean_rows(u.task_vectors.to(self.device))
                             for u in uploads])
        sim = cosine_similarity_matrix(means).cpu().numpy()
        for g in greedy_group(sim, self.threshold):
            gv = mean_rows(means[torch.as_tensor(g, device=self.device)])
            for i in g:
                self.client_v[ids[i]] = gv
        for u in uploads:
            for t in u.task_ids:
                if u.client_id not in self.holders[t]:
                    self.holders[t].append(u.client_id)

    def eval_vectors(self, task_id: int) -> List[torch.Tensor]:
        out = [self.client_v[c] for c in self.holders[task_id]
               if c in self.client_v]
        return out or [self._zeros()]


STRATEGIES = {
    "matu": MaTUStrategy,
    "fedavg": FedAvgStrategy,
    "fedprox": FedProxStrategy,
    "ntk-fedavg": NTKFedAvgStrategy,
    "ties": TIESStrategy,
    "fedper": FedPerStrategy,
    "mat-fl": MaTFLStrategy,
}
