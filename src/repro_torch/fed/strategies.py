"""Federated aggregation strategies: MaTU (on the packed or the
entropy-coded wire, its round optionally left in flight by the deferred
drain), the async MaTU server step (staleness-weighted slots, the
validating decode with quarantine, carried per-task vectors) and the
paper's baselines (Tables 1–2): FedAvg, FedProx, NTK-FedAvg, TIES,
FedPer and MaT-FL.

The simulator calls, per round:
  ``task_init(client, task)``       → τ to start local training from
  ``aggregate_batch(batch)``        → server step (strategy state)
  ``eval_vectors(task)``            → τ to evaluate for a task
  ``uplink_bits(uploads)``          → communicated bits this round
  ``downlink_bits()``               → measured downlink bits this round
  ``skip_round()``                  → in place of the server step when a
                                      round admits no upload

Each strategy decides what is transmitted (MaTU: one unified vector +
modulators; the others: per-task adapters), and the uplink accounting
follows it.  ``needs_prox`` / ``needs_linearize`` tell the simulator to
train with FedProx's proximal term or NTK-FedAvg's linearised model.
Every strategy keeps its state on its ``device``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import TaskVectorLayoutError
from repro_torch.core.baselines import (cosine_similarity_matrix,
                                        greedy_group, mean_rows, ties_merge,
                                        weighted_average)
from repro_torch.core.client import ClientDownlink, ClientUpload, paper_link_bits
from repro_torch.core.engine import (STALENESS_DISCOUNT, batched_client_unify,
                                     gather_cols, host_copy_async,
                                     pack_from_slots, ready_mark,
                                     split_streams, staleness_weights,
                                     valid_rows, wait_ready)
from repro_torch.core.server import MaTUServer, MaTUServerConfig
from repro_torch.core.unify import modulate, unify
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
    # host / device µs of the most recently COMPLETED server round
    # ({"pack"/"decode"/"encode"/"device"} where measured); None for
    # strategies that measure nothing
    last_phase_us: Optional[Dict[str, float]] = None

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

    def use_pipeline(self, on: bool) -> None:
        """Enable the deferred drain where the strategy has one (MaTU);
        a no-op for per-client strategies."""

    def use_mesh(self, mesh) -> None:
        """Install a taskvec mesh where the server step can run sharded
        (MaTU's round engine); a no-op for per-client strategies."""

    def skip_round(self) -> None:
        """Called INSTEAD of the server step when a round admits no
        upload: carry every state unchanged.  A no-op for strategies
        whose state is per round already."""

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
    """MaTU on the packed wire: one fused kernel call builds every
    client's upload (bf16 unified + packed mask words), the round engine
    runs Eq. 3–7 + downlink re-unification, and the downlinks seed the
    next round's ``task_init``.  Wire bits are measured off the buffers
    the engine computes on.

    ``code_masks`` ships the Golomb-Rice wire both ways
    (:mod:`repro_torch.fed.compression`): the uplink streams encode the
    very words the engine computes on, in one batched call; the
    downlinks are encoded in one batched call and decoded by the
    clients on use; bits are measured off the streams.  ``compress``
    is accounting only: the uplink bits become the coder's measured size
    for masks that travelled as raw packed words.

    ``pipeline`` (the deferred drain) leaves the round in flight when
    ``aggregate_batch`` returns; it is drained (waited for, its
    downlinks built) when first needed: the next ``task_init``,
    ``downlink_bits`` or server step.  The same operations in another
    order, so bit-identical to ``pipeline=False``.

    ``chunk_clients`` routes the server step through the engine's chunked
    round (``MaTUServer.round_chunked``), so its slot tensors hold
    ``chunk_clients`` clients instead of the round's N: the
    population-scale engine path under the regular simulator.  The
    uploads are the batched path's own wire buffers (one kernel-1 call),
    so it is bit-identical to the batched path.  It is synchronous
    (phase C streams the downlinks out chunk by chunk, so there is no
    deferred drain), also under ``pipeline``.  With ``code_masks`` both
    ways ship coded, as on the batched path (the JAX package's chunked
    step keeps a raw uplink); the engine decodes each chunk's streams as
    it packs them.

    ``mesh`` (or :meth:`use_mesh`) shards the server step over a taskvec
    mesh, this process being one rank (``repro_torch.launch.mesh``):
    client unify and the round run on the rank's d-slice, and the
    uplink record and the downlinks are gathered whole at the wire
    boundary.  Every rank runs the same strategy on the same uploads."""
    name = "matu"

    def __init__(self, n_tasks: int, d: int, *, rho: float = 0.4,
                 eps: float = 0.5, kappa: int = 3, cross_task: bool = True,
                 uniform_cross: bool = False, compress: bool = False,
                 code_masks: bool = False, pipeline: bool = False,
                 chunk_clients: Optional[int] = None,
                 device: DeviceLike = "cuda", mesh=None):
        super().__init__(n_tasks, d, device)
        self.chunk_clients = chunk_clients
        self.mesh = mesh
        self.server = MaTUServer(MaTUServerConfig(
            n_tasks=n_tasks, rho=rho, eps=eps, kappa=kappa,
            cross_task=cross_task, uniform_cross=uniform_cross),
            device=self.device, mesh=mesh)
        self.downlinks: Dict[int, ClientDownlink] = {}
        self.client_tasks: Dict[int, List[int]] = {}
        self.code_masks = code_masks
        self.compress = compress
        self.pipeline = pipeline
        # (packed, out, phase_us, dispatch time, ready mark) of the round
        # in flight
        self._pending = None
        self._last_uploads: List[ClientUpload] = []

    def use_pipeline(self, on: bool) -> None:
        """Toggle the deferred drain (draining any round in flight
        first, so toggling between rounds is safe)."""
        self._drain()
        self.pipeline = on

    def use_mesh(self, mesh) -> None:
        """Shard the server step over the taskvec axis of ``mesh`` (None
        restores the single-device path), draining any round in flight
        first."""
        self._drain()
        self.mesh = mesh
        self.server.use_mesh(mesh)

    def _unify(self, batch: RoundBatch, whole: bool = False):
        """Kernel 1 over every client (on a mesh, on this rank's
        d-slice): (unified, mask words, λ) as the round takes them, and
        the uplink wire's (unified, mask words).  On a mesh the wire's
        words are gathered whole only where their bits are read
        (``code_masks``, ``compress``) and its vectors only when
        ``whole`` asks; otherwise they are meta tensors of the wire's
        shapes, all that the bit accounting reads."""
        unified, mask_words, lams = batched_client_unify(
            batch.task_vectors, batch.valid, device=self.device,
            mesh=self.mesh)
        lay = self.server.engine.layout
        if self.server.engine.n_shards == 1:
            return unified, mask_words, lams, unified, mask_words
        if whole:
            wire_uni = gather_cols(unified, lay, self.d)
        else:
            wire_uni = torch.empty((unified.shape[0], self.d),
                                   dtype=unified.dtype, device="meta")
        if whole or self.code_masks or self.compress:
            wire_words = gather_cols(mask_words, lay, self.d, words=True)
        else:
            wire_words = torch.empty(
                mask_words.shape[:-1] + (bitpack.packed_width(self.d),),
                dtype=mask_words.dtype, device="meta")
        return unified, mask_words, lams, wire_uni, wire_words

    def _drain(self) -> None:
        """Finish the round in flight, if any: wait for its ready point,
        build (and under ``code_masks`` encode) its downlinks, record its
        phases."""
        if self._pending is None:
            return
        packed, out, phase, t_disp, mark = self._pending
        self._pending = None
        wait_ready(mark)
        phase["device"] = (time.perf_counter() - t_disp) * 1e6
        self.downlinks.update(self.server.finish_round(
            packed, out, code_masks=self.code_masks, phase_us=phase))
        self.last_phase_us = phase

    def _dispatch(self, packed, phase: Dict[str, float], t0: float):
        """Start the engine round over ``packed``; it stays pending until
        :meth:`_drain`."""
        out = self.server.start_round(packed)
        t_disp = time.perf_counter()
        self._pending = (packed, out, phase, t_disp, ready_mark(self.device))
        phase["pack"] = (t_disp - t0) * 1e6

    def _coded_uplink(self, words: torch.Tensor, mark,
                      ks: List[int]) -> List[torch.Tensor]:
        """Every client's word rows, the bytes the engine computes on,
        entropy-coded in ONE batched call and split back per client by
        the record sizes.  ``words`` may be a pending host copy, ready at
        ``mark``."""
        from repro_torch.fed.compression import encode_mask_rows_with_sizes
        wait_ready(mark)
        return split_streams(*encode_mask_rows_with_sizes(
            valid_rows(bitpack.words_to_numpy(words), ks), self.d), ks)

    def task_init(self, client_id: int, task_id: int) -> torch.Tensor:
        self._drain()
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
        if self.chunk_clients:
            self._aggregate_chunked(batch)
            return
        self._drain()
        phase: Dict[str, float] = {}
        t0 = time.perf_counter()
        unified, mask_words, lams, wire_uni, wire_words = self._unify(batch)
        words = words_mark = None
        if self.code_masks:
            # the uplink's words go to the host ahead of the round's
            # launches, so their encode below overlaps the round
            words = host_copy_async(wire_words)
            words_mark = ready_mark(self.device)
        packed = pack_from_slots(batch.client_ids, batch.task_ids, unified,
                                 mask_words, lams,
                                 batch.slot_tasks.to(self.device),
                                 batch.valid.to(self.device),
                                 batch.slot_sizes.to(self.device),
                                 self.n_tasks, d=self.d, mesh=self.mesh)
        self._dispatch(packed, phase, t0)
        ks = [len(u.task_ids) for u in batch.uploads]
        if self.code_masks:
            t1 = time.perf_counter()
            up_masks = self._coded_uplink(words, words_mark, ks)
            phase["encode"] = (time.perf_counter() - t1) * 1e6
        else:
            up_masks = [wire_words[i, :k] for i, k in enumerate(ks)]
        self._last_uploads = [
            ClientUpload(u.client_id, list(u.task_ids), wire_uni[i],
                         up_masks[i], lams[i, :k], list(u.data_sizes))
            for i, (u, k) in enumerate(zip(batch.uploads, ks))]
        for u in batch.uploads:
            self.client_tasks[u.client_id] = list(u.task_ids)
        if not self.pipeline:
            self._drain()

    def _aggregate_chunked(self, batch: RoundBatch) -> None:
        """The chunked server step: the batched path's wire buffers (one
        kernel-1 call over every client: the same bf16 rounding and mask
        words, coded in one batched call under ``code_masks``) streamed
        through ``MaTUServer.round_chunked``, so the engine never holds
        the round's O(N·k_max·d/32) slot tensors."""
        self._drain()
        phase: Dict[str, float] = {}
        t0 = time.perf_counter()
        _, _, lams, unified, mask_words = self._unify(batch, whole=True)
        ks = [len(u.task_ids) for u in batch.uploads]
        if self.code_masks:
            t1 = time.perf_counter()
            up_masks = self._coded_uplink(mask_words, None, ks)
            phase["encode"] = (time.perf_counter() - t1) * 1e6
        else:
            up_masks = [mask_words[i, :k] for i, k in enumerate(ks)]
        ups = [ClientUpload(u.client_id, list(u.task_ids), unified[i],
                            up_masks[i], lams[i, :k], list(u.data_sizes))
               for i, (u, k) in enumerate(zip(batch.uploads, ks))]
        for u in batch.uploads:
            self.client_tasks[u.client_id] = list(u.task_ids)
        phase["pack"] = (time.perf_counter() - t0) * 1e6
        t1 = time.perf_counter()
        downs, _ = self.server.round_chunked(
            ups, chunk_clients=self.chunk_clients,
            code_masks=self.code_masks, phase_us=phase)
        phase["device"] = (time.perf_counter() - t1) * 1e6
        self.downlinks.update(downs)
        self._last_uploads = ups
        self.last_phase_us = phase

    def skip_round(self) -> None:
        """An empty round: drain the round in flight, then clear the
        round's wire accounting (``uplink_bits`` / ``downlink_bits``
        report 0).  Task vectors, similarity and every client's downlink
        stay as the last aggregated round left them."""
        self._drain()
        self._last_uploads = []
        self.last_phase_us = {}

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
        """Measured downlink wire bits of the clients served last round
        (a quarantined client is not served)."""
        self._drain()
        return sum(self.downlinks[u.client_id].downlink_bits()
                   for u in self._last_uploads
                   if u.client_id in self.downlinks)


class AsyncMaTUStrategy(MaTUStrategy):
    """The buffered, staleness-aware, fault-tolerant MaTU server step of
    the simulator's event-clock mode (``FedSimulator(..., systems=)``):

    * **staleness-weighted slots** — an admitted upload dispatched at
      round q and folded at round r has staleness ``s = r − q``; its
      slots enter the round with weight ``staleness_discount**s``
      (``PackedRound.slot_weights``: λ·w and size·w).  ``s = 0`` is
      bitwise the synchronous round, so under an ideal trace async ≡
      sync bit for bit.
    * **validating decode + quarantine** — when the trace can corrupt
      (``systems.injects_corruption``), each client's coded stream is
      CRC-framed (``fed.systems.wrap_stream``), tampered as the trace
      says, then validated (frame, then the full entropy decode); an
      upload raising ``WireFrameError`` or ``CodedStreamError`` is left
      out of the round (its client in ``last_quarantined``; its bytes
      still count as uplink traffic).
    * **carried per-task vectors** — a task aggregated this round takes
      the round's vector bitwise (age 0); a dark task ages, and one seen
      before decays toward the unified vector of the seen tasks,
      ``τ_t ← (1 − β)·τ_t + β·unify(seen τ)`` (β = ``dark_decay``), so
      ``eval_vectors`` and ``similarity`` stay well posed through dark
      spells.  They live on the strategy's device.
    * **skip-and-carry** — an empty or all-quarantined round ages the
      tasks and carries every other state.
    """
    name = "matu-async"

    def __init__(self, n_tasks: int, d: int, *,
                 staleness_discount: float = STALENESS_DISCOUNT,
                 dark_decay: float = 0.25, **kw):
        super().__init__(n_tasks, d, **kw)
        self.staleness_discount = float(staleness_discount)
        self.dark_decay = float(dark_decay)
        # rounds since each task was last aggregated (0 = this round)
        self.task_age = np.zeros(n_tasks, np.int64)
        self._task_seen = np.zeros(n_tasks, bool)
        self._task_vecs = torch.zeros((n_tasks, d), dtype=torch.float32,
                                      device=self.device)
        self.last_quarantined: frozenset = frozenset()

    def _age_and_decay(self, held, decay: bool = True) -> None:
        """Refresh the ages of ``held`` tasks; age every dark task and
        pull the ever-seen dark ones toward the unified vector of the
        seen tasks.  ``decay=False`` (no engine round ran) only ages.
        Rows are indexed one by one with host ints: an index tensor would
        be a host-to-device copy, which waits for the round in flight."""
        dark = np.ones(self.n_tasks, bool)
        if held:
            held_idx = np.asarray(sorted(held), np.int64)
            dark[held_idx] = False
            self.task_age[held_idx] = 0
            self._task_seen[held_idx] = True
        self.task_age[dark] += 1
        if not decay:
            return
        decay_idx = np.flatnonzero(dark & self._task_seen)
        if decay_idx.size:
            u = unify(torch.stack([self._task_vecs[int(t)] for t in
                                   np.flatnonzero(self._task_seen)]))
            beta = self.dark_decay
            for t in decay_idx.tolist():
                self._task_vecs[t] = ((1.0 - beta) * self._task_vecs[t]
                                      + beta * u)

    @property
    def similarity(self) -> np.ndarray:
        """Eq. 5 sign similarity of the carried task vectors, on the host
        (reading it is the only wait): rows of dark tasks follow their
        decayed vectors; never-seen tasks are masked out."""
        v = self._task_vecs.cpu().numpy()
        sgn = np.sign(v)
        sim = 0.5 * ((sgn @ sgn.T) / max(v.shape[1], 1) + 1.0)
        seen = self._task_seen.astype(np.float32)
        return (sim * seen[None, :] * seen[:, None]).astype(np.float32)

    def eval_vectors(self, task_id: int) -> List[torch.Tensor]:
        return [self._task_vecs[task_id]]

    def skip_round(self) -> None:
        super().skip_round()
        self.last_quarantined = frozenset()
        self._age_and_decay(set(), decay=False)

    def aggregate_batch(self, batch: RoundBatch) -> None:
        self.aggregate_admitted(batch, [0] * len(batch.uploads))

    def aggregate_admitted(self, batch: RoundBatch, staleness: List[int],
                           systems=None,
                           dispatch_rounds: Optional[List[int]] = None
                           ) -> int:
        """Server step over the admission queue's drain: validate (and
        maybe quarantine) each upload, then run the round over the rest
        with the staleness-weighted slots.  Returns the number of uploads
        aggregated (0 when all were quarantined: no round runs)."""
        self.verify_layouts(batch.uploads)
        self._drain()
        inject = (systems is not None and systems.injects_corruption
                  and dispatch_rounds is not None)
        if inject and not self.code_masks:
            raise ValueError("wire fault injection (corrupt_prob > 0) "
                             "tampers the CODED mask streams — construct "
                             "AsyncMaTUStrategy(code_masks=True)")
        phase: Dict[str, float] = {}
        t0 = time.perf_counter()
        unified, mask_words, lams, wire_uni, wire_words = self._unify(batch)
        ks = [len(u.task_ids) for u in batch.uploads]
        quarantined: List[int] = []
        if self.code_masks:
            t1 = time.perf_counter()
            streams = self._coded_uplink(wire_words, None, ks)
            phase["encode"] = (time.perf_counter() - t1) * 1e6
            if inject:
                from repro_torch.fed.compression import (CodedStreamError,
                                                         decode_mask_rows)
                from repro_torch.fed.systems import (WireFrameError,
                                                     unwrap_stream,
                                                     wrap_stream)
                framed = [wrap_stream(st.numpy()) for st in streams]
                for i, u in enumerate(batch.uploads):
                    if systems.corrupt(u.client_id, dispatch_rounds[i]):
                        framed[i] = systems.tamper(framed[i], u.client_id,
                                                   dispatch_rounds[i])
                # the validating decode: the CRC frame, then the full
                # entropy decode; a malformed upload never reaches the
                # slot tensors
                for i, k in enumerate(ks):
                    try:
                        decode_mask_rows(unwrap_stream(framed[i]), self.d, k)
                    except (WireFrameError, CodedStreamError):
                        quarantined.append(i)
                streams = [torch.from_numpy(f) for f in framed]
            up_masks = streams
        else:
            up_masks = [wire_words[i, :k] for i, k in enumerate(ks)]
        # the wire accounting covers every admitted upload, quarantined
        # ones too (their bytes travelled), framed under fault injection
        self._last_uploads = [
            ClientUpload(u.client_id, list(u.task_ids), wire_uni[i],
                         up_masks[i], lams[i, :k], list(u.data_sizes))
            for i, (u, k) in enumerate(zip(batch.uploads, ks))]
        self.last_quarantined = frozenset(
            batch.uploads[i].client_id for i in quarantined)

        keep = [i for i in range(len(ks)) if i not in set(quarantined)]
        if not keep:
            # everything admitted was malformed: no round runs, carry
            self.last_phase_us = phase
            self._age_and_decay(set(), decay=False)
            return 0
        tasks = batch.slot_tasks.to(self.device)
        valid = batch.valid.to(self.device)
        sizes = batch.slot_sizes.to(self.device)
        if quarantined:
            sel = torch.as_tensor(keep, dtype=torch.long, device=self.device)
            unified, mask_words, lams, tasks, valid, sizes = (
                x[sel] for x in (unified, mask_words, lams, tasks, valid,
                                 sizes))
        stale = [int(staleness[i]) for i in keep]
        slot_weights = None
        if any(stale):
            slot_weights = torch.from_numpy(staleness_weights(
                stale, batch.k_max, self.staleness_discount)).to(self.device)
        packed = pack_from_slots([batch.client_ids[i] for i in keep],
                                 [batch.task_ids[i] for i in keep], unified,
                                 mask_words, lams, tasks, valid, sizes,
                                 self.n_tasks, d=self.d,
                                 slot_weights=slot_weights, mesh=self.mesh)
        self._dispatch(packed, phase, t0)
        phase["pack"] -= phase.get("encode", 0.0)
        for i in keep:
            u = batch.uploads[i]
            self.client_tasks[u.client_id] = list(u.task_ids)
        # carried per-task state: held tasks take the round's vectors,
        # dark ones age and decay
        held = {t for i in keep for t in batch.task_ids[i]}
        for t in sorted(held):
            self._task_vecs[t] = self.server.last_task_vectors[t]
        self._age_and_decay(held)
        if not self.pipeline:
            self._drain()
        return len(keep)


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
    "matu-async": AsyncMaTUStrategy,
    "fedavg": FedAvgStrategy,
    "fedprox": FedProxStrategy,
    "ntk-fedavg": NTKFedAvgStrategy,
    "ties": TIESStrategy,
    "fedper": FedPerStrategy,
    "mat-fl": MaTFLStrategy,
}
