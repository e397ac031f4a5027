"""MaTU stateless server (paper §3.2 "Many-tasks Aggregation").

The server keeps no client state across rounds: it consumes the round's
uploads, runs Eq. 3–7 through :class:`~repro_torch.core.engine.
RoundEngine`, and emits per-client downlinks.  The task registry size
is the only global it needs.

``round_chunked`` streams a round through the engine's chunk buffer
(the population-scale path).  ``round_legacy`` is the original per-task
loop over :mod:`repro_torch.core.aggregation`, sharing no code with the
engine: the oracle both engine paths are held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.common.device import DeviceLike
from repro_torch.core.aggregation import (combine_round,
                                          cross_task_aggregate,
                                          sign_similarity, task_aggregate,
                                          transfer_weights)
from repro_torch.core.client import ClientDownlink, ClientUpload
from repro_torch.core.engine import (EPS_DEFAULT, KAPPA_DEFAULT, RHO_DEFAULT,
                                     EngineConfig, EngineOutput, PackedRound,
                                     RoundEngine, gather_cols)
from repro_torch.core.unify import unify_with_modulators
from repro_torch.kernels import bitpack


@dataclass
class MaTUServerConfig:
    n_tasks: int
    rho: float = RHO_DEFAULT
    eps: float = EPS_DEFAULT
    kappa: int = KAPPA_DEFAULT
    cross_task: bool = True
    uniform_cross: bool = False


class MaTUServer:
    def __init__(self, cfg: MaTUServerConfig, device: DeviceLike = "cuda",
                 mesh=None):
        """``mesh``: optional taskvec mesh (``repro_torch.launch.mesh``);
        the rounds then run sharded over it, one rank each (the engine's
        "Sharding contract"); None keeps the single-device path."""
        self.cfg = cfg
        self.engine = RoundEngine(EngineConfig(
            n_tasks=cfg.n_tasks, rho=cfg.rho, eps=cfg.eps, kappa=cfg.kappa,
            cross_task=cfg.cross_task, uniform_cross=cfg.uniform_cross),
            device=device, mesh=mesh)
        self.last_similarity: Optional[torch.Tensor] = None
        self._task_vectors: Optional[torch.Tensor] = None
        # (this rank's task-vector slices, d) of a sharded round whose
        # vectors are not gathered yet
        self._tv_slices = None

    @property
    def last_task_vectors(self) -> Optional[torch.Tensor]:
        """The last round's (T, d) task vectors.  After a sharded
        :meth:`start_round` they are gathered whole by
        :meth:`finish_round`, or here if read before it (every rank runs
        the same code, so every rank reads them at the same point)."""
        self._gather_task_vectors()
        return self._task_vectors

    @last_task_vectors.setter
    def last_task_vectors(self, tv: Optional[torch.Tensor]) -> None:
        self._tv_slices, self._task_vectors = None, tv

    def _gather_task_vectors(self) -> None:
        if self._tv_slices is not None:
            tv, d = self._tv_slices
            self._tv_slices = None
            self._task_vectors = gather_cols(tv, self.engine.layout, d)

    def use_mesh(self, mesh) -> None:
        """Install (or clear) the taskvec mesh on the round engine."""
        self.engine.use_mesh(mesh)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def round(self, uploads: List[ClientUpload], *,
              code_masks: bool = False) -> Dict[int, ClientDownlink]:
        """One server step over ragged uploads; ``code_masks`` emits
        entropy-coded downlink masks (coded uploads are decoded at pack
        time either way)."""
        downs, out = self.engine.round(uploads, code_masks=code_masks)
        self._record(out)
        return downs

    def round_chunked(self, uploads, *, chunk_clients: int,
                      code_masks: bool = False,
                      staleness: Optional[List[int]] = None,
                      k_max: Optional[int] = None, sink=None,
                      phase_us: Optional[Dict[str, float]] = None
                      ) -> Tuple[Dict[int, ClientDownlink], Dict[str, int]]:
        """Population-scale server step: stream ``uploads`` (a sequence
        or a zero-argument iterator factory) through the engine's chunk
        buffer of ``chunk_clients`` clients, bit for bit :meth:`round`
        (the engine's "Population-scale contract").  ``sink``, if given,
        receives each chunk's downlinks and the returned dict stays
        empty.  Returns ``(downlinks, stats)``, the measured wire bits in
        ``stats``."""
        downs, out, stats = self.engine.round_chunked(
            uploads, chunk_clients=chunk_clients, code_masks=code_masks,
            staleness=staleness, k_max=k_max, sink=sink, phase_us=phase_us)
        self._record(out)
        return downs, stats

    def round_packed(self, packed: PackedRound, *,
                     code_masks: bool = False) -> Dict[int, ClientDownlink]:
        """Server step over an already-packed batch."""
        return self.finish_round(packed, self.start_round(packed),
                                 code_masks=code_masks)

    def start_round(self, packed: PackedRound) -> EngineOutput:
        """Run the round (kernel launches are asynchronous on the card);
        pair with :meth:`finish_round` for the downlinks.  On a mesh the
        output holds this rank's slices, and nothing is gathered before
        :meth:`finish_round` (:attr:`last_task_vectors`)."""
        out = self.engine.run_packed(packed)
        self._record(out)
        if out.d_pad is not None:
            self._tv_slices = (out.task_vectors, packed.d)
        return out

    def finish_round(self, packed: PackedRound, out: EngineOutput, *,
                     code_masks: bool = False,
                     phase_us: Optional[Dict[str, float]] = None
                     ) -> Dict[int, ClientDownlink]:
        """Per-client downlinks of a dispatched round (one batched
        Golomb-Rice encode on the host when ``code_masks``; ``phase_us``
        accumulates its ``encode`` µs).  On a mesh the downlinks and the
        task vectors are gathered whole here, at the wire boundary."""
        downs = self.engine.downlinks(packed, out, code_masks=code_masks,
                                      phase_us=phase_us)
        self._gather_task_vectors()
        return downs

    def _record(self, out: EngineOutput) -> None:
        self.last_similarity = out.similarity
        self.last_task_vectors = out.task_vectors

    def serving_downlink(self, *, packed: bool = True,
                         code_masks: bool = False,
                         fingerprint: Optional[str] = None
                         ) -> ClientDownlink:
        """Serving handoff: re-unify the last round's full task-vector
        set into one all-tasks downlink for a
        :class:`repro_torch.serve.store.ModulatorStore` — row ``t`` of the
        modulators is task id ``t``.  ``packed`` ships the wire layout
        (bf16 unified + int32 mask words), else fp32 unified + bool
        masks; ``code_masks`` ships bf16 unified + the rows as one
        Golomb-Rice stream (a host uint8 tensor).  ``fingerprint`` stamps
        the layout manifest the task vectors were flattened through, so
        the store can verify the handoff."""
        if self.last_task_vectors is None:
            raise ValueError("serving_downlink needs a completed round "
                             "(no task vectors recorded yet)")
        unified, masks, lams = unify_with_modulators(self.last_task_vectors)
        if code_masks:
            from repro_torch.fed.compression import encode_mask_rows
            stream = encode_mask_rows(
                bitpack.words_to_numpy(bitpack.pack_bits(masks)),
                int(unified.shape[0]))
            return ClientDownlink(unified.to(torch.bfloat16),
                                  torch.from_numpy(stream), lams,
                                  fingerprint=fingerprint)
        if packed:
            return ClientDownlink(unified.to(torch.bfloat16),
                                  bitpack.pack_bits(masks), lams,
                                  fingerprint=fingerprint)
        return ClientDownlink(unified, masks, lams, fingerprint=fingerprint)

    def round_legacy(self, uploads: List[ClientUpload]
                     ) -> Dict[int, ClientDownlink]:
        """The per-task oracle of the engine: Eq. 3 + 4 task by task over
        the members' stacked rows (:func:`~repro_torch.core.aggregation.
        task_aggregate`), Eq. 5–7 over all tasks, then each client's
        downlink re-unified by ``unify_with_modulators`` (fp32 unified,
        bool masks).  It meets the engine to fp32 tolerance; an unheld
        task's m̂ is 1 here and 0 in the engine, which no output shows.
        Records the task vectors and the similarity as :meth:`round`
        does."""
        cfg, dev = self.cfg, self.device
        d = int(uploads[0].unified.shape[0])
        tau_hats = torch.zeros((cfg.n_tasks, d), dtype=torch.float32,
                               device=dev)
        m_hats = torch.ones((cfg.n_tasks, d), dtype=torch.float32,
                            device=dev)
        held = torch.zeros((cfg.n_tasks,), dtype=torch.bool, device=dev)
        for t in range(cfg.n_tasks):
            rows = [(up, up.task_ids.index(t)) for up in uploads
                    if t in up.task_ids]
            if not rows:
                continue
            held[t] = True
            unified = torch.stack([up.unified.to(dev, torch.float32)
                                   for up, _ in rows])
            masks = torch.stack([up.masks_dense()[i].to(dev)
                                 for up, i in rows])
            lams = torch.stack([up.lams[i].to(dev, torch.float32)
                                for up, i in rows])
            sizes = torch.tensor([float(up.data_sizes[i]) for up, i in rows],
                                 dtype=torch.float32, device=dev)
            member = torch.ones((len(rows),), dtype=torch.bool, device=dev)
            tau_hats[t], m_hats[t] = task_aggregate(unified, masks, lams,
                                                    member, sizes, cfg.rho)
        heldf = held.float()
        sim = sign_similarity(tau_hats) * heldf[None, :] * heldf[:, None]
        weights = transfer_weights(sim, held, eps=cfg.eps, kappa=cfg.kappa,
                                   cross_task=cfg.cross_task,
                                   uniform_cross=cfg.uniform_cross)
        tau_tildes = cross_task_aggregate(tau_hats, m_hats, weights)
        task_vectors = combine_round(tau_hats, tau_tildes, weights)
        self.last_similarity = sim
        self.last_task_vectors = task_vectors
        out: Dict[int, ClientDownlink] = {}
        for up in uploads:
            unified, masks, lams = unify_with_modulators(
                task_vectors[list(up.task_ids)])
            out[up.client_id] = ClientDownlink(unified, masks, lams)
        return out
