"""MaTU stateless server (paper §3.2 "Many-tasks Aggregation").

The server keeps no client state across rounds: it consumes the round's
uploads, runs Eq. 3–7 through :class:`~repro_torch.core.engine.
RoundEngine`, and emits per-client downlinks.  The task registry size
is the only global it needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.common.device import DeviceLike
from repro_torch.core.client import ClientDownlink, ClientUpload
from repro_torch.core.engine import (EPS_DEFAULT, KAPPA_DEFAULT, RHO_DEFAULT,
                                     EngineConfig, EngineOutput, PackedRound,
                                     RoundEngine)
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
    def __init__(self, cfg: MaTUServerConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.engine = RoundEngine(EngineConfig(
            n_tasks=cfg.n_tasks, rho=cfg.rho, eps=cfg.eps, kappa=cfg.kappa,
            cross_task=cfg.cross_task, uniform_cross=cfg.uniform_cross),
            device=device)
        self.last_similarity: Optional[torch.Tensor] = None
        self.last_task_vectors: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def round(self, uploads: List[ClientUpload]) -> Dict[int, ClientDownlink]:
        """One server step over ragged uploads."""
        downs, out = self.engine.round(uploads)
        self._record(out)
        return downs

    def round_packed(self, packed: PackedRound) -> Dict[int, ClientDownlink]:
        """Server step over an already-packed batch."""
        return self.finish_round(packed, self.start_round(packed))

    def start_round(self, packed: PackedRound) -> EngineOutput:
        """Run the round (kernel launches are asynchronous on the card);
        pair with :meth:`finish_round` for the downlinks."""
        out = self.engine.run_packed(packed)
        self._record(out)
        return out

    def finish_round(self, packed: PackedRound,
                     out: EngineOutput) -> Dict[int, ClientDownlink]:
        """Per-client downlinks of a dispatched round."""
        return self.engine.downlinks(packed, out)

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
        masks.  ``fingerprint`` stamps the layout manifest the task
        vectors were flattened through, so the store can verify the
        handoff.  ``code_masks`` (the entropy-coded wire) raises: the
        coded wire is not ported yet."""
        if code_masks:
            raise NotImplementedError("the entropy-coded mask wire is not "
                                      "ported yet (ROADMAP §1)")
        if self.last_task_vectors is None:
            raise ValueError("serving_downlink needs a completed round "
                             "(no task vectors recorded yet)")
        unified, masks, lams = unify_with_modulators(self.last_task_vectors)
        if packed:
            return ClientDownlink(unified.to(torch.bfloat16),
                                  bitpack.pack_bits(masks), lams,
                                  fingerprint=fingerprint)
        return ClientDownlink(unified, masks, lams, fingerprint=fingerprint)
