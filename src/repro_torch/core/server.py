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

    def round(self, uploads: List[ClientUpload], *,
              code_masks: bool = False) -> Dict[int, ClientDownlink]:
        """One server step over ragged uploads; ``code_masks`` emits
        entropy-coded downlink masks (coded uploads are decoded at pack
        time either way)."""
        downs, out = self.engine.round(uploads, code_masks=code_masks)
        self._record(out)
        return downs

    def round_packed(self, packed: PackedRound, *,
                     code_masks: bool = False) -> Dict[int, ClientDownlink]:
        """Server step over an already-packed batch."""
        return self.finish_round(packed, self.start_round(packed),
                                 code_masks=code_masks)

    def start_round(self, packed: PackedRound) -> EngineOutput:
        """Run the round (kernel launches are asynchronous on the card);
        pair with :meth:`finish_round` for the downlinks."""
        out = self.engine.run_packed(packed)
        self._record(out)
        return out

    def finish_round(self, packed: PackedRound, out: EngineOutput, *,
                     code_masks: bool = False) -> Dict[int, ClientDownlink]:
        """Per-client downlinks of a dispatched round (one batched
        Golomb-Rice encode on the host when ``code_masks``)."""
        return self.engine.downlinks(packed, out, code_masks=code_masks)

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
