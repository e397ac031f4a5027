"""Batched MaTU round engine (paper §3.2, Eq. 3–7) on the packed wire.

    pack  →  Eq. 3+4 batched agreement/merge  →  Eq. 5 sign similarity
          →  Eq. 6+7 cross-task transfer      →  batched downlink
             re-unification (fused unify + mask + λ kernel)

All tensor math dispatches through
:func:`repro_torch.kernels.ops.matu_round_slots_packed`: the three
hand-written CUDA kernels on a CUDA device, their plain versions on the
CPU.

Padding contract (the JAX package's, unchanged)
-----------------------------------------------
* client axis: a round's ragged uploads are rows of fixed-shape slot
  tensors; padding rows have all-invalid slots.
* slot axis: each client's tasks occupy the first k_n of ``k_max``
  slots (next power of two ≥ max k_n); invalid slots carry zero masks /
  λ / sizes and the sentinel task id T, which the dense scatter drops
  and the downlink gather clamps (the valid mask zeroes its output).
* task axis: always the registry size T.  Tasks with no member this
  round give τ̂ = 0 and alpha_num = 0 and are masked out of the
  similarity, so cross-task transfer never mixes in zero vectors.

Wire format
-----------
* masks travel as packed words ``(n, k_max, ceil(d/32))``, LSB-first,
  zero tail bits (``repro_torch.kernels.bitpack``), stored as int32 bit
  patterns and byte-identical to the JAX package's uint32 words;
* unified / downlink vectors travel bf16; every sign decision and λ is
  computed on fp32 values before the bf16 rounding;
* m̂ is not materialised: the engine returns the exact Eq. 3 agreement
  numerator at one byte per coordinate and ``EngineOutput.m_hats``
  re-derives m̂ with the same fp32 division the round used.

The engine never sees a model, only d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.client import ClientDownlink, ClientUpload
from repro_torch.kernels import bitpack, ops
from repro_torch.kernels.ref import next_pow2

RHO_DEFAULT = 0.4     # Eq. 3 threshold
EPS_DEFAULT = 0.5     # Eq. 6 similarity filter
KAPPA_DEFAULT = 3     # Eq. 6 top-κ


@dataclass(frozen=True)
class EngineConfig:
    n_tasks: int
    rho: float = RHO_DEFAULT
    eps: float = EPS_DEFAULT
    kappa: int = KAPPA_DEFAULT
    cross_task: bool = True
    uniform_cross: bool = False


@dataclass
class PackedRound:
    """Fixed-shape slot tensors of one round + host-side metadata."""
    client_ids: List[int]            # actual clients, row order
    task_ids: List[List[int]]        # per client, slot order
    unified: torch.Tensor            # (n, d) bf16
    slot_masks: torch.Tensor         # (n, k_max, ceil(d/32)) int32 words
    slot_lams: torch.Tensor          # (n, k_max) fp32
    slot_sizes: torch.Tensor         # (n, k_max) fp32
    slot_tasks: torch.Tensor         # (n, k_max) int32; T = invalid sentinel
    slot_valid: torch.Tensor         # (n, k_max) bool
    n_tasks: int
    d: int

    @property
    def n_clients(self) -> int:
        return len(self.client_ids)

    def wire_bits(self) -> int:
        """Measured uplink size of the real slots: bf16 unified + packed
        mask words + fp32 λ per slot."""
        return sum(bitpack.wire_bits(
            self.d, len(t), vec_bytes_per_elem=self.unified.element_size())
            for t in self.task_ids)

    def to(self, device: torch.device) -> "PackedRound":
        """The same round with its tensors on ``device``."""
        mv = lambda x: x.to(device)  # noqa: E731
        return PackedRound(self.client_ids, self.task_ids, mv(self.unified),
                           mv(self.slot_masks), mv(self.slot_lams),
                           mv(self.slot_sizes), mv(self.slot_tasks),
                           mv(self.slot_valid), self.n_tasks, self.d)


class EngineOutput(NamedTuple):
    """Round results.  m̂ is re-derived from the exact agreement
    numerator via the ``m_hats`` property."""
    task_vectors: torch.Tensor       # (T, d) τ^{t,r+1} fp32
    tau_hats: torch.Tensor           # (T, d) fp32
    similarity: torch.Tensor         # (T, T), held-masked
    down_unified: torch.Tensor       # (n, d) bf16
    down_masks: torch.Tensor         # (n, k_max, ceil(d/32)) int32
    down_lams: torch.Tensor          # (n, k_max)
    alpha_num: torch.Tensor          # (T, d) uint8 — |Σ sgn(m⊙τ)|
    n_held: torch.Tensor             # (T,) fp32 member counts
    rho: float = RHO_DEFAULT

    @property
    def m_hats(self) -> torch.Tensor:
        """Eq. 3 averaged task masks m̂ (T, d) fp32, bit for bit the
        value the round used."""
        alpha = (self.alpha_num.float()
                 / torch.clamp(self.n_held, min=1.0)[:, None])
        return torch.where(alpha >= self.rho, 1.0, alpha)


def pack_uploads(uploads: Sequence[ClientUpload], n_tasks: int, *,
                 k_max: Optional[int] = None,
                 device: DeviceLike = "cuda") -> PackedRound:
    """Pack a ragged round of uploads into the slot layout on ``device``.
    Dense bool masks are bit-packed and the unified vectors rounded to
    bf16 here — the uplink quantisation, applied once at the wire."""
    if not uploads:
        raise ValueError("pack_uploads: empty round (no uploads)")
    dev = resolve_device(device)
    n = len(uploads)
    d = int(uploads[0].unified.shape[0])
    k_max = k_max or next_pow2(max(len(u.task_ids) for u in uploads))
    dw = bitpack.packed_width(d)
    unified = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
    slot_masks = torch.zeros((n, k_max, dw), dtype=torch.int32, device=dev)
    slot_lams = np.zeros((n, k_max), np.float32)
    slot_sizes = np.zeros((n, k_max), np.float32)
    slot_tasks = np.full((n, k_max), n_tasks, np.int32)
    slot_valid = np.zeros((n, k_max), bool)
    for i, up in enumerate(uploads):
        k = len(up.task_ids)
        unified[i] = up.unified.to(dev, torch.bfloat16)
        m = up.masks.to(dev)
        slot_masks[i, :k] = m if up.packed else bitpack.pack_bits(m)
        slot_lams[i, :k] = up.lams.detach().float().cpu().numpy()
        slot_sizes[i, :k] = up.data_sizes
        slot_tasks[i, :k] = up.task_ids
        slot_valid[i, :k] = True
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return PackedRound([u.client_id for u in uploads],
                       [list(u.task_ids) for u in uploads],
                       unified, slot_masks, t(slot_lams), t(slot_sizes),
                       t(slot_tasks), t(slot_valid), n_tasks, d)


def pack_from_slots(client_ids: List[int], task_ids: List[List[int]],
                    unified: torch.Tensor, slot_masks: torch.Tensor,
                    slot_lams: torch.Tensor, slot_tasks: torch.Tensor,
                    slot_valid: torch.Tensor, slot_sizes: torch.Tensor,
                    n_tasks: int, *, d: Optional[int] = None) -> PackedRound:
    """Build a PackedRound from already-batched slot tensors (the
    strategy's path: ``batched_client_unify`` output) — no copies."""
    if slot_masks.dtype != torch.int32:
        raise ValueError(f"slot_masks must be packed int32 words, got "
                         f"{slot_masks.dtype}")
    d = d or int(unified.shape[-1])
    if int(unified.shape[-1]) != d:
        raise ValueError(f"unified width {unified.shape[-1]} != d={d}")
    return PackedRound(list(client_ids), [list(t) for t in task_ids],
                       unified, slot_masks, slot_lams.float(),
                       slot_sizes.float(), slot_tasks.to(torch.int32),
                       slot_valid.bool(), n_tasks, d)


def _assemble_downlinks(client_ids: List[int], task_ids: List[List[int]],
                        down_unified: torch.Tensor, down_masks: torch.Tensor,
                        down_lams: torch.Tensor) -> Dict[int, ClientDownlink]:
    """Slice the batched downlink tensors back to ragged per-client
    ClientDownlinks (views; mask rows stay packed words)."""
    return {cid: ClientDownlink(down_unified[i], down_masks[i, :len(ts)],
                                down_lams[i, :len(ts)])
            for i, (cid, ts) in enumerate(zip(client_ids, task_ids))}


class RoundEngine:
    """Stateless per-round executor on one device."""

    def __init__(self, cfg: EngineConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def run_packed(self, packed: PackedRound, *,
                   mode: Optional[str] = None) -> EngineOutput:
        """Eq. 3–7 + downlink re-unification over a packed round (moved
        to the engine's device if it is elsewhere).  ``mode="ref"`` runs
        the plain versions of the kernels."""
        p = packed.to(self.device)
        cfg = self.cfg
        (tv, tau, a_num, n_held, sim, du, dm, dl) = ops.matu_round_slots_packed(
            p.unified, p.slot_masks, p.slot_lams, p.slot_sizes, p.slot_valid,
            p.slot_tasks, cfg.n_tasks, p.d, rho=cfg.rho, eps=cfg.eps,
            kappa=cfg.kappa, cross_task=cfg.cross_task,
            uniform_cross=cfg.uniform_cross, mode=mode)
        return EngineOutput(tv, tau, sim, du, dm, dl, alpha_num=a_num,
                            n_held=n_held, rho=cfg.rho)

    def downlinks(self, packed: PackedRound,
                  out: EngineOutput) -> Dict[int, ClientDownlink]:
        """Per-client downlinks of a finished round."""
        return _assemble_downlinks(packed.client_ids, packed.task_ids,
                                   out.down_unified, out.down_masks,
                                   out.down_lams)

    def round(self, uploads: Sequence[ClientUpload], *,
              mode: Optional[str] = None
              ) -> Tuple[Dict[int, ClientDownlink], EngineOutput]:
        """Pack → run → per-client downlinks."""
        batch = pack_uploads(uploads, self.cfg.n_tasks, device=self.device)
        out = self.run_packed(batch, mode=mode)
        return self.downlinks(batch, out), out


def batched_client_unify(task_vectors: torch.Tensor, valid: torch.Tensor, *,
                         device: DeviceLike = "cuda",
                         mode: Optional[str] = None):
    """All clients' upload construction in one fused call on ``device``.

    task_vectors (N, k_max, d) zero-padded stacks; valid (N, k_max).
    Returns the uplink wire format: (unified (N, d) bf16, mask_words
    (N, k_max, ceil(d/32)) int32, lams (N, k_max) fp32) — row n is
    ``unify_with_modulators(task_vectors[n, valid[n]])`` with the
    unified vector rounded to bf16 after masks and λ were derived from
    it in fp32."""
    dev = resolve_device(device)
    return ops.fused_unify_packed(task_vectors.to(dev), valid.to(dev),
                                  mode=mode)
