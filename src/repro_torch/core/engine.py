"""Batched MaTU round engine (paper §3.2, Eq. 3–7), on the packed wire
or in the bool/fp32 A/B layout.

    pack  →  Eq. 3+4 batched agreement/merge  →  Eq. 5 sign similarity
          →  Eq. 6+7 cross-task transfer      →  batched downlink
             re-unification (fused unify + mask + λ kernel)

All tensor math dispatches through
:func:`repro_torch.kernels.ops.matu_round_slots_packed` (packed) or
:func:`repro_torch.kernels.ops.matu_round_slots` (bool/fp32): three
hand-written CUDA kernels per layout on a CUDA device, their plain
versions on the CPU.

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

Bool/fp32 A/B layout
--------------------
The paper's accounting scheme and the parity oracle of the wire: fp32
unified vectors, dense bool masks ``(n, k_max, d)``, fp32 downlinks and
an fp32 m̂.  On bf16-representable unified values and the same mask
bits it gives the packed round's outputs bit for bit (the packed bf16
downlink being the rounding of the fp32 one).

The engine never sees a model, only d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.client import (ClientDownlink, ClientUpload,
                                     paper_link_bits)
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
    """Fixed-shape slot tensors of one round + host-side metadata, in
    either layout (``packed``)."""
    client_ids: List[int]            # actual clients, row order
    task_ids: List[List[int]]        # per client, slot order
    unified: torch.Tensor            # (n, d) bf16 (wire) | fp32
    slot_masks: torch.Tensor         # (n, k_max, ceil(d/32)) int32 | (…, d) bool
    slot_lams: torch.Tensor          # (n, k_max) fp32
    slot_sizes: torch.Tensor         # (n, k_max) fp32
    slot_tasks: torch.Tensor         # (n, k_max) int32; T = invalid sentinel
    slot_valid: torch.Tensor         # (n, k_max) bool
    n_tasks: int
    d: int

    @property
    def n_clients(self) -> int:
        return len(self.client_ids)

    @property
    def packed(self) -> bool:
        """True when the slot tensors are in the wire layout."""
        return self.slot_masks.dtype == torch.int32

    def wire_bits(self) -> int:
        """Measured uplink size of the real slots (bf16 unified + packed
        mask words + fp32 λ per slot); for the bool layout the paper's
        32d + k(d + 32), the scheme those buffers implement."""
        if not self.packed:
            return sum(paper_link_bits(self.d, len(t)) for t in self.task_ids)
        return sum(bitpack.wire_bits(
            self.d, len(t), vec_bytes_per_elem=self.unified.element_size())
            for t in self.task_ids)

    def dense_tensors(self):
        """The dense per-task layout ``core.aggregation.matu_round``
        consumes: (masks (n, T, d) bool, lams, members, sizes (n, T))."""
        masks = (ops.unpack_masks(self.slot_masks, self.d) if self.packed
                 else self.slot_masks)
        return ops.slots_to_dense(masks, self.slot_lams, self.slot_sizes,
                                  self.slot_valid, self.slot_tasks,
                                  self.n_tasks)

    def to(self, device: torch.device) -> "PackedRound":
        """The same round with its tensors on ``device``."""
        mv = lambda x: x.to(device)  # noqa: E731
        return PackedRound(self.client_ids, self.task_ids, mv(self.unified),
                           mv(self.slot_masks), mv(self.slot_lams),
                           mv(self.slot_sizes), mv(self.slot_tasks),
                           mv(self.slot_valid), self.n_tasks, self.d)


class EngineOutput(NamedTuple):
    """Round results.  The packed path fills (alpha_num, n_held) and
    ``m_hats`` re-derives m̂ from the exact agreement numerator; the bool
    path fills ``m_hats_dense`` instead."""
    task_vectors: torch.Tensor       # (T, d) τ^{t,r+1} fp32
    tau_hats: torch.Tensor           # (T, d) fp32
    similarity: torch.Tensor         # (T, T), held-masked
    down_unified: torch.Tensor       # (n, d) bf16 (wire) | fp32
    down_masks: torch.Tensor         # (n, k_max, ceil(d/32)) int32 | (…, d) bool
    down_lams: torch.Tensor          # (n, k_max)
    alpha_num: Optional[torch.Tensor] = None   # (T, d) uint8 — |Σ sgn(m⊙τ)|
    n_held: Optional[torch.Tensor] = None      # (T,) fp32 member counts
    rho: float = RHO_DEFAULT
    m_hats_dense: Optional[torch.Tensor] = None  # (T, d) fp32, bool path

    @property
    def m_hats(self) -> torch.Tensor:
        """Eq. 3 averaged task masks m̂ (T, d) fp32, bit for bit the
        value the round used."""
        if self.m_hats_dense is not None:
            return self.m_hats_dense
        alpha = (self.alpha_num.float()
                 / torch.clamp(self.n_held, min=1.0)[:, None])
        return torch.where(alpha >= self.rho, 1.0, alpha)


def pack_uploads(uploads: Sequence[ClientUpload], n_tasks: int, *,
                 k_max: Optional[int] = None, packed: bool = True,
                 device: DeviceLike = "cuda") -> PackedRound:
    """Pack a ragged round of uploads into the slot layout on ``device``.
    Packed (the wire): dense bool masks are bit-packed and the unified
    vectors rounded to bf16 here — the uplink quantisation, applied once
    at the wire.  ``packed=False`` (the bool/fp32 A/B layout): fp32
    unified vectors and (n, k_max, d) bool masks; packed uploads are
    unpacked here."""
    if not uploads:
        raise ValueError("pack_uploads: empty round (no uploads)")
    dev = resolve_device(device)
    n = len(uploads)
    d = int(uploads[0].unified.shape[0])
    k_max = k_max or next_pow2(max(len(u.task_ids) for u in uploads))
    if packed:
        unified = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
        slot_masks = torch.zeros((n, k_max, bitpack.packed_width(d)),
                                 dtype=torch.int32, device=dev)
    else:
        unified = torch.zeros((n, d), dtype=torch.float32, device=dev)
        slot_masks = torch.zeros((n, k_max, d), dtype=torch.bool, device=dev)
    slot_lams = np.zeros((n, k_max), np.float32)
    slot_sizes = np.zeros((n, k_max), np.float32)
    slot_tasks = np.full((n, k_max), n_tasks, np.int32)
    slot_valid = np.zeros((n, k_max), bool)
    for i, up in enumerate(uploads):
        k = len(up.task_ids)
        unified[i] = up.unified.to(dev, unified.dtype)
        m = up.masks.to(dev)
        if packed:
            slot_masks[i, :k] = m if up.packed else bitpack.pack_bits(m)
        else:
            slot_masks[i, :k] = bitpack.unpack_bits(m, d) if up.packed else m
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
    strategy's path: ``batched_client_unify`` output) — no copies.
    ``slot_masks`` are int32 words (packed) or bool (the A/B layout)."""
    if slot_masks.dtype not in (torch.int32, torch.bool):
        raise ValueError(f"slot_masks must be packed int32 words or bool "
                         f"masks, got {slot_masks.dtype}")
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
    ClientDownlinks (views; mask rows stay in the round's layout)."""
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
        """Eq. 3–7 + downlink re-unification over a round in either
        layout (moved to the engine's device if it is elsewhere).
        ``mode="ref"`` runs the plain versions of the kernels."""
        p = packed.to(self.device)
        cfg = self.cfg
        args = (p.unified, p.slot_masks, p.slot_lams, p.slot_sizes,
                p.slot_valid, p.slot_tasks, cfg.n_tasks)
        kw = dict(rho=cfg.rho, eps=cfg.eps, kappa=cfg.kappa,
                  cross_task=cfg.cross_task, uniform_cross=cfg.uniform_cross,
                  mode=mode)
        if p.packed:
            (tv, tau, a_num, n_held, sim, du, dm,
             dl) = ops.matu_round_slots_packed(*args, p.d, **kw)
            return EngineOutput(tv, tau, sim, du, dm, dl, alpha_num=a_num,
                                n_held=n_held, rho=cfg.rho)
        (tv, tau, m_hats, sim, du, dm, dl) = ops.matu_round_slots(*args, **kw)
        return EngineOutput(tv, tau, sim, du, dm, dl, rho=cfg.rho,
                            m_hats_dense=m_hats)

    def downlinks(self, packed: PackedRound,
                  out: EngineOutput) -> Dict[int, ClientDownlink]:
        """Per-client downlinks of a finished round."""
        return _assemble_downlinks(packed.client_ids, packed.task_ids,
                                   out.down_unified, out.down_masks,
                                   out.down_lams)

    def round(self, uploads: Sequence[ClientUpload], *,
              mode: Optional[str] = None, packed: bool = True
              ) -> Tuple[Dict[int, ClientDownlink], EngineOutput]:
        """Pack → run → per-client downlinks; ``packed=False`` runs the
        bool/fp32 A/B layout."""
        batch = pack_uploads(uploads, self.cfg.n_tasks, packed=packed,
                             device=self.device)
        out = self.run_packed(batch, mode=mode)
        return self.downlinks(batch, out), out


def batched_client_unify(task_vectors: torch.Tensor, valid: torch.Tensor, *,
                         packed: bool = True, device: DeviceLike = "cuda",
                         mode: Optional[str] = None):
    """All clients' upload construction in one fused call on ``device``.

    task_vectors (N, k_max, d) zero-padded stacks; valid (N, k_max).
    Returns the uplink wire format: (unified (N, d) bf16, mask_words
    (N, k_max, ceil(d/32)) int32, lams (N, k_max) fp32) — row n is
    ``unify_with_modulators(task_vectors[n, valid[n]])`` with the
    unified vector rounded to bf16 after masks and λ were derived from
    it in fp32.  ``packed=False`` returns the bool/fp32 A/B layout:
    (unified (N, d) fp32, masks (N, k_max, d) bool, lams) with the same
    mask bits and λ bit for bit."""
    dev = resolve_device(device)
    fn = ops.fused_unify_packed if packed else ops.fused_unify
    return fn(task_vectors.to(dev), valid.to(dev), mode=mode)
