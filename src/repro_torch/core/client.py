"""MaTU wire types: what a client uploads and what it gets back.

A client holds k_n tasks; each round it uploads ONE unified vector plus
a (mask, scalar) modulator per task, and receives the same for the next
round.  ``masks`` travels either as dense bool ``(k, d)`` (the paper's
accounting: 32d + k(d + 32) bits) or as packed int32 words ``(k,
ceil(d/32))`` — the raw packed wire, whose bits are measured off the
buffers (:func:`repro_torch.kernels.bitpack.wire_bits`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.kernels import bitpack


def paper_link_bits(d: int, k: int, float_bits: int = 32) -> int:
    """The paper's per-client link accounting: one fp32 vector + per
    task a dense-bit mask + a scalar — 32d + k(d + 32)."""
    return float_bits * d + k * (d + float_bits)


def _link_bits(unified: torch.Tensor, masks: torch.Tensor, k: int,
               float_bits: int) -> int:
    """Measured packed wire bits for int32 words, the paper formula for
    dense bool masks."""
    d = int(unified.shape[0])
    if masks.dtype == torch.int32:
        return bitpack.wire_bits(d, k, vec_bytes_per_elem=unified.element_size(),
                                 float_bits=float_bits)
    return paper_link_bits(d, k, float_bits)


def _masks_dense(unified: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    if masks.dtype == torch.int32:
        return bitpack.unpack_bits(masks, int(unified.shape[0]))
    return masks


@dataclass
class ClientUpload:
    client_id: int
    task_ids: List[int]
    unified: torch.Tensor       # (d,) fp32 | bf16 (wire)
    masks: torch.Tensor         # (k, d) bool | (k, ceil(d/32)) int32 words
    lams: torch.Tensor          # (k,)
    data_sizes: List[int]
    # TaskVectorSpace fingerprint of the layout the vector was flattened
    # through (None for homogeneous rounds); lets the server verify layout
    # agreement before aggregating
    fingerprint: Optional[str] = None

    @property
    def packed(self) -> bool:
        return self.masks.dtype == torch.int32

    def masks_dense(self) -> torch.Tensor:
        return _masks_dense(self.unified, self.masks)

    def uplink_bits(self, float_bits: int = 32) -> int:
        """Measured off the wire buffers for packed uploads; the paper's
        32d + k(d + 32) for dense bool masks."""
        return _link_bits(self.unified, self.masks, len(self.task_ids),
                          float_bits)


@dataclass
class ClientDownlink:
    unified: torch.Tensor       # (d,) fp32 | bf16 (wire)
    masks: torch.Tensor         # (k, d) bool | (k, ceil(d/32)) int32 words
    lams: torch.Tensor          # (k,)
    # TaskVectorSpace fingerprint of the layout (None for plain rounds):
    # the serving ModulatorStore refuses a downlink whose fingerprint does
    # not match its own manifest
    fingerprint: Optional[str] = None

    @property
    def packed(self) -> bool:
        return self.masks.dtype == torch.int32

    def masks_dense(self) -> torch.Tensor:
        return _masks_dense(self.unified, self.masks)

    def downlink_bits(self, float_bits: int = 32) -> int:
        return _link_bits(self.unified, self.masks, int(self.lams.shape[0]),
                          float_bits)
