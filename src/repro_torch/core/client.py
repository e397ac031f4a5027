"""MaTU wire types and the client (paper §3.2 "Local Training with
many-tasks").

A client holds k_n tasks.  Each round it materialises per-task weights
θ_t = θ_p + λ^t · m^t ⊙ τ_n from its downlink, fine-tunes each task
locally (the trainer is injected: the core sees flat vectors only),
re-unifies the results and uploads ONE unified vector plus a (mask,
scalar) modulator per task; the downlink carries the same back.

``masks`` on an upload / downlink travels in one of three layouts:

* dense bool ``(k, d)``: the paper's accounting, 32d + k(d + 32) bits;
* packed int32 words ``(k, ceil(d/32))``: the raw packed wire, whose
  bits are measured off the buffers
  (:func:`repro_torch.kernels.bitpack.wire_bits`);
* a 1-D ``torch.uint8`` byte stream: the Golomb-Rice wire
  (:mod:`repro_torch.fed.compression`), k self-delimiting row records
  on the host, whose bits are measured off the stream's length.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.core.unify import modulate, unify_with_modulators
from repro_torch.kernels import bitpack


def paper_link_bits(d: int, k: int, float_bits: int = 32) -> int:
    """The paper's per-client link accounting: one fp32 vector + per
    task a dense-bit mask + a scalar — 32d + k(d + 32)."""
    return float_bits * d + k * (d + float_bits)


def _link_bits(unified: torch.Tensor, masks: torch.Tensor, k: int,
               float_bits: int) -> int:
    """Measured coded bits for a uint8 stream (vector buffer + stream +
    k scalers), measured packed wire bits for int32 words, the paper
    formula for dense bool masks."""
    d = int(unified.shape[0])
    if masks.dtype == torch.uint8:
        return (8 * unified.element_size() * d + 8 * masks.numel()
                + k * float_bits)
    if masks.dtype == torch.int32:
        return bitpack.wire_bits(d, k, vec_bytes_per_elem=unified.element_size(),
                                 float_bits=float_bits)
    return paper_link_bits(d, k, float_bits)


def decode_words(stream: torch.Tensor, d: int, k: int,
                 device: torch.device) -> torch.Tensor:
    """A coded uint8 stream of k rows -> (k, ceil(d/32)) int32 words on
    ``device`` (decoded on the host)."""
    from repro_torch.fed.compression import decode_mask_rows
    rows = decode_mask_rows(stream.cpu().numpy(), d, k)
    return bitpack.words_from_numpy(rows).to(device)


def _masks_dense(unified: torch.Tensor, masks: torch.Tensor,
                 k: Optional[int] = None) -> torch.Tensor:
    """Dense bool (k, d) view of modulator masks in any layout (a coded
    stream decodes on the host first and needs ``k``)."""
    d = int(unified.shape[0])
    if masks.dtype == torch.uint8:
        masks = decode_words(masks, d, k, unified.device)
    if masks.dtype == torch.int32:
        return bitpack.unpack_bits(masks, d)
    return masks


@dataclass
class ClientUpload:
    client_id: int
    task_ids: List[int]
    unified: torch.Tensor       # (d,) fp32 | bf16 (wire)
    masks: torch.Tensor         # (k, d) bool | (k, ceil(d/32)) int32 | uint8 stream
    lams: torch.Tensor          # (k,)
    data_sizes: List[int]
    # TaskVectorSpace fingerprint of the layout the vector was flattened
    # through (None for homogeneous rounds); lets the server verify layout
    # agreement before aggregating
    fingerprint: Optional[str] = None
    _dense: Optional[torch.Tensor] = field(default=None, repr=False,
                                           compare=False)

    @property
    def packed(self) -> bool:
        return self.masks.dtype == torch.int32

    @property
    def coded(self) -> bool:
        """True when ``masks`` is the entropy-coded uint8 byte stream."""
        return self.masks.dtype == torch.uint8

    def masks_dense(self) -> torch.Tensor:
        if self._dense is None:
            self._dense = _masks_dense(self.unified, self.masks,
                                       len(self.task_ids))
        return self._dense

    def uplink_bits(self, float_bits: int = 32) -> int:
        """Measured off the wire buffers (bf16 vector + packed words or
        the coded stream + scalers); the paper's 32d + k(d + 32) for
        dense bool masks."""
        return _link_bits(self.unified, self.masks, len(self.task_ids),
                          float_bits)


@dataclass
class ClientDownlink:
    unified: torch.Tensor       # (d,) fp32 | bf16 (wire)
    masks: torch.Tensor         # (k, d) bool | (k, ceil(d/32)) int32 | uint8 stream
    lams: torch.Tensor          # (k,)
    # TaskVectorSpace fingerprint of the layout (None for plain rounds):
    # the serving ModulatorStore refuses a downlink whose fingerprint does
    # not match its own manifest
    fingerprint: Optional[str] = None
    _words: Optional[torch.Tensor] = field(default=None, repr=False,
                                           compare=False)

    @property
    def packed(self) -> bool:
        return self.masks.dtype == torch.int32

    @property
    def coded(self) -> bool:
        """True when ``masks`` is the entropy-coded uint8 byte stream."""
        return self.masks.dtype == torch.uint8

    def _decoded_words(self) -> torch.Tensor:
        """Coded stream -> (k, ceil(d/32)) int32 words on the vector's
        device, decoded once and cached."""
        if self._words is None:
            self._words = decode_words(self.masks, int(self.unified.shape[0]),
                                       int(self.lams.shape[0]),
                                       self.unified.device)
        return self._words

    def masks_dense(self) -> torch.Tensor:
        masks = self._decoded_words() if self.coded else self.masks
        return _masks_dense(self.unified, masks)

    def mask_row(self, i) -> torch.Tensor:
        """Row ``i`` (an index or a slice) of the modulator masks in a
        ``modulate``-ready layout: the packed word / bool row as it is;
        the coded wire decodes to packed words once, never to bools."""
        return self._decoded_words()[i] if self.coded else self.masks[i]

    def downlink_bits(self, float_bits: int = 32) -> int:
        return _link_bits(self.unified, self.masks, int(self.lams.shape[0]),
                          float_bits)


class MaTUClient:
    """One federated client; ``trainer(task_id, tv_init, generator) ->
    tv_new`` runs the local fine-tune in flat task-vector space.

    ``space`` (optional): the client backbone's
    :class:`~repro_torch.common.tree.TaskVectorSpace`.  Given it, ``d``
    may be omitted (it defaults to ``space.d``), every upload carries
    ``space.fingerprint`` so the server can verify the layout before
    aggregating, and :meth:`verify_layout` is the client's half of the
    handshake.  ``code_masks`` uploads the masks as a Golomb-Rice
    stream and the unified vector in bf16."""

    def __init__(self, client_id: int, task_ids: List[int],
                 data_sizes: List[int], d: Optional[int] = None,
                 trainer: Callable[[int, torch.Tensor, torch.Generator],
                                   torch.Tensor] = None,
                 code_masks: bool = False, space=None):
        if d is None:
            if space is None:
                raise ValueError("MaTUClient needs d or a TaskVectorSpace")
            d = space.d
        self.client_id = client_id
        self.task_ids = list(task_ids)
        self.data_sizes = list(data_sizes)
        self.d = d
        self.trainer = trainer
        self.code_masks = code_masks
        self.space = space
        self.state: Optional[ClientDownlink] = None

    @property
    def fingerprint(self) -> Optional[str]:
        return self.space.fingerprint if self.space is not None else None

    def verify_layout(self, server_fingerprint: str) -> None:
        """Abort-before-train check against the server's advertised
        layout fingerprint (raises
        :class:`~repro_torch.common.tree.TaskVectorLayoutError`)."""
        if self.space is not None:
            self.space.require_compatible(server_fingerprint,
                                          context=f"client {self.client_id}")

    def task_vector_init(self, task_index: int) -> torch.Tensor:
        """Starting τ for a local task from the current downlink."""
        if self.state is None:
            return torch.zeros((self.d,), dtype=torch.float32)
        return modulate(self.state.unified, self.state.mask_row(task_index),
                        self.state.lams[task_index])

    def run_round(self, generator: torch.Generator) -> ClientUpload:
        """Train every task (each from its downlinked τ; ``generator``
        feeds the trainer's draws in task order), re-unify, and build
        the upload."""
        tvs = [self.trainer(t, self.task_vector_init(i), generator)
               for i, t in enumerate(self.task_ids)]
        unified, masks, lams = unify_with_modulators(torch.stack(tvs))
        if self.code_masks:
            # wire edge: entropy-code the fresh masks and ship the bf16
            # vector; the server decodes at pack time
            from repro_torch.fed.compression import encode_mask_rows
            stream = encode_mask_rows(
                bitpack.pack_bits_np(masks.cpu().numpy()), self.d)
            return ClientUpload(self.client_id, self.task_ids,
                                unified.to(torch.bfloat16),
                                torch.from_numpy(stream), lams,
                                self.data_sizes, fingerprint=self.fingerprint)
        return ClientUpload(self.client_id, self.task_ids, unified, masks,
                            lams, self.data_sizes,
                            fingerprint=self.fingerprint)

    def receive(self, downlink: ClientDownlink) -> None:
        self.state = downlink
