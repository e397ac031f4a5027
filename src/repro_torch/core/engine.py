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

Entropy-coded layer (host edge only)
------------------------------------
Over the packed words sits the invertible Golomb-Rice coder
(:mod:`repro_torch.fed.compression`, streams byte-identical to the JAX
package's).  It never enters the device round: :func:`pack_uploads`
decodes coded (uint8) uploads into slot words in one batched call, and
``RoundEngine.downlinks(code_masks=True)`` encodes every client's
downlink rows in one batched call and splits the stream back by the
records' sizes.

Host pipeline
-------------
``RoundEngine.round_stream`` runs a sequence of replayed rounds through
a two-deep pipeline: while round r's kernels run (launches on the
current CUDA stream are asynchronous), the host drains round r−1 (waits
for it, encodes its downlinks, yields) and packs round r+1.  The
contract, the JAX package's:

* **buffer ownership** — ``pack_uploads(stage=)`` fills its host tensors
  in a :class:`SlotStage` (pinned on a CUDA device, copied with
  ``non_blocking=True``; on the CPU the round's tensors ARE the stage's,
  uncopied, as JAX's zero-copy ``jnp.asarray``).  The pipeline alternates TWO stages:
  the stage refilled for round r+1 is the one round r−1 used, and round
  r−1 was drained before that refill starts, so a stage is never written
  while a copy out of it, or a round reading it, is in flight.  A
  ``PackedRound`` packed into a stage is valid only until that stage is
  refilled.
* **ready point** — a round's ready point is a ``torch.cuda.Event``
  recorded after its last launch (:func:`ready_mark`);
  :func:`wait_ready` is JAX's ``block_until_ready``.  Under
  ``code_masks`` the downlink words' copy to pinned host memory is
  enqueued before that event, so encoding round r−1 never waits for
  round r.
* **escape hatch** — ``pipeline=False`` packs with fresh buffers and
  waits for each round before its downlinks.  Both orders run the same
  operations on the same bits, so pipelined rounds are bit-identical to
  sequential ones.
* **timings** — each round reports ``phase_us`` (``pack`` / ``decode``
  / ``encode`` / ``device`` µs; ``device`` is dispatch to ready, which
  under the pipeline overlaps its neighbours' host phases).

The simulator's closed loop pipelines instead through the strategy's
deferred drain (``MaTUStrategy(pipeline=True)``).

Population-scale contract
-------------------------
``RoundEngine.round_chunked`` streams a round of N uploads through one
chunk buffer of C clients, so the round's d-wide memory is O(C·k_max·d
+ T·d) whatever N: the monolithic round's dense (N, T, ⌈d/32⌉) words
never exist.  The round splits into four phases (``kernels.ops``,
chunked section):

* **phase A** (scalars): each chunk's rows of the monolithic round's
  dense (N, T) member and size tables; at the end, the member counts
  n_t and the Eq. 4 weights γ from the whole tables
  (``ops.matu_gammas``).  γ's normaliser is ``torch.sum`` over the
  client axis, whose rounding only the whole column fixes, so phase A
  keeps the round's O(N·T) scalars (a few bytes a client and task), not
  a (T,) running sum.  The γ normaliser needs every client before any
  merge work: the engine makes two passes over the uploads, which may
  be a zero-argument callable returning a fresh iterator (the population
  simulator derives sampled clients on demand and never holds a round).
* **phase B** (merge): each chunk packs into the monolithic round's
  slot layout (one :class:`SlotStage`, refilled only after the ready
  mark of the fold that read it) and folds its sign votes and γλ-weighted
  Eq. 4 partials into carried (T+1, d) accumulators, int32 votes on the
  wire and fp32 in the bool layout; row T swallows invalid slots.
* **finish**: Eq. 3 m̂, τ̂, Eq. 5 (kernel 3, or kernel 6 in the bool
  layout), Eq. 6 + 7 from the accumulators alone: the monolithic
  round's own tail (``ops._finish``).
* **phase C** (downlink): per chunk, the monolithic downlink step
  (``ops._downlink``: kernel 1, or kernel 4) on that chunk's slot rows;
  each row depends on its own slots only.  ``sink`` takes each chunk's
  ``ClientDownlink``s instead of the engine holding N of them.

**Chunk-count invariance** (the bit-identity rule).  The port's
monolithic round adds clients in ascending order, one fp32 rounding per
product and per add (``ref._masked_agg``; kernels 2 and 5 are bitwise to
it).  Phase B makes the same adds in the same order, each client's
written into the rows of its own distinct tasks by one gather and one
write: never an unordered scatter-add (atomics on CUDA) nor a ``+=``
through repeated task ids.  A non-member's add in the monolithic round
is a signed zero, which changes no sum, so leaving it out changes no
bit.  Votes and Eq. 5 dots are exact integers.  γ is the monolithic
division on the monolithic tables, and the finish and phase C run the
monolithic code.  Hence chunked ≡ monolithic **bit for bit**, on the CPU
and on the card, in both layouts, with staleness and with coded
downlinks: task vectors, τ̂, alpha_num / m̂, n_held, S, every downlink
and the measured wire bits, for chunks of 1, of a non-divisor of N and
of more than N.  No chunk is padded.

Async rounds
------------
An upload dispatched at round q and folded at round r carries staleness
``s = r − q``; its slots get the weight ``w = δ**s`` (``δ =
STALENESS_DISCOUNT``) as ``PackedRound.slot_weights``, applied as λ·w and
size·w before the round's kernels (``ops._apply_slot_weights``).  ``w =
1`` is bitwise ``None``, which keeps an ideal-trace async round
bit-identical to the synchronous one.  Corrupted coded uploads are
quarantined by the async strategy before packing; empty rounds never
reach ``pack_uploads``.

Sharding contract
-----------------
With a mesh (``RoundEngine(mesh=)``; ``repro_torch.launch.mesh`` builds
them over the default process group), one round runs distributed over
the ``taskvec`` logical axis (``repro_torch.nn.sharding``: d splits over
every mesh axis the rule names).  JAX runs one ``shard_map`` body on
every shard; here every rank runs the same Python on its own d-slice,
so a rank's call IS the body.  The contract, the JAX package's:

* **inputs** — every rank holds the same uploads (the same simulator,
  seeds and replicated client training, as JAX's single controller) and
  slices its own columns: ``pack_uploads`` / ``pack_from_slots`` /
  ``batched_client_unify`` keep only the rank's slice, so no collective
  runs on the way in.
* **layout** — every d-axis tensor (``unified``, ``slot_masks``, τ̂, the
  task vectors, alpha_num, the downlinks) splits on its LAST axis into
  ``n_shards`` contiguous slices, shard ``s`` holding ``[s·d_pad/n,
  (s+1)·d_pad/n)``, ``s`` major→minor over the taskvec axes; per-slot
  scalars are whole on every rank.  ``PackedRound.d_pad`` and
  ``EngineOutput.d_pad`` mark the rank's slices.
* **padding** — d is zero-padded to ``pad_d_for_shards(d, n_shards)``:
  each shard holds a power-of-two number of 256-coordinate blocks (8
  whole mask words, one λ block).  Padded coordinates carry zero masks
  and vectors and drop out of every reduction.
* **collectives** — per-coordinate math (Eq. 3, 4, 6, 7, the downlink
  re-unification) never crosses ranks; the kernels run on the rank's
  slice.  Exactly two reductions do, both through the counted
  :func:`~repro_torch.nn.sharding.psum`: the Eq. 5 (T, T) dots as int32
  (kernel 3 on the sign planes, in both layouts, normalised by the
  global d), and every λ num/den tree root in one call
  (``ref._lam_totals``).  Nothing else runs inside ``run_packed``.
* **wire boundary** — the d-axis outputs are gathered (``gather_cols``,
  :func:`~repro_torch.nn.sharding.gather`) and cut back to d only where
  JAX assembles its global arrays: in ``downlinks`` and in
  ``gather_output`` (``MaTUServer.finish_round`` gathers the task
  vectors beside the downlinks).  The uploads a round takes and the
  downlinks it makes (``ClientUpload``, ``ClientDownlink``) are always
  the whole wire.
* **parity** — the λ tree pairs (2i, 2i+1) over a fixed block grid, so
  contiguous power-of-two shard subtrees compose into the global tree:
  the sharded round is bitwise the unsharded one in both layouts, on
  the CPU and, its kernels being bitwise their plain versions, on the
  card.
* **chunked** — ``round_chunked`` on a mesh: phase B has no collective
  (each rank folds every row of its slice); the finish has the dots
  psum and one psum of the per-task λ numerators; phase C one psum of
  the λ denominators a chunk.  On a ``make_population_mesh`` phase C's
  rows also split over "slots" (the chunk padded to a multiple of the
  slot shards with invalid rows), and the gather hands every rank, and
  ``sink``, every row.

The engine never sees a model, only d.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.client import (ClientDownlink, ClientUpload,
                                     paper_link_bits)
from repro_torch.kernels import bitpack, ops, ref
from repro_torch.kernels.ref import LAMBDA_BLOCK, next_pow2
from repro_torch.nn import sharding

RHO_DEFAULT = 0.4     # Eq. 3 threshold
EPS_DEFAULT = 0.5     # Eq. 6 similarity filter
KAPPA_DEFAULT = 3     # Eq. 6 top-κ
# async staleness discount δ: an upload folded s rounds after dispatch
# enters the round with weight δ**s (δ**0 = 1 keeps fresh uploads exact)
STALENESS_DISCOUNT = 0.5


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
    # per-slot staleness weights (n, k_max) fp32, None for an all-fresh
    # round; w ≡ 1 is bitwise None (``ops._apply_slot_weights``)
    slot_weights: Optional[torch.Tensor] = None
    # d after the taskvec-shard padding (pad_d_for_shards) when packed on
    # a mesh: the d-axis tensors then hold this rank's slice of it; None
    # without a mesh.  Wire accounting uses the true ``d``.
    d_pad: Optional[int] = None

    @property
    def n_clients(self) -> int:
        return len(self.client_ids)

    @property
    def padded_d(self) -> int:
        return self.d_pad or self.d

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
        if self.d_pad is not None:
            raise ValueError("dense_tensors: a sharded round holds only "
                             "this rank's d-slice")
        masks = (ops.unpack_masks(self.slot_masks, self.d) if self.packed
                 else self.slot_masks)
        return ops.slots_to_dense(masks, self.slot_lams, self.slot_sizes,
                                  self.slot_valid, self.slot_tasks,
                                  self.n_tasks)

    def to(self, device: torch.device) -> "PackedRound":
        """The same round with its tensors on ``device``."""
        mv = lambda x: None if x is None else x.to(device)  # noqa: E731
        return PackedRound(self.client_ids, self.task_ids, mv(self.unified),
                           mv(self.slot_masks), mv(self.slot_lams),
                           mv(self.slot_sizes), mv(self.slot_tasks),
                           mv(self.slot_valid), self.n_tasks, self.d,
                           mv(self.slot_weights), self.d_pad)


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
    # (T, d) uint8, int32 past 128 clients: |Σ sgn(m⊙τ)|
    alpha_num: Optional[torch.Tensor] = None
    n_held: Optional[torch.Tensor] = None      # (T,) fp32 member counts
    rho: float = RHO_DEFAULT
    m_hats_dense: Optional[torch.Tensor] = None  # (T, d) fp32, bool path
    # set on a mesh: the d-axis fields hold this rank's slice of a
    # d_pad-wide round (``RoundEngine.gather_output`` assembles them)
    d_pad: Optional[int] = None

    @property
    def m_hats(self) -> torch.Tensor:
        """Eq. 3 averaged task masks m̂ (T, d) fp32, bit for bit the
        value the round used."""
        if self.m_hats_dense is not None:
            return self.m_hats_dense
        alpha = (self.alpha_num.float()
                 / torch.clamp(self.n_held, min=1.0)[:, None])
        return torch.where(alpha >= self.rho, 1.0, alpha)


def pad_d_for_shards(d: int, n_shards: int) -> int:
    """Padded feature count of a taskvec-sharded round: each of the
    ``n_shards`` contiguous d-slices is a power-of-two number of
    LAMBDA_BLOCKs (256 coordinates = 8 mask words), so no mask word is
    split and the λ block trees of the shards compose into the global
    one (module docstring, "Sharding contract").  Identity unsharded."""
    if n_shards <= 1:
        return d
    per_shard_blocks = next_pow2(-(-d // (n_shards * LAMBDA_BLOCK)))
    return n_shards * LAMBDA_BLOCK * per_shard_blocks


def _mesh_layout(mesh):
    """(this rank's ``TaskvecLayout``, n_shards) on ``mesh``; (None, 1)
    without one."""
    lay = sharding.taskvec_layout(mesh)
    return lay, (lay.n_shards if lay is not None else 1)


def _slice_cols(x: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """Columns [lo, lo + width) of ``x``'s last axis, zero-filled past
    its end, contiguous."""
    part = x[..., lo:lo + width]
    if part.shape[-1] < width:
        part = torch.nn.functional.pad(part, (0, width - part.shape[-1]))
    return part.contiguous()


def gather_cols(x: torch.Tensor, lay, d: int, *,
                words: bool = False) -> torch.Tensor:
    """The whole d-axis of a rank's slices: ``x``'s last axis gathered
    over the taskvec group in shard order and cut back to ``d``
    coordinates (``ceil(d/32)`` words when ``words``).  A wire-boundary
    gather, outside every round's collective budget."""
    full = sharding.gather(x, lay.group)
    return full[..., :bitpack.packed_width(d) if words else d].contiguous()


def staleness_weights(staleness: Sequence[int], k_max: int,
                      discount: float = STALENESS_DISCOUNT) -> np.ndarray:
    """(n, k_max) fp32 slot weights ``discount**s`` for uploads of
    staleness ``s``, one row an upload (every slot of a client alike)."""
    w = np.float32(discount) ** np.asarray(staleness, np.float32)
    return np.ascontiguousarray(np.broadcast_to(w[:, None],
                                                (len(w), k_max)))


def ready_mark(device: torch.device) -> Optional["torch.cuda.Event"]:
    """The point at which the work queued so far on ``device`` is done:
    an event recorded on the current CUDA stream, or None on the CPU,
    where every op has finished when it returns."""
    if device.type != "cuda":
        return None
    mark = torch.cuda.Event()
    mark.record(torch.cuda.current_stream(device))
    return mark


def wait_ready(mark: Optional["torch.cuda.Event"]) -> None:
    """Block the host until ``mark`` (JAX's ``block_until_ready``)."""
    if mark is not None:
        mark.synchronize()


def host_copy_async(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host.  A CUDA tensor's copy into pinned memory is
    only enqueued: read it after a :func:`ready_mark` recorded later.  A
    CPU tensor is returned as it is."""
    if x.device.type != "cuda":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out


class SlotStage:
    """Reusable host buffers for :func:`pack_uploads`, keyed by name and
    reallocated only when the shape, dtype or pinning changes, so a
    steady round stream refills warm pages.  Ownership (module
    docstring, "Host pipeline"): a stage must not be refilled while a
    copy out of it or a round reading it is in flight;
    ``RoundEngine.round_stream`` alternates two stages and drains round
    r−1 before round r+1 refills its stage."""

    def __init__(self) -> None:
        self._bufs: Dict[str, Tuple[torch.Tensor, bool]] = {}

    def alloc(self, name: str, shape: tuple, dtype: torch.dtype,
              pin: bool = False) -> torch.Tensor:
        buf, pinned = self._bufs.get(name, (None, False))
        if (buf is None or tuple(buf.shape) != tuple(shape)
                or buf.dtype != dtype or pinned != pin):
            buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
            self._bufs[name] = (buf, pin)
        return buf


def pack_uploads(uploads: Sequence[ClientUpload], n_tasks: int, *,
                 k_max: Optional[int] = None, packed: bool = True,
                 device: DeviceLike = "cuda",
                 stage: Optional[SlotStage] = None,
                 phase_us: Optional[Dict[str, float]] = None,
                 mesh=None) -> PackedRound:
    """Pack a ragged round of uploads into the slot layout on ``device``.
    Packed (the wire): dense bool masks are bit-packed and the unified
    vectors rounded to bf16 here — the uplink quantisation, applied once
    at the wire.  ``packed=False`` (the bool/fp32 A/B layout): fp32
    unified vectors and (n, k_max, d) bool masks; packed uploads are
    unpacked here.  Coded (uint8 stream) uploads are decoded here, on
    the host, in ONE batched ``decode_mask_rows`` call over every coded
    client's concatenated stream (records self-delimit); the round
    never sees the coded layer.

    Without ``stage`` the slot tensors are filled on ``device``.  With
    one they are filled in its host buffers (pinned on a CUDA device)
    and copied with ``non_blocking=True``, so packing round r+1 never
    waits for round r (module docstring, "Host pipeline"); the returned
    round is valid until the stage is refilled.  ``phase_us``
    accumulates the ``pack`` and ``decode`` host µs.

    With ``mesh`` d is zero-padded to ``pad_d_for_shards`` and the
    d-axis tensors hold only this rank's slice of it (whole words); the
    scalars are whole (module docstring, "Sharding contract")."""
    if not uploads:
        raise ValueError("pack_uploads: empty round (no uploads)")
    t_pack = time.perf_counter()
    dev = resolve_device(device)
    fill_dev = dev if stage is None else torch.device("cpu")
    n = len(uploads)
    d = int(uploads[0].unified.shape[0])
    lay, n_shards = _mesh_layout(mesh)
    d_pad = pad_d_for_shards(d, n_shards)
    width = d_pad // n_shards
    lo = lay.shard * width if n_shards > 1 else 0
    n_real = max(min(lo + width, d) - lo, 0)     # this slice's real coords
    w_lo, n_words = lo // 32, max(min(lo // 32 + -(-width // 32),
                                      bitpack.packed_width(d)) - lo // 32, 0)
    ks = [len(u.task_ids) for u in uploads]
    k_max = k_max or next_pow2(max(ks))
    masks = [u.masks for u in uploads]
    coded = [i for i, m in enumerate(masks) if m.dtype == torch.uint8]
    dec_s = 0.0
    if coded:
        from repro_torch.fed.compression import decode_mask_rows
        t0 = time.perf_counter()
        rows = decode_mask_rows(
            np.concatenate([masks[i].cpu().numpy() for i in coded]), d,
            sum(ks[i] for i in coded))
        words = bitpack.words_from_numpy(rows).to(fill_dev)
        off = 0
        for i in coded:
            masks[i] = words[off:off + ks[i]]
            off += ks[i]
        dec_s = time.perf_counter() - t0
    if packed:
        vec = ((n, width), torch.bfloat16)
        wide = ((n, k_max, bitpack.packed_width(width)), torch.int32)
    else:
        vec = ((n, width), torch.float32)
        wide = ((n, k_max, width), torch.bool)
    small = (("slot_lams", torch.float32), ("slot_sizes", torch.float32),
             ("slot_tasks", torch.int32), ("slot_valid", torch.bool))
    if stage is None:
        unified = torch.zeros(vec[0], dtype=vec[1], device=dev)
        slot_masks = torch.zeros(wide[0], dtype=wide[1], device=dev)
        scalars = [torch.zeros((n, k_max), dtype=dt) for _, dt in small]
    else:
        pin = dev.type == "cuda"
        unified = stage.alloc("unified", *vec, pin)
        slot_masks = stage.alloc("slot_masks", *wide, pin)
        scalars = [stage.alloc(name, (n, k_max), dt, pin).zero_()
                   for name, dt in small]
    slot_lams, slot_sizes, slot_tasks, slot_valid = (x.numpy()
                                                     for x in scalars)
    slot_tasks[:] = n_tasks
    for i, up in enumerate(uploads):
        k = ks[i]
        unified[i, :n_real] = up.unified[lo:lo + n_real].to(fill_dev,
                                                             unified.dtype)
        m = masks[i].to(fill_dev)
        is_words = m.dtype == torch.int32
        if packed:
            w = m if is_words else bitpack.pack_bits(m)
            slot_masks[i, :k, :n_words] = w[:, w_lo:w_lo + n_words]
        else:
            mb = bitpack.unpack_bits(m, d) if is_words else m
            slot_masks[i, :k, :n_real] = mb[:, lo:lo + n_real]
        if stage is not None:     # a stage's buffers come back dirty
            unified[i, n_real:] = 0
            slot_masks[i, :k, n_words if packed else n_real:] = 0
            slot_masks[i, k:] = 0
        slot_lams[i, :k] = up.lams.detach().float().cpu().numpy()
        slot_sizes[i, :k] = up.data_sizes
        slot_tasks[i, :k] = up.task_ids
        slot_valid[i, :k] = True
    if phase_us is not None:
        phase_us["decode"] = phase_us.get("decode", 0.0) + dec_s * 1e6
        phase_us["pack"] = (phase_us.get("pack", 0.0)
                            + (time.perf_counter() - t_pack - dec_s) * 1e6)
    put = lambda x: x.to(dev, non_blocking=stage is not None)  # noqa: E731
    return PackedRound([u.client_id for u in uploads],
                       [list(u.task_ids) for u in uploads],
                       put(unified), put(slot_masks),
                       *(put(x) for x in scalars), n_tasks, d,
                       d_pad=d_pad if n_shards > 1 else None)


def pack_from_slots(client_ids: List[int], task_ids: List[List[int]],
                    unified: torch.Tensor, slot_masks: torch.Tensor,
                    slot_lams: torch.Tensor, slot_tasks: torch.Tensor,
                    slot_valid: torch.Tensor, slot_sizes: torch.Tensor,
                    n_tasks: int, *, d: Optional[int] = None,
                    slot_weights: Optional[torch.Tensor] = None,
                    mesh=None) -> PackedRound:
    """Build a PackedRound from already-batched slot tensors (the
    strategy's path: ``batched_client_unify`` output) — no copies.
    ``slot_masks`` are int32 words (packed) or bool (the A/B layout).
    ``slot_weights`` (optional (n, k_max)) attaches the async staleness
    discount.

    With ``mesh``, ``d`` is the true feature count and the d-axis
    tensors are either this rank's slice of the padded width
    (``batched_client_unify(mesh=)`` output, kept as they are) or whole
    (``d`` or the padded width wide), and then sliced here."""
    if slot_masks.dtype not in (torch.int32, torch.bool):
        raise ValueError(f"slot_masks must be packed int32 words or bool "
                         f"masks, got {slot_masks.dtype}")
    width = int(unified.shape[-1])
    d = d or width
    lay, n_shards = _mesh_layout(mesh)
    d_pad = pad_d_for_shards(d, n_shards)
    local = d_pad // n_shards
    if n_shards > 1 and width in (d, d_pad):
        lo = lay.shard * local
        packed = slot_masks.dtype == torch.int32
        unified = _slice_cols(unified, lo, local)
        slot_masks = (_slice_cols(slot_masks, lo // 32, local // 32)
                      if packed else _slice_cols(slot_masks, lo, local))
    elif width != local:
        raise ValueError(f"unified width {width} matches neither d={d} nor "
                         f"the shard-padded {d_pad} nor its slice {local}")
    return PackedRound(list(client_ids), [list(t) for t in task_ids],
                       unified, slot_masks, slot_lams.float(),
                       slot_sizes.float(), slot_tasks.to(torch.int32),
                       slot_valid.bool(), n_tasks, d,
                       None if slot_weights is None else slot_weights.float(),
                       d_pad if n_shards > 1 else None)


def _assemble_downlinks(client_ids: List[int], task_ids: List[List[int]],
                        d: int, down_unified: torch.Tensor,
                        down_masks: torch.Tensor, down_lams: torch.Tensor,
                        *, code_masks: bool = False,
                        phase_us: Optional[Dict[str, float]] = None,
                        host_words: Optional[torch.Tensor] = None
                        ) -> Dict[int, ClientDownlink]:
    """Slice the batched downlink tensors back to ragged per-client
    ClientDownlinks (views; mask rows stay in the round's layout).  With
    ``code_masks`` the mask rows of ALL the clients are entropy-coded in
    one batched call on the host (bool rows are packed first) and split
    back by the per-row record sizes: records self-delimit, so each
    client's slice is byte-identical to encoding that client alone.
    ``host_words`` are the downlink words already copied to the host
    (``round_stream`` enqueues that copy at dispatch); ``phase_us``
    accumulates the ``encode`` host µs."""
    ks = [len(t) for t in task_ids]
    if code_masks:
        from repro_torch.fed.compression import encode_mask_rows_with_sizes
        t0 = time.perf_counter()
        words = host_words
        if words is None:
            words = (down_masks if down_masks.dtype == torch.int32
                     else bitpack.pack_bits(down_masks))
        rows = split_streams(*encode_mask_rows_with_sizes(
            valid_rows(bitpack.words_to_numpy(words), ks), d), ks)
        if phase_us is not None:
            phase_us["encode"] = (phase_us.get("encode", 0.0)
                                  + (time.perf_counter() - t0) * 1e6)
    else:
        rows = [down_masks[i, :k] for i, k in enumerate(ks)]
    return {cid: ClientDownlink(down_unified[i], rows[i],
                                down_lams[i, :ks[i]])
            for i, cid in enumerate(client_ids)}


def valid_rows(words: np.ndarray, ks: Sequence[int]) -> np.ndarray:
    """The first ``ks[i]`` slot rows of each client ``i`` of a (n,
    k_max, w) word stack, in client-then-slot order: the rows a round's
    coded wire carries."""
    return words[np.repeat(np.arange(len(ks)), ks),
                 np.concatenate([np.arange(k, dtype=np.int64)
                                 for k in ks])]


def split_streams(stream: np.ndarray, sizes: np.ndarray,
                  ks: Sequence[int]) -> List[torch.Tensor]:
    """Cut one batched coded stream back into per-client uint8 streams
    (host tensors) by the per-row record ``sizes``, ``ks[i]`` rows
    each."""
    ends = np.cumsum(sizes)
    out, b0, r0 = [], 0, 0
    for k in ks:
        b1 = int(ends[r0 + k - 1]) if k else b0
        out.append(torch.from_numpy(stream[b0:b1]))
        b0, r0 = b1, r0 + k
    return out


class RoundEngine:
    """Stateless per-round executor on one device, optionally one rank of
    a taskvec mesh (module docstring, "Sharding contract")."""

    def __init__(self, cfg: EngineConfig, device: DeviceLike = "cuda",
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_mesh(mesh)

    def use_mesh(self, mesh) -> None:
        """Install (or, with None, clear) the taskvec mesh the rounds
        shard over."""
        self.mesh = mesh
        # this rank's TaskvecLayout on the mesh (None without one)
        self.layout, self.n_shards = _mesh_layout(mesh)
        self.slot_shards = (self.layout.row_shards if self.layout
                            else 1)

    def _shard_kw(self, d: int) -> dict:
        """The ops' taskvec arguments for a round of true width ``d``."""
        if self.n_shards == 1:
            return {}
        return dict(group=self.layout.group,
                    axis_sizes=self.layout.axis_sizes, d_norm=d)

    def run_packed(self, packed: PackedRound, *,
                   mode: Optional[str] = None) -> EngineOutput:
        """Eq. 3–7 + downlink re-unification over a round in either
        layout (moved to the engine's device if it is elsewhere).
        ``mode="ref"`` runs the plain versions of the kernels.  On a mesh
        the round must be packed with the same mesh; the output holds
        this rank's d-slices (``gather_output`` assembles them)."""
        d_pad = pad_d_for_shards(packed.d, self.n_shards)
        if packed.padded_d != d_pad:
            raise ValueError(
                f"run_packed: batch padded to d={packed.padded_d} but the "
                f"engine's mesh shards {self.n_shards} ways (wants {d_pad}): "
                f"pack with the same mesh the engine holds")
        p = packed.to(self.device)
        cfg = self.cfg
        args = (p.unified, p.slot_masks, p.slot_lams, p.slot_sizes,
                p.slot_valid, p.slot_tasks, cfg.n_tasks)
        kw = dict(rho=cfg.rho, eps=cfg.eps, kappa=cfg.kappa,
                  cross_task=cfg.cross_task, uniform_cross=cfg.uniform_cross,
                  mode=mode, slot_weights=p.slot_weights,
                  **self._shard_kw(p.d))
        tag = p.d_pad
        if p.packed:
            (tv, tau, a_num, n_held, sim, du, dm,
             dl) = ops.matu_round_slots_packed(
                 *args, d_pad // self.n_shards, **kw)
            return EngineOutput(tv, tau, sim, du, dm, dl, alpha_num=a_num,
                                n_held=n_held, rho=cfg.rho, d_pad=tag)
        (tv, tau, m_hats, sim, du, dm, dl) = ops.matu_round_slots(*args, **kw)
        return EngineOutput(tv, tau, sim, du, dm, dl, rho=cfg.rho,
                            m_hats_dense=m_hats, d_pad=tag)

    def gather_output(self, out: EngineOutput, d: int) -> EngineOutput:
        """``out`` with every d-axis field whole and cut back to ``d``:
        the wire-boundary gather of a sharded round's slices (the global
        arrays JAX assembles).  An unsharded output comes back as it
        is."""
        if out.d_pad is None:
            return out
        lay = self.layout

        def whole(x, words=False):
            return None if x is None else gather_cols(x, lay, d, words=words)

        words = out.down_masks is not None and \
            out.down_masks.dtype == torch.int32
        return out._replace(
            task_vectors=whole(out.task_vectors),
            tau_hats=whole(out.tau_hats), alpha_num=whole(out.alpha_num),
            m_hats_dense=whole(out.m_hats_dense),
            down_unified=whole(out.down_unified),
            down_masks=whole(out.down_masks, words), d_pad=None)

    def downlinks(self, packed: PackedRound, out: EngineOutput, *,
                  code_masks: bool = False,
                  phase_us: Optional[Dict[str, float]] = None
                  ) -> Dict[int, ClientDownlink]:
        """Per-client downlinks of a finished round; ``code_masks``
        entropy-codes every client's mask rows in one batched call on
        the host (clients decode on use, ``ClientDownlink.mask_row``).
        ``phase_us`` accumulates the ``encode`` host µs.  A sharded
        round's downlink slices are gathered here, the wire boundary."""
        down_unified, down_masks = out.down_unified, out.down_masks
        if out.d_pad is not None:
            down_unified = gather_cols(down_unified, self.layout, packed.d)
            down_masks = gather_cols(down_masks, self.layout, packed.d,
                                     words=down_masks.dtype == torch.int32)
        return _assemble_downlinks(packed.client_ids, packed.task_ids,
                                   packed.d, down_unified, down_masks,
                                   out.down_lams, code_masks=code_masks,
                                   phase_us=phase_us)

    def round(self, uploads: Sequence[ClientUpload], *,
              mode: Optional[str] = None, packed: bool = True,
              code_masks: bool = False,
              staleness: Optional[Sequence[int]] = None,
              staleness_discount: float = STALENESS_DISCOUNT
              ) -> Tuple[Dict[int, ClientDownlink], EngineOutput]:
        """Pack → run → per-client downlinks; ``packed=False`` runs the
        bool/fp32 A/B layout; ``code_masks`` emits coded downlink masks
        (coded uploads are decoded by ``pack_uploads`` either way).
        ``staleness`` (one int per upload) attaches the per-slot
        discount ``staleness_discount**s`` (module docstring, "Async
        rounds").  On a mesh the returned output is whole
        (``gather_output``)."""
        batch = pack_uploads(uploads, self.cfg.n_tasks, packed=packed,
                             device=self.device, mesh=self.mesh)
        if staleness is not None:
            batch.slot_weights = torch.from_numpy(staleness_weights(
                staleness, batch.slot_valid.shape[1],
                staleness_discount)).to(self.device)
        out = self.gather_output(self.run_packed(batch, mode=mode), batch.d)
        return self.downlinks(batch, out, code_masks=code_masks), out

    def round_chunked(self, uploads, *, chunk_clients: int,
                      mode: Optional[str] = None, packed: bool = True,
                      code_masks: bool = False,
                      staleness: Optional[Sequence[int]] = None,
                      staleness_discount: float = STALENESS_DISCOUNT,
                      k_max: Optional[int] = None,
                      sink: Optional[Callable[
                          [Dict[int, ClientDownlink]], None]] = None,
                      phase_us: Optional[Dict[str, float]] = None
                      ) -> Tuple[Dict[int, ClientDownlink], EngineOutput,
                                 Dict[str, int]]:
        """One round streamed through a buffer of ``chunk_clients``
        clients: d-wide memory O(chunk + T·d) whatever N, and every
        output bit for bit :meth:`round`'s (module docstring,
        "Population-scale contract").

        ``uploads`` is a sequence of ClientUploads or a zero-argument
        callable returning a fresh iterator over the same uploads in the
        same order: the engine reads them twice (the Eq. 4 normaliser
        needs every client before any merge work).  ``sink``, if given,
        receives each phase-C chunk's ``{client_id: ClientDownlink}`` as
        it is made, and the returned dict stays empty.  The returned
        ``EngineOutput`` holds the round's task vectors, τ̂, S and
        alpha_num / n_held (m̂ in the bool layout), with the downlink
        fields None.  ``stats`` holds the measured ``uplink_bits`` and
        ``downlink_bits`` (the monolithic round's accounting),
        ``n_clients``, ``n_chunks`` and ``chunk_clients``.  ``phase_us``
        accumulates ``pack`` / ``decode`` / ``encode`` host µs.

        On a mesh each rank folds its d-slice, the returned output is
        whole, and every rank (and ``sink``) sees every downlink (module
        docstring, "Sharding contract")."""
        c_max = int(chunk_clients)
        if c_max < 1:
            raise ValueError(f"round_chunked: chunk_clients={c_max} < 1")
        make_iter = uploads if callable(uploads) else (lambda: iter(uploads))
        n_tasks, dev = self.cfg.n_tasks, self.device

        # -- pass 0: chunk metadata, host scalars only (no d-wide tensor)
        metas: List[tuple] = []
        cur: tuple = ([], [], [], [])
        stal_it = iter(staleness) if staleness is not None else None
        d, k_seen, n_clients = None, 1, 0
        for up in make_iter():
            if d is None:
                d = int(up.unified.shape[0])
            k_seen = max(k_seen, len(up.task_ids))
            cur[0].append(up.client_id)
            cur[1].append(list(up.task_ids))
            cur[2].append([float(x) for x in up.data_sizes])
            if stal_it is not None:
                cur[3].append(next(stal_it))
            n_clients += 1
            if len(cur[0]) == c_max:
                metas.append(cur)
                cur = ([], [], [], [])
        if cur[0]:
            metas.append(cur)
        if n_clients == 0:
            raise ValueError("round_chunked: empty round (no uploads); "
                             "sample at least one client or skip the round")
        if k_max is None:
            k_max = next_pow2(k_seen)
        elif k_max < k_seen:
            raise ValueError(f"round_chunked: k_max={k_max} < max client "
                             f"task count {k_seen}")

        def slots(tasks_):
            tk = torch.full((len(tasks_), k_max), n_tasks, dtype=torch.int32)
            vd = torch.zeros((len(tasks_), k_max), dtype=torch.bool)
            for i, tl in enumerate(tasks_):
                tk[i, :len(tl)] = torch.tensor(tl, dtype=torch.int32)
                vd[i, :len(tl)] = True
            return tk.to(dev), vd.to(dev)

        def weights(stal_):
            if staleness is None:
                return None
            return torch.from_numpy(staleness_weights(
                stal_, k_max, staleness_discount)).to(dev)

        # -- phase A: the round's (N, T) member and size tables, then γ
        members, sizes = [], []
        for _, tasks_, sizes_, stal_ in metas:
            tk, vd = slots(tasks_)
            sz = torch.zeros((len(tasks_), k_max), dtype=torch.float32)
            for i, sl in enumerate(sizes_):
                sz[i, :len(sl)] = torch.tensor(sl, dtype=torch.float32)
            m_rows, s_rows = ops.matu_chunk_scalars(
                sz.to(dev), vd, tk, n_tasks, slot_weights=weights(stal_),
                mode=mode)
            members.append(m_rows)
            sizes.append(s_rows)
        n_t, gammas = ops.matu_gammas(torch.cat(members), torch.cat(sizes))
        del members, sizes

        # -- phase B: second pass, fold the merge partials chunk by chunk
        # (on a mesh, every row of this rank's slice: no collective)
        lay, sharded = self.layout, self.n_shards > 1
        d_pad = pad_d_for_shards(d, self.n_shards)
        width = d_pad // self.n_shards
        a_acc = torch.zeros((n_tasks + 1, width), device=dev,
                            dtype=torch.int32 if packed else torch.float32)
        tau_acc = torch.zeros((n_tasks + 1, width), dtype=torch.float32,
                              device=dev)
        stage, mark = SlotStage(), None
        stream = make_iter()
        uplink_bits, row0 = 0, 0
        for ids_, _, _, stal_ in metas:
            ups = list(itertools.islice(stream, len(ids_)))
            if [u.client_id for u in ups] != ids_:
                raise ValueError(
                    "round_chunked: the upload factory returned a "
                    "different round on the second pass; it must be "
                    "deterministic (same clients, same order)")
            # the stage is refilled only once the fold that read it is done
            wait_ready(mark)
            batch = pack_uploads(ups, n_tasks, k_max=k_max, packed=packed,
                                 device=dev, stage=stage, phase_us=phase_us,
                                 mesh=self.mesh)
            uplink_bits += batch.wire_bits()
            g_rows = gammas[row0:row0 + len(ids_)]
            row0 += len(ids_)
            args = (batch.unified, batch.slot_masks, batch.slot_lams,
                    batch.slot_valid, batch.slot_tasks, g_rows, a_acc,
                    tau_acc)
            kw = dict(slot_weights=weights(stal_), mode=mode)
            if packed:
                ops.matu_merge_chunk_packed(*args, width, **kw)
            else:
                ops.matu_merge_chunk(*args, **kw)
            mark = ready_mark(dev)
        del stage, batch

        # -- finish: Eq. 3 m̂, τ̂, Eq. 5-7 from the accumulators (on a
        # mesh: the dots psum, then one psum of the per-task λ numerators)
        cfg = self.cfg
        kw = dict(rho=cfg.rho, eps=cfg.eps, kappa=cfg.kappa,
                  cross_task=cfg.cross_task, uniform_cross=cfg.uniform_cross,
                  mode=mode)
        if sharded:
            kw.update(group=lay.group, d_norm=d)
        tag = d_pad if sharded else None
        if packed:
            tv, tau_hats, a_num, n_t, sim = ops.matu_finish_packed(
                a_acc, tau_acc, n_t, n_clients, d=width, **kw)
            out = EngineOutput(tv, tau_hats, sim, None, None, None,
                               alpha_num=a_num, n_held=n_t, rho=cfg.rho,
                               d_pad=tag)
        else:
            tv, tau_hats, m_hats, n_t, sim = ops.matu_finish(
                a_acc, tau_acc, n_t, **kw)
            out = EngineOutput(tv, tau_hats, sim, None, None, None,
                               rho=cfg.rho, m_hats_dense=m_hats, d_pad=tag)
        del a_acc, tau_acc
        shard_kw = {}
        if sharded:
            shard_kw = dict(group=lay.group, axis_sizes=lay.axis_sizes,
                            num_t=ops.matu_lam_num(
                                tv, group=lay.group,
                                axis_sizes=lay.axis_sizes))
        out = self.gather_output(out, d)

        # -- phase C: each chunk's downlinks, streamed out (on a mesh, one
        # λ-den psum a chunk, the rows split over the slot shards)
        down = (ops.matu_downlink_chunk_packed if packed
                else ops.matu_downlink_chunk)
        downlinks: Dict[int, ClientDownlink] = {}
        downlink_bits = 0
        for ids_, tasks_, _, _ in metas:
            tk, vd = slots(tasks_)
            rows = len(ids_)
            if self.slot_shards > 1:
                per = -(-rows // self.slot_shards)
                pad = per * self.slot_shards - rows
                tk = torch.nn.functional.pad(tk, (0, 0, 0, pad),
                                             value=n_tasks)
                vd = torch.nn.functional.pad(vd, (0, 0, 0, pad))
                r0 = lay.row * per
                tk, vd = tk[r0:r0 + per], vd[r0:r0 + per]
            du, dm, dl = down(tv, vd, tk, mode=mode, **shard_kw)
            if sharded:
                du = gather_cols(du, lay, d)
                dm = gather_cols(dm, lay, d, words=packed)
            if self.slot_shards > 1:
                du, dm, dl = (sharding.gather(x, lay.row_group, dim=0)[:rows]
                              for x in (du, dm, dl))
            links = _assemble_downlinks(ids_, tasks_, d, du, dm, dl,
                                        code_masks=code_masks,
                                        phase_us=phase_us)
            downlink_bits += sum(link.downlink_bits()
                                 for link in links.values())
            if sink is not None:
                sink(links)
            else:
                downlinks.update(links)
        stats = {"uplink_bits": uplink_bits, "downlink_bits": downlink_bits,
                 "n_clients": n_clients, "n_chunks": len(metas),
                 "chunk_clients": c_max}
        return downlinks, out, stats

    def round_stream(self, rounds, *, mode: Optional[str] = None,
                     packed: bool = True, code_masks: bool = False,
                     pipeline: bool = True):
        """Run an iterable of upload rounds through the two-deep host
        pipeline (module docstring, "Host pipeline"): while round r's
        kernels run, the host drains round r−1 (waits for its ready
        point, encodes its downlinks, yields) and packs round r+1 into
        the other :class:`SlotStage`.

        Yields ``(downlinks, out, phase_us)`` per round, in input order;
        ``phase_us`` maps ``pack`` / ``decode`` / ``encode`` / ``device``
        to host µs (``device`` is dispatch to ready).  ``pipeline=False``
        is the strictly sequential escape hatch, bit-identical.  Rounds
        are pulled one ahead of the yields, so the iterable must not
        depend on the previous round's downlinks (replayed traffic).  On
        a mesh each round's output is gathered whole when it is drained."""
        if not pipeline:
            for ups in rounds:
                phase: Dict[str, float] = {}
                batch = pack_uploads(ups, self.cfg.n_tasks, packed=packed,
                                     device=self.device, phase_us=phase,
                                     mesh=self.mesh)
                t0 = time.perf_counter()
                out = self.run_packed(batch, mode=mode)
                wait_ready(ready_mark(self.device))
                phase["device"] = (time.perf_counter() - t0) * 1e6
                out = self.gather_output(out, batch.d)
                yield (self.downlinks(batch, out, code_masks=code_masks,
                                      phase_us=phase), out, phase)
            return

        stages = (SlotStage(), SlotStage())
        prev = None
        for r, ups in enumerate(rounds):
            phase = {}
            # stage r % 2 was last read by round r − 2, drained before
            # this point: never in flight
            batch = pack_uploads(ups, self.cfg.n_tasks, packed=packed,
                                 device=self.device, stage=stages[r % 2],
                                 phase_us=phase, mesh=self.mesh)
            out = self.run_packed(batch, mode=mode)
            words = None
            if code_masks and out.d_pad is None:
                words = host_copy_async(
                    out.down_masks if batch.packed
                    else bitpack.pack_bits(out.down_masks))
            pend = (batch, out, phase, time.perf_counter(),
                    ready_mark(self.device), words)
            if prev is not None:
                yield self._drain_round(prev, code_masks)
            prev = pend
        if prev is not None:
            yield self._drain_round(prev, code_masks)

    def _drain_round(self, pend, code_masks: bool):
        """Wait for a dispatched round and build its downlinks: the host
        half the pipeline overlaps with the NEXT round's kernels."""
        batch, out, phase, t_disp, mark, words = pend
        wait_ready(mark)
        phase["device"] = (time.perf_counter() - t_disp) * 1e6
        out = self.gather_output(out, batch.d)
        return (_assemble_downlinks(batch.client_ids, batch.task_ids,
                                    batch.d, out.down_unified,
                                    out.down_masks, out.down_lams,
                                    code_masks=code_masks, phase_us=phase,
                                    host_words=words), out, phase)


def batched_client_unify(task_vectors: torch.Tensor, valid: torch.Tensor, *,
                         packed: bool = True, device: DeviceLike = "cuda",
                         mode: Optional[str] = None, mesh=None):
    """All clients' upload construction in one fused call on ``device``.

    task_vectors (N, k_max, d) zero-padded stacks; valid (N, k_max).
    Returns the uplink wire format: (unified (N, d) bf16, mask_words
    (N, k_max, ceil(d/32)) int32, lams (N, k_max) fp32) — row n is
    ``unify_with_modulators(task_vectors[n, valid[n]])`` with the
    unified vector rounded to bf16 after masks and λ were derived from
    it in fp32.  ``packed=False`` returns the bool/fp32 A/B layout:
    (unified (N, d) fp32, masks (N, k_max, d) bool, lams) with the same
    mask bits and λ bit for bit.

    With ``mesh`` each rank pads d to ``pad_d_for_shards`` and runs the
    kernel on its own d-slice; the λ num/den roots cross ranks in one
    psum (``ref._lam_totals``) before the division.  The returned
    unified vectors and masks are the rank's slices, as
    ``pack_from_slots(..., d=d, mesh=mesh)`` takes them."""
    dev = resolve_device(device)
    lay, n_shards = _mesh_layout(mesh)
    if n_shards == 1:
        fn = ops.fused_unify_packed if packed else ops.fused_unify
        return fn(task_vectors.to(dev), valid.to(dev), mode=mode)
    d = int(task_vectors.shape[-1])
    width = pad_d_for_shards(d, n_shards) // n_shards
    local = _slice_cols(task_vectors.to(dev), lay.shard * width, width)
    uni, masks, num, den = ops.fused_unify_raw(local, valid.to(dev),
                                               packed=packed, mode=mode)
    num, den = ref._lam_totals((num, den), lay.group, lay.axis_sizes)
    return uni, masks, num / torch.clamp(den, min=1e-12)  # kernel 1's eps
