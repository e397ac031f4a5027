"""Entropy-coded mask transport for MaTU: the Golomb-Rice layer under
the packed wire, the JAX package's ``fed/compression.py``.

Every MaTU round ships bf16 unified vectors and bit-packed mask words
(1 bit a coordinate; :mod:`repro_torch.core.engine`'s wire format).
This module is the layer below: an invertible entropy coder over the
packed words, so the biased modulator masks (P(1) ≈ 0.75 on a client's
own tasks, the regime DeltaMask, Tsouvalas et al. 2023, targets) go out
under 1 bit a coordinate.  The coder is numpy on the host, copied from
the JAX package; its streams are byte-identical to the JAX package's.
The coded layer never enters the device round: the engine decodes
coded uploads at the host edge and encodes downlinks there.

Coder: vectorised Golomb-Rice over the gaps between the rarer symbol's
positions, with a self-describing 5-byte header, so decode needs only
``d`` and the byte stream.  Stream layout (little-endian, bit streams
LSB-first, the convention of :mod:`repro_torch.kernels.bitpack`):

  byte 0    bit 0: polarity  (1 → coded positions are the SET bits,
                              0 → coded positions are the CLEAR bits)
            bit 1: raw escape (1 → payload is the packed words
                              verbatim, 4·ceil(d/32) bytes; emitted only
                              when the Rice payload would be larger, so
                              coded ≤ raw + header at ANY density)
            bits 3-7: Rice parameter k ∈ [0, 31]
  bytes 1-4 uint32 run count n (number of coded positions)
  payload   unary section: for each of the n gaps, ``gap >> k`` zero
            bits then a one bit; THEN the remainder section: n·k bits,
            the low k bits of each gap, LSB-first per symbol.  Padded
            with zero bits to a byte boundary.

The first n one-bits of the payload are the n unary terminators, so
decode is vectorised: one ``np.flatnonzero`` gives every quotient and
one reshape every remainder.

:func:`encode_mask_rows` / :func:`decode_mask_rows` process all
(client × slot) mask rows in one vectorised pass; their stream is
byte-identical to concatenating the scalar :func:`rice_encode_words`
records (kept as the parity oracle, ``*_reference``).  Both directions
stream in bounded chunks (``_ENC_CHUNK_BITS``, ``_DEC_WINDOW_BYTES`` /
``_DEC_DENSE_BITS``) fanned out over a shared thread pool
(``REPRO_CODER_WORKERS`` sets its size, 1 runs sequentially); records
self-delimit, so neither the chunking nor the pool can change a byte,
and streams of several clients concatenate.

Accounting is measured: :func:`coded_mask_bits` /
:func:`golomb_encode_bits` return 8× the stream length the decoder
consumes (header included); :func:`mask_entropy_bits` is the Shannon
bound for comparison.  :func:`compressed_uplink_bits` adds the bf16
vector and the scalers.  Torch tensors cross into the coder only as
numpy ``<u4`` words (:func:`repro_torch.kernels.bitpack.words_to_numpy`
/ ``words_from_numpy``), by their bits, never by a value cast.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.bitpack import (pack_bits_np, packed_width,
                                         scatter_bits_np, unpack_bits_np,
                                         words_to_numpy)

HEADER_BYTES = 5
_POLARITY_BIT = 0x01
_RAW_BIT = 0x02
_K_SHIFT = 3


class CodedStreamError(ValueError):
    """A coded byte stream failed validation during decode.

    Raised (instead of a mis-decode, IndexError, or silent garbage) for
    every malformed-input class an adversarial or fault-injected wire
    can produce: truncated header, truncated raw-escape payload,
    truncated unary/remainder sections, a run count whose positions
    point past ``d``, and trailing bytes after the expected row count.
    Subclasses ``ValueError``; an async round server catches this type
    to quarantine the upload."""

# Streaming bounds for the batched coder.  Chunks keep every numpy
# intermediate a few MB — far below glibc's mmap threshold — so the
# allocator hands back the SAME warm pages chunk after chunk instead of
# mmap/munmap-ing a fresh couple-hundred-MB temporary per vector op
# (each of which costs a full page-fault sweep on first touch; on the
# 1-core host that made a monolithic pass ~30x slower than the same
# FLOPs on warm buffers).  Records self-delimit and concatenate, so
# chunking cannot change a single output byte.
_ENC_CHUNK_BITS = 1 << 21   # mask bits (rows × d) encoded per chunk
_DEC_WINDOW_BYTES = 1 << 17  # stream bytes unpacked per decode chunk
_DEC_DENSE_BITS = 1 << 22   # dense (rows × d) reconstructed per chunk

# Because chunking is byte-invisible (records self-delimit and every
# chunk's extent is known before any chunk runs), the chunks are
# INDEPENDENT — so on a multi-core host both directions fan them out
# over a shared thread pool (numpy releases the GIL for the big
# unpack/scatter/packbits passes).  ``executor.map`` preserves chunk
# order, so the concatenated stream / row writes are byte-for-byte the
# sequential ones no matter how the pool schedules — enforced by the
# monkeypatched-tiny-chunk parity tests.
# REPRO_CODER_WORKERS overrides the worker count (1 → sequential).
_pool: Optional[ThreadPoolExecutor] = None
_pool_workers = 0


def _coder_workers() -> int:
    env = os.environ.get("REPRO_CODER_WORKERS")
    return int(env) if env else (os.cpu_count() or 1)


def _coder_pool() -> Optional[ThreadPoolExecutor]:
    """The shared coder pool, or None on a 1-worker host (sequential
    fallback — identical bytes either way)."""
    global _pool, _pool_workers
    n = _coder_workers()
    if n <= 1:
        return None
    if _pool is None or _pool_workers != n:
        _pool = ThreadPoolExecutor(max_workers=n,
                                   thread_name_prefix="rice-coder")
        _pool_workers = n
    return _pool

# (256, 8) lookup: _NTH_ONE[v, i] = LSB-first bit index of the
# (i+1)-th set bit of byte value v (8 where v has fewer ones).  With
# the cumulative byte popcount this turns "position of the n-th
# one-bit" into one searchsorted + one table load — the decoder's
# boundary walk never unpacks bits it will not decode.
_NTH_ONE = np.full((256, 8), 8, np.int8)
for _v in range(256):
    _idx = np.flatnonzero(
        np.unpackbits(np.array([_v], np.uint8), bitorder="little"))
    _NTH_ONE[_v, :_idx.size] = _idx
del _v, _idx
# plain-Python twin for the decoder's boundary walk (no numpy-scalar
# boxing in the per-record hot loop)
_NTH_ONE_L = _NTH_ONE.tolist()


def mask_entropy_bits(mask: np.ndarray) -> float:
    """Shannon bound for transmitting a binary mask of this density."""
    p = float(np.clip(np.mean(mask), 1e-6, 1 - 1e-6))
    h = -(p * math.log2(p) + (1 - p) * math.log2(1 - p))
    return h * mask.size


def _best_rice_k(gaps: np.ndarray) -> int:
    """Rice parameter minimizing the exact payload bits, searched in a
    window around the ``floor(log2(mean gap))`` estimate (the optimum
    for the geometric gap distribution of a Bernoulli mask lives
    there).  Exact integer arithmetic — ``floor(log2(sum // n)) ==
    floor(log2(sum / n))`` for any integers, so the vectorized
    :func:`_rice_k_rows` selector reproduces this bit for bit (ties go
    to the smaller k in both)."""
    n = gaps.size
    q = int(np.sum(gaps)) // n
    k0 = q.bit_length() - 1 if q >= 1 else 0
    best_k, best_bits = 0, None
    for k in range(max(0, k0 - 3), min(31, k0 + 3) + 1):
        bits = int(np.sum(gaps >> k)) + n * (k + 1)
        if best_bits is None or bits < best_bits:
            best_k, best_bits = k, bits
    return best_k


def _rice_k_rows(gaps: np.ndarray, starts: np.ndarray, counts: np.ndarray
                 ) -> np.ndarray:
    """Vectorized :func:`_best_rice_k` over row segments of one flat
    ``gaps`` array (``starts``/``counts`` delimit non-empty segments).
    Candidate window, exact bit counts (``np.add.reduceat`` on int64),
    and first-minimum tie-breaking all match the scalar scan — the
    clipped candidates are non-decreasing in window position, so
    ``argmin`` picking the first minimum IS the ascending-k scan."""
    sums = np.add.reduceat(gaps, starts)
    q = (sums // counts).astype(np.float64)     # exact: q < 2**53
    k0 = np.maximum(np.frexp(q)[1] - 1, 0)      # floor(log2(q)); 0 at q=0
    rows_ix = np.arange(counts.size)
    cand_k = np.empty((7, counts.size), np.int64)
    cand_bits = np.empty((7, counts.size), np.int64)
    lo = int(np.clip(k0 - 3, 0, 31).min())
    hi = int(np.clip(k0 + 3, 0, 31).max())
    if hi - lo <= 12:
        # near-uniform densities (every real round): evaluate the union
        # of the rows' candidate windows with SCALAR shifts — one
        # in-place ``>>= 1`` + one segment-sum per global candidate, no
        # per-gap gather — then assemble each row's own 7 candidates
        # from the table.  Identical bit counts, identical argmin.
        table = np.empty((hi - lo + 1, counts.size), np.int64)
        sh = np.right_shift(gaps, lo)
        table[0] = np.add.reduceat(sh, starts)
        for b in range(1, hi - lo + 1):
            sh >>= 1
            table[b] = np.add.reduceat(sh, starts)
        for j in range(7):
            kc = np.clip(k0 - 3 + j, 0, 31).astype(np.int64)
            cand_k[j] = kc
            cand_bits[j] = table[kc - lo, rows_ix] + counts * (kc + 1)
    else:                       # wildly mixed densities: per-gap shifts
        seg = np.repeat(np.arange(counts.size), counts)
        for j in range(7):
            kc = np.clip(k0 - 3 + j, 0, 31).astype(np.int64)
            cand_k[j] = kc
            cand_bits[j] = (np.add.reduceat(gaps >> kc[seg], starts)
                            + counts * (kc + 1))
    return cand_k[np.argmin(cand_bits, axis=0), rows_ix]


def rice_encode_words(words: np.ndarray, d: int) -> np.ndarray:
    """Encode ONE packed mask row (``ceil(d/32)`` uint32 words, the
    :mod:`repro_torch.kernels.bitpack` layout) into a self-describing uint8
    stream.  Exactly invertible by :func:`rice_decode_words` given only
    ``d``; never more than ``HEADER_BYTES`` over the raw packed words
    (the raw-escape mode)."""
    words = np.ascontiguousarray(np.asarray(words, np.uint32).ravel())
    if words.size != packed_width(d):
        raise ValueError(f"rice_encode_words: {words.size} words != "
                         f"packed_width({d}) = {packed_width(d)}")
    bits = unpack_bits_np(words, d)
    n_set = int(bits.sum())
    polarity = 1 if 2 * n_set <= d else 0
    positions = np.flatnonzero(bits if polarity else ~bits)
    n = positions.size

    raw_payload = words.astype("<u4").view(np.uint8)
    if n == 0:
        header = np.zeros(HEADER_BYTES, np.uint8)
        header[0] = polarity
        return header

    gaps = np.diff(positions.astype(np.int64), prepend=-1) - 1
    k = _best_rice_k(gaps)
    qs = gaps >> k
    unary_len = int(qs.sum()) + n
    total_bits = unary_len + n * k
    if -(-total_bits // 8) >= raw_payload.size:      # raw escape
        header = np.zeros(HEADER_BYTES, np.uint8)
        header[0] = polarity | _RAW_BIT
        return np.concatenate([header, raw_payload])

    stream_bits = np.zeros(total_bits, np.uint8)
    stream_bits[np.cumsum(qs + 1) - 1] = 1           # unary terminators
    if k:
        rem = ((gaps[:, None] >> np.arange(k, dtype=np.int64)) & 1)
        stream_bits[unary_len:] = rem.astype(np.uint8).ravel()
    header = np.zeros(HEADER_BYTES, np.uint8)
    header[0] = polarity | (k << _K_SHIFT)
    header[1:5] = np.array([n], "<u4").view(np.uint8)
    return np.concatenate([header,
                           np.packbits(stream_bits, bitorder="little")])


def rice_decode_words(stream: np.ndarray, d: int
                      ) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`rice_encode_words`: ``(words, consumed_bytes)``
    from a stream that may carry further rows after this one.  Needs
    only ``d`` — polarity, Rice parameter, and run count come from the
    header."""
    stream = np.asarray(stream, np.uint8).ravel()
    if stream.size < HEADER_BYTES:
        raise CodedStreamError("rice_decode_words: truncated header")
    flags = int(stream[0])
    polarity = flags & _POLARITY_BIT
    w = packed_width(d)
    # any single record is ≤ header + raw payload (the escape rule), so
    # later rows in a multi-row stream never need to be unpacked here —
    # keeps decode_mask_rows linear in the total stream length
    stream = stream[:HEADER_BYTES + 4 * w]
    if flags & _RAW_BIT:
        end = HEADER_BYTES + 4 * w
        words = stream[HEADER_BYTES:end].view("<u4").astype(np.uint32)
        if words.size != w:
            raise CodedStreamError("rice_decode_words: truncated raw payload")
        return words, end
    k = flags >> _K_SHIFT
    n = int(stream[1:5].view("<u4")[0])
    if n == 0:
        bits = np.zeros(d, bool) if polarity else np.ones(d, bool)
        return pack_bits_np(bits), HEADER_BYTES

    payload_bits = np.unpackbits(stream[HEADER_BYTES:], bitorder="little")
    ones = np.flatnonzero(payload_bits)
    if ones.size < n:
        raise CodedStreamError("rice_decode_words: truncated unary section")
    ends = ones[:n]                                  # unary terminators
    qs = np.diff(ends, prepend=-1) - 1
    unary_len = int(ends[-1]) + 1
    gaps = qs.astype(np.int64) << k
    if k:
        rem = payload_bits[unary_len:unary_len + n * k]
        if rem.size < n * k:
            raise CodedStreamError("rice_decode_words: truncated remainders")
        gaps += rem.reshape(n, k) @ (1 << np.arange(k, dtype=np.int64))
    positions = np.cumsum(gaps + 1) - 1
    if positions[-1] >= d:
        raise CodedStreamError("rice_decode_words: position beyond d")
    bits = np.zeros(d, bool) if polarity else np.ones(d, bool)
    bits[positions] = bool(polarity)
    consumed = HEADER_BYTES + -(-(unary_len + n * k) // 8)
    return pack_bits_np(bits), consumed


def encode_mask_rows_reference(words: np.ndarray, d: int) -> np.ndarray:
    """Scalar row-by-row encoder (the retained reference): one
    :func:`rice_encode_words` record per row, concatenated.  The
    batched :func:`encode_mask_rows` is byte-identical to this — the
    parity is enforced on the adversarial-density grid in
    the coder's tests."""
    words = np.asarray(words, np.uint32)
    if words.ndim == 1:
        words = words[None]
    parts = [rice_encode_words(row, d) for row in words]
    return (np.concatenate(parts) if parts else np.zeros(0, np.uint8))


def decode_mask_rows_reference(stream: np.ndarray, d: int, k: int
                               ) -> np.ndarray:
    """Scalar row-by-row decoder (the retained reference for the
    batched :func:`decode_mask_rows`)."""
    stream = np.asarray(stream, np.uint8).ravel()
    out = np.empty((k, packed_width(d)), np.uint32)
    off = 0
    for i in range(k):
        row, used = rice_decode_words(stream[off:], d)
        out[i] = row
        off += used
    if off != stream.size:
        raise CodedStreamError(f"decode_mask_rows: {stream.size - off} trailing "
                         f"bytes after {k} rows")
    return out


def _encode_rows_chunk(words: np.ndarray, d: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One bounded chunk of the batched encoder (all intermediates are
    a few MB and int32 — the chunk invariant ``rows × d ≤
    _ENC_CHUNK_BITS`` keeps every bit offset and position below 2³¹)."""
    r = words.shape[0]
    w = packed_width(d)

    # polarity from word popcounts (O(w), no dense sum), then flip the
    # minority-symbol selection on the WORDS — one conditional xor per
    # row plus a tail-word fix keeps the dense layer to a single unpack
    n_set = np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    polarity = 2 * n_set <= d                              # (r,) bool
    n = np.where(polarity, n_set, d - n_set)               # coded positions
    coded_words = np.where(polarity[:, None], words,
                           words ^ np.uint32(0xFFFFFFFF))
    if d % 32:                                             # tail bits stay 0
        coded_words[:, -1] &= np.uint32((1 << (d % 32)) - 1)
    flat = np.flatnonzero(unpack_bits_np(coded_words, d))  # row-major

    active = n > 0
    n_act = n[active]
    a = n_act.size
    sizes = np.full(r, HEADER_BYTES, np.int64)
    flags = polarity.astype(np.uint8)
    if a == 0:                                             # headers only
        out = np.zeros(int(sizes.sum()), np.uint8)
        out[np.concatenate(([0], np.cumsum(sizes)[:-1]))] = flags
        return out, sizes

    starts = np.concatenate(([0], np.cumsum(n_act)[:-1]))

    # shared gap extraction: consecutive differences of the row-major
    # flat positions are the in-row gaps everywhere except each row's
    # first position, whose gap is its offset from the row origin —
    # one diff + a scatter fix-up at the row starts, no per-gap
    # row-id/previous-position arrays
    gaps = np.empty(flat.size, np.int32)
    if flat.size:
        gaps[0] = 1                                        # overwritten below
        np.subtract(flat[1:], flat[:-1], out=gaps[1:], casting="unsafe")
        gaps -= 1
        act_rows = np.flatnonzero(active)
        gaps[starts] = flat[starts] - act_rows * np.int64(d)

    seg = np.repeat(np.arange(a, dtype=np.int32), n_act)
    k_act = _rice_k_rows(gaps, starts, n_act)
    k_uni = int(k_act[0]) if k_act.min() == k_act.max() else None
    if k_uni is not None:                      # one k for every row —
        qs = gaps >> np.int32(k_uni)           # scalar shifts, no gather
        k_seg = None
    else:
        k_seg = k_act.astype(np.int32)[seg]
        qs = gaps >> k_seg
    unary_len = np.add.reduceat(qs, starts).astype(np.int64) + n_act
    total_bits = unary_len + n_act * k_act
    rice_bytes = -(-total_bits // 8)
    raw = rice_bytes >= 4 * w                              # raw escape
    sizes[active] = HEADER_BYTES + np.where(raw, 4 * w, rice_bytes)
    flags[active] |= np.where(raw, _RAW_BIT,
                              k_act << _K_SHIFT).astype(np.uint8)

    offsets = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    total = int(sizes.sum())
    off_act = offsets[active]

    rice = ~raw
    if rice.any():
        # prefix-sum bit-scatter: every Rice row's unary terminators and
        # remainder bits land in ONE bit-space covering the whole stream
        # (header / raw-payload byte regions stay zero there and are
        # written byte-aligned below — the regions are disjoint)
        all_rice = not raw.any()
        bit_base = (8 * (off_act + HEADER_BYTES)).astype(np.int32)
        cum = np.cumsum(qs + np.int32(1), dtype=np.int32)
        before = np.concatenate(
            ([0], cum[starts[1:] - 1])).astype(np.int32)
        row_term = bit_base - before                       # per-row offset
        row_term -= 1
        term = row_term[seg]
        term += cum
        if all_rice:
            positions = [term]
        else:
            rice_gap = rice[seg]
            positions = [term[rice_gap]]
        kmax = int(k_act[rice].max(initial=0))
        if kmax:
            rem_row = bit_base + unary_len.astype(np.int32)
            if k_uni is not None:                  # fused arange stride
                rem_row -= np.int32(k_uni) * starts.astype(np.int32)
                rem_at = rem_row[seg]
                rem_at += np.arange(0, k_uni * gaps.size, k_uni,
                                    dtype=np.int32)
            else:
                rem_at = rem_row[seg]
                j_local = np.arange(gaps.size, dtype=np.int32)
                j_local -= starts.astype(np.int32)[seg]
                rem_at += j_local * k_seg
            for b in range(kmax):
                hit = (gaps & np.int32(1 << b)).astype(bool)
                if k_uni is None:
                    hit &= k_seg > b
                if not all_rice:
                    hit &= rice_gap
                positions.append(rem_at[hit] + b)
        out = scatter_bits_np(np.concatenate(positions), total)
    else:
        out = np.zeros(total, np.uint8)

    out[offsets] = flags
    off_rice = off_act[rice]
    if off_rice.size:                                      # uint32 run count
        out[off_rice[:, None] + np.arange(1, 5)] = (
            n_act[rice].astype("<u4").view(np.uint8).reshape(-1, 4))
    if raw.any():                                          # raw payloads
        raw_rows = np.flatnonzero(active)[raw]
        payload = (np.ascontiguousarray(words[raw_rows]).astype("<u4")
                   .view(np.uint8).reshape(raw_rows.size, 4 * w))
        out[off_act[raw][:, None] + HEADER_BYTES + np.arange(4 * w)] = payload
    return out, sizes


def encode_mask_rows_with_sizes(words: np.ndarray, d: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched encoder core: vectorized over ALL rows →
    ``(stream, per_row_record_bytes)``.  The sizes array lets callers
    split the one concatenated stream back into per-client slices
    (``np.add.reduceat`` / cumsum over the client's row counts) without
    re-encoding — the engine's downlink path and the strategy's uplink
    path both encode the whole round in one call.

    Rows are processed in ``_ENC_CHUNK_BITS``-bounded chunks (records
    concatenate, so the output is byte-for-byte independent of the
    chunking) to keep the working set in warm allocator pages."""
    words = np.asarray(words, np.uint32)
    if words.ndim == 1:
        words = words[None]
    r = words.shape[0]
    w = packed_width(d)
    if r == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    if words.shape[-1] != w:
        raise ValueError(f"encode_mask_rows: {words.shape[-1]} words/row "
                         f"!= packed_width({d}) = {w}")
    rows_per = max(1, _ENC_CHUNK_BITS // (32 * w))
    if r <= rows_per:
        return _encode_rows_chunk(words, d)
    chunk_starts = range(0, r, rows_per)
    pool = _coder_pool()
    if pool is None:
        parts = [_encode_rows_chunk(words[i:i + rows_per], d)
                 for i in chunk_starts]
    else:
        # independent chunks on the pool; map preserves chunk order, so
        # the concatenation is byte-identical to the sequential loop
        parts = list(pool.map(
            lambda i: _encode_rows_chunk(words[i:i + rows_per], d),
            chunk_starts))
    streams, sizes = zip(*parts)
    return np.concatenate(streams), np.concatenate(sizes)


def encode_mask_rows(words: np.ndarray, d: int) -> np.ndarray:
    """Encode a ``(k, ceil(d/32))`` stack of packed mask rows (or one
    1-D row) into one concatenated uint8 stream — each row's record is
    self-delimiting, so :func:`decode_mask_rows` walks it with only
    ``d`` and the row count.  Batched: all rows encode in one
    vectorized numpy pass, byte-identical to the scalar
    :func:`encode_mask_rows_reference`."""
    return encode_mask_rows_with_sizes(words, d)[0]


def _decode_rice_chunk(stream: np.ndarray, out: np.ndarray, d: int,
                       lo: int, hi: int, rows: np.ndarray, kk: np.ndarray,
                       n: np.ndarray, pb: np.ndarray, unary: np.ndarray,
                       pol: np.ndarray) -> None:
    """Vectorized reconstruction of one bounded group of Rice records
    (stream bytes ``[lo, hi)``; ``rows × d ≤ _DEC_DENSE_BITS`` keeps
    the dense scratch and every int32 index in range).  Writes the
    decoded packed words into ``out[rows]``."""
    win = np.unpackbits(stream[lo:hi], bitorder="little")
    ones = np.flatnonzero(win).astype(np.int32)
    pb_rel = (pb - 8 * lo).astype(np.int32)
    j0 = np.searchsorted(ones, pb_rel).astype(np.int32)
    nr = rows.size
    g = int(n.sum())
    starts = np.concatenate(([0], np.cumsum(n)[:-1]))
    starts32 = starts.astype(np.int32)
    seg = np.repeat(np.arange(nr, dtype=np.int32), n)
    idx = (j0 - starts32)[seg]
    idx += np.arange(g, dtype=np.int32)
    ends = ones[idx]
    # consecutive terminator differences are quotients + 1 in-row; the
    # row starts take the distance from the record's payload base —
    # one diff + a scatter fix-up, mirroring the encoder's gap pass
    q = np.empty(g, np.int32)
    q[0] = 1                                   # overwritten by fix-up
    np.subtract(ends[1:], ends[:-1], out=q[1:])
    q -= 1
    q[starts] = ends[starts] - pb_rel
    kmax = int(kk.max())
    k_uni = int(kk[0]) if int(kk.min()) == kmax else None
    # a corrupt stream can carry quotients/k that overflow 32 bits
    # before the position validation below fires — the scalar
    # reference raises there, so widen whenever quotient<<k could
    # exceed int32 even on garbage input (quotient < window bits)
    wide = kmax + (8 * (hi - lo)).bit_length() > 31
    gaps = q.astype(np.int64) if wide else q
    k_seg = None
    if k_uni is not None:
        if k_uni:
            gaps <<= k_uni
    else:
        k_seg = kk.astype(np.int32)[seg]
        gaps = gaps << k_seg
    if kmax:
        dt = np.int64 if wide else np.int32
        rem_row = pb_rel + unary.astype(np.int32)
        if k_uni is not None:
            rem_row -= np.int32(k_uni) * starts32
            rem_at = rem_row[seg]
            rem_at += np.arange(0, k_uni * g, k_uni, dtype=np.int32)
            for b in range(kmax):
                gaps += win[rem_at + b].astype(dt) << b
        else:
            rem_at = rem_row[seg]
            wk = np.arange(g, dtype=np.int32)
            wk -= starts32[seg]
            rem_at += wk * k_seg
            for b in range(kmax):
                sel = k_seg > b
                gaps[sel] += win[rem_at[sel] + b].astype(dt) << b
    cum = np.cumsum(gaps + 1, dtype=np.int64)
    before = np.concatenate(([0], cum[starts[1:] - 1]))
    positions = cum
    positions -= before[seg]
    positions -= 1
    if int(positions[np.cumsum(n) - 1].max()) >= d:
        raise CodedStreamError("rice_decode_words: position beyond d")
    # scatter the coded symbol's positions, pack, then flip rows whose
    # polarity coded the CLEAR bits at the word level (tail bits reset)
    dense = np.zeros((nr, d), bool)
    scat = seg * np.int64(d)
    scat += positions
    dense.reshape(-1)[scat] = True
    wout = pack_bits_np(dense)
    flip = ~pol
    if flip.any():
        wout[flip] ^= np.uint32(0xFFFFFFFF)
        if d % 32:
            wout[flip, -1] &= np.uint32((1 << (d % 32)) - 1)
    out[rows] = wout


def decode_mask_rows(stream: np.ndarray, d: int, k: int) -> np.ndarray:
    """Inverse of :func:`encode_mask_rows` → ``(k, ceil(d/32))`` uint32
    words, bit-identical to what was encoded.  Batched in two phases:
    a light O(k) boundary walk (records self-delimit, so each record's
    extent needs only its unary span — one ``searchsorted`` into the
    stream's cumulative byte popcount plus an n-th-set-bit table load,
    no bit unpacking), then windowed vectorized reconstruction of the
    Rice records' gaps, remainders, and positions in
    ``_DEC_WINDOW_BYTES``/``_DEC_DENSE_BITS``-bounded chunks.  Because
    records self-delimit, ``stream`` may be several clients' uploads
    concatenated — ``k`` is the total row count across them."""
    stream = np.asarray(stream, np.uint8).ravel()
    w = packed_width(d)
    out = np.empty((k, w), np.uint32)
    if k == 0:
        if stream.size:
            raise CodedStreamError(f"decode_mask_rows: {stream.size} trailing "
                             "bytes after 0 rows")
        return out

    # cpc[j] = one-bits in stream[:j] — the walk's only global scan
    cpc = np.zeros(stream.size + 1, np.int64)
    np.cumsum(np.bitwise_count(stream), dtype=np.int64, out=cpc[1:])

    # phase 1: boundary walk.  The chain is inherently serial (each
    # record's extent gates the next record's offset) and a global bit
    # unpack would break the bounded-memory contract, so instead of
    # vectorising across records the walk batches each step down to
    # pure-Python byte reads (memoryview + int.from_bytes — no numpy
    # slice/view per record) plus ONE C binary search confined to the
    # record's own ≤ 4w-byte window of the popcount prefix (the raw
    # escape bounds every record, so the window always brackets the
    # terminator) — identical offsets and errors to the original
    # full-array walk, at a fraction of the per-record overhead.
    mv = stream.data
    size = stream.size
    cpc_at = cpc.item              # unboxed scalar reads in the loop
    nth_l = _NTH_ONE_L             # (cpc stays numpy: tolist() would
    search = cpc.searchsorted      # cost O(stream) Python ints)
    empty_rows, empty_pol = [], []
    raw_rows, raw_offs = [], []
    rice = dict(row=[], kk=[], n=[], pb=[], unary=[], pol=[], end=[])
    (r_row, r_kk, r_n, r_pb, r_unary, r_pol, r_end) = (
        rice["row"].append, rice["kk"].append, rice["n"].append,
        rice["pb"].append, rice["unary"].append, rice["pol"].append,
        rice["end"].append)
    raw_len = HEADER_BYTES + 4 * w
    off = 0
    for i in range(k):
        if off + HEADER_BYTES > size:
            raise CodedStreamError("rice_decode_words: truncated header")
        flags = mv[off]
        pol = flags & _POLARITY_BIT
        if flags & _RAW_BIT:
            if off + raw_len > size:
                raise CodedStreamError("rice_decode_words: truncated raw payload")
            raw_rows.append(i)
            raw_offs.append(off + HEADER_BYTES)
            off += raw_len
            continue
        n = int.from_bytes(mv[off + 1:off + 5], "little")
        if n == 0:
            empty_rows.append(i)
            empty_pol.append(pol)
            off += HEADER_BYTES
            continue
        pb_byte = off + HEADER_BYTES
        lim_byte = pb_byte + 4 * w
        if lim_byte > size:
            lim_byte = size
        target = cpc_at(pb_byte) + n
        if target > cpc_at(lim_byte):
            raise CodedStreamError("rice_decode_words: truncated unary section")
        # byte holding the n-th one-bit after pb, then the bit within
        # it; cpc[pb] < target ≤ cpc[lim] brackets the terminator, so
        # the global search equals a window search and stays O(log S)
        jbyte = int(search(target, side="left")) - 1
        bit = nth_l[mv[jbyte]][target - cpc_at(jbyte) - 1]
        kk = flags >> _K_SHIFT
        unary = 8 * (jbyte - pb_byte) + bit + 1
        if unary + n * kk > 8 * (lim_byte - pb_byte):
            raise CodedStreamError("rice_decode_words: truncated remainders")
        r_row(i)
        r_kk(kk)
        r_n(n)
        r_pb(8 * pb_byte)
        r_unary(unary)
        r_pol(pol)
        off += HEADER_BYTES + -(-(unary + n * kk) // 8)
        r_end(off)
    if off != size:
        raise CodedStreamError(f"decode_mask_rows: {size - off} trailing "
                         f"bytes after {k} rows")

    # phase 2: vectorized reconstruction
    if empty_rows:
        pol = np.asarray(empty_pol, bool)
        fill = np.where(pol[:, None], np.zeros(w, np.uint32),
                        pack_bits_np(np.ones(d, bool))[None])
        out[np.asarray(empty_rows)] = fill
    if raw_rows:
        if len(raw_rows) * 4 * w <= 1 << 21:
            idx = np.asarray(raw_offs)[:, None] + np.arange(4 * w)
            out[np.asarray(raw_rows)] = (np.ascontiguousarray(stream[idx])
                                         .view("<u4").astype(np.uint32))
        else:                       # big rows: per-row views, no index grid
            for i, o in zip(raw_rows, raw_offs):
                out[i] = stream[o:o + 4 * w].view("<u4").astype(np.uint32)
    if rice["row"]:
        rows = np.asarray(rice["row"])
        kk = np.asarray(rice["kk"], np.int64)
        n = np.asarray(rice["n"], np.int64)
        pb = np.asarray(rice["pb"], np.int64)
        unary = np.asarray(rice["unary"], np.int64)
        pol = np.asarray(rice["pol"], bool)
        end = np.asarray(rice["end"], np.int64)
        lo = pb // 8
        nr = rows.size
        spans = []
        i0 = 0
        while i0 < nr:               # bounded windows over the records
            i1 = i0 + 1
            while (i1 < nr and end[i1] - lo[i0] <= _DEC_WINDOW_BYTES
                   and (i1 + 1 - i0) * d <= _DEC_DENSE_BITS):
                i1 += 1
            spans.append((i0, i1))
            i0 = i1

        def _one(span):
            a, b = span
            sl = slice(a, b)
            _decode_rice_chunk(stream, out, d, int(lo[a]), int(end[b - 1]),
                               rows[sl], kk[sl], n[sl], pb[sl], unary[sl],
                               pol[sl])

        pool = _coder_pool()
        if pool is None or len(spans) == 1:
            for span in spans:
                _one(span)
        else:
            # windows write DISJOINT out[rows] regions, so pooled
            # execution is race-free and bit-identical; map raises the
            # first window's CodedStreamError like the loop would
            list(pool.map(_one, spans))
    return out


def coded_mask_bits(masks, d: int) -> int:
    """Measured coded size (bits) of a mask stack in any layout the
    stack travels in — packed uint32 words, dense bool rows, or an
    already-coded uint8 stream (returned as-is)."""
    m = np.asarray(masks)
    if m.dtype == np.uint8:
        return 8 * m.size
    if m.dtype != np.uint32:
        m = pack_bits_np(m.astype(bool))
    return 8 * int(encode_mask_rows(m, d).size)


def golomb_encode_bits(mask: np.ndarray) -> int:
    """Measured bit count of the shipped Golomb-Rice stream for one
    dense mask — 8× the byte length of :func:`rice_encode_words` on its
    packed words, header (polarity + Rice parameter + run count)
    included, so this is exactly what a decoder consumes.

    (The pre-coder version of this function under-counted: it derived
    the Golomb parameter from the data without transmitting it and
    charged an all-ones mask 1 bit — undecodable accounting.  Kept
    under its old name; it now delegates to the real coder.)"""
    flat = np.asarray(mask, bool).ravel()
    return 8 * int(rice_encode_words(pack_bits_np(flat), flat.size).size)


def quantize_bf16_transport(v: torch.Tensor) -> torch.Tensor:
    """The bf16 wire transport (any batch shape, on ``v``'s device): the
    single definition of what the compressed unified vector is."""
    return v.to(torch.bfloat16).to(torch.float32)


def quantize_bf16(v: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """bf16 transport of ONE unified vector; returns (vector, cosine)."""
    q = quantize_bf16_transport(v)
    denom = torch.linalg.norm(v) * torch.linalg.norm(q) + 1e-12
    return q, float(torch.dot(v.float(), q) / denom)


def _host_masks(masks) -> np.ndarray:
    """A mask stack as numpy: int32 words by their bits (``<u4``), a
    uint8 stream and bool rows as they are."""
    if isinstance(masks, torch.Tensor):
        if masks.dtype == torch.int32:
            return words_to_numpy(masks)
        return masks.detach().cpu().numpy()
    return np.asarray(masks)


def compressed_uplink_bits(unified: torch.Tensor, masks, *,
                           use_entropy_bound: bool = False,
                           n_rows: Optional[int] = None) -> int:
    """Total uplink bits of one client under the coded scheme: 16d (the
    bf16 vector; an fp32 vector is accounted at the bf16 transport it
    would use) + per mask row the MEASURED coded stream + a 32-bit
    scaler.  ``masks`` may be dense bool rows, the packed int32 wire
    words, or an already-coded uint8 stream (then its length is used
    and ``n_rows`` says how many scalers ride along, matching
    ``ClientUpload.uplink_bits`` on the same buffers).  With
    ``use_entropy_bound`` the mask term is the Shannon bound instead:
    the comparison axis, not a transmittable size."""
    d = int(unified.shape[0])
    total = 16 * d
    m = _host_masks(masks)
    if m.dtype == np.uint8:
        if n_rows is None:
            raise ValueError("compressed_uplink_bits: an already-coded "
                             "uint8 stream needs n_rows for the scaler "
                             "accounting (or use ClientUpload.uplink_bits)")
        if not use_entropy_bound:
            return total + 8 * m.size + 32 * n_rows
        # bound comparison asked for: decode back to rows and fall
        # through to the Shannon term
        m = decode_mask_rows(m, d, n_rows)
    if m.ndim == 1:
        m = m[None]
    k = m.shape[0]
    if use_entropy_bound:
        rows = unpack_bits_np(m, d) if m.dtype == np.uint32 else m
        p = np.clip(rows.mean(axis=1), 1e-6, 1 - 1e-6)
        h = -(p * np.log2(p) + (1 - p) * np.log2(1 - p)) * d
        return total + int(np.ceil(h).sum()) + 32 * k
    # measured: ONE batched encode of all rows; the concatenated stream's
    # length is the sum of the per-row records
    words = m if m.dtype == np.uint32 else pack_bits_np(m.astype(bool))
    return total + 8 * int(encode_mask_rows(words, d).size) + 32 * k
