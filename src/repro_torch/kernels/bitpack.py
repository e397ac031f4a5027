"""Bit-packed mask wire format: the port's single definition of the layout.

The layout is the JAX package's, bit for bit:

* element ``j`` of a d-length mask lives in word ``j // 32``, bit
  ``j % 32``, **LSB-first**;
* a d-length mask occupies ``packed_width(d) = ceil(d / 32)`` words;
* tail bits of the last word are always zero.

Words live in torch as **int32 bit patterns**: CPU torch implements
neither ``>>``/``<<`` nor ``index_put_`` for ``torch.uint32``.  At the
wire edge they are viewed as numpy ``<u4`` (:func:`words_to_numpy`,
:func:`words_from_numpy`), which is byte-identical to the JAX package's
``uint32`` words.  Packing and unpacking work on the words' bytes
(uint8), and the popcount on int64 copies in [0, 2**32), so no shift
ever runs on int32: its arithmetic right shift would smear a set bit 31.

Sign bit-planes: ``pos = pack(x > 0)`` and ``nz = pos | pack(x < 0)``;
the Eq. 5 sign dot is then popcount algebra (:func:`packed_sign_dots`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

WORD_BITS = 32
_U32 = 1 << 32


def packed_width(d: int) -> int:
    """Words per d-length mask: ceil(d / 32)."""
    return -(-d // WORD_BITS)


def wire_bits(d: int, k: int, *, vec_bytes_per_elem: int = 2,
              float_bits: int = 32) -> int:
    """Measured wire size of one client's packed upload/downlink: the
    vector buffer (bf16 by default) + ``k`` packed mask rows + one
    scaler per row."""
    return (8 * vec_bytes_per_elem * d
            + k * (8 * 4 * packed_width(d) + float_bits))


if sys.byteorder != "little":   # the byte views below assume it
    raise ImportError("repro_torch.kernels.bitpack needs a little-endian host")


def _byte_shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def _to_u32_values(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 in [0, 2**32)."""
    return words.to(torch.int64) & (_U32 - 1)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., d) bool/{0,1} -> (..., ceil(d/32)) int32 words, LSB-first;
    tail bits beyond d are zero.  Packs 8 bits per byte and views each
    4 bytes as one little-endian word (``np.packbits(bitorder='little')``
    in torch), so no wide intermediate is made."""
    d = mask.shape[-1]
    bits = (mask.view(torch.uint8) if mask.dtype == torch.bool
            else mask.to(torch.uint8))
    pad = (-d) % WORD_BITS
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (-1, 8))
    packed = torch.sum(bits << _byte_shifts(mask.device), dim=-1,
                       dtype=torch.uint8)
    return packed.reshape(packed.shape[:-1] + (-1, 4)).view(torch.int32)[..., 0]


def unpack_bits(words: torch.Tensor, d: int,
                dtype: torch.dtype = torch.bool) -> torch.Tensor:
    """(..., w) int32 words -> (..., d) of ``dtype`` (bool by default)."""
    u8 = words.contiguous().view(torch.uint8)           # (..., 4w) bytes
    bits = (u8[..., None] >> _byte_shifts(words.device)) & 1
    flat = bits.reshape(bits.shape[:-2] + (-1,))
    return flat[..., :d].to(dtype)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 words -> numpy ``<u4`` (the JAX package's uint32 layout)."""
    return words.detach().cpu().contiguous().numpy().view(np.dtype("<u4"))


def words_from_numpy(words: np.ndarray) -> torch.Tensor:
    """numpy uint32 words -> int32 bit patterns (CPU tensor)."""
    arr = np.ascontiguousarray(np.asarray(words).astype("<u4", copy=False))
    return torch.from_numpy(arr.view(np.int32).copy())


def pack_bits_np(mask: np.ndarray) -> np.ndarray:
    """Host-side packer (same layout as :func:`pack_bits`), via
    ``np.packbits(bitorder='little')`` and a little-endian uint32 view."""
    mask = np.asarray(mask, bool)
    d = mask.shape[-1]
    pad = (-d) % WORD_BITS
    if pad:
        mask = np.concatenate(
            [mask, np.zeros(mask.shape[:-1] + (pad,), bool)], axis=-1)
    packed_u8 = np.packbits(mask, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed_u8).view(np.dtype("<u4"))


def unpack_bits_np(words: np.ndarray, d: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_bits_np` -> (..., d) bool."""
    words = np.asarray(words).astype("<u4", copy=False)
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :d].astype(bool)


def scatter_bits_np(positions: np.ndarray, n_bytes: int) -> np.ndarray:
    """Set the given bit positions (LSB-first within each byte) in a
    zeroed ``n_bytes``-byte buffer: the batched Golomb-Rice encoder's
    bit-scatter (:mod:`repro_torch.fed.compression`).  One fancy-index
    write in bit space and one ``np.packbits``: duplicate byte indices
    are fine because the OR happens where positions are unique."""
    bit_space = np.zeros(8 * n_bytes, np.uint8)
    if positions.size:
        bit_space[positions] = 1
    return np.packbits(bit_space, bitorder="little")


def _from_u32_values(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 bit patterns."""
    return torch.where(v >= 1 << 31, v - _U32, v).to(torch.int32)


def slice_bits(words: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """Re-aligned bit-range extract: bits ``[start, start + length)`` of
    a packed row as ``ceil(length/32)`` words whose bit 0 is the bit at
    ``start`` (LSB-first, zero tail bits).  Each output word is the OR
    of two shifted neighbour words, so one manifest leaf's mask bits come
    out of a whole-d row without unpacking.  ``words`` may carry leading
    batch axes.  The shifts run on int64 copies in [0, 2**32): a right
    shift of int32 would sign-extend a set bit 31."""
    if length < 0 or start < 0:
        raise ValueError(f"slice_bits needs start/length >= 0, got "
                         f"({start}, {length})")
    n_out = packed_width(length)
    w0, sh = start // WORD_BITS, start % WORD_BITS
    need = n_out + (1 if sh else 0)
    avail = words.shape[-1] - w0
    if avail < need:   # zero-pad so the shifted neighbour read is safe
        words = torch.nn.functional.pad(words, (0, need - avail))
    lo = _to_u32_values(words[..., w0:w0 + n_out])
    if sh:
        hi = _to_u32_values(words[..., w0 + 1:w0 + 1 + n_out])
        out = ((lo >> sh) | (hi << (WORD_BITS - sh))) & (_U32 - 1)
    else:
        out = lo
    tail = length % WORD_BITS
    if tail and n_out:   # zero the tail bits past `length` (layout rule)
        out[..., -1] &= (1 << tail) - 1
    return _from_u32_values(out)


def sign_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack ``sgn(x)`` over the last axis into (pos, nz) bit-planes."""
    pos = pack_bits(x > 0)
    return pos, pos | pack_bits(x < 0)


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int64 values in [0, 2**32) (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & (_U32 - 1)) >> 24


def packed_sign_dots(pos: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """Pairwise sign dots Σ_j sgn(x_t)_j · sgn(x_t')_j from (T, w)
    bit-planes: popcnt(both) − 2·popcnt(both & (pos ⊕ pos')) with
    ``both = nz & nz'``.  Returns (T, T) int32, exact.  One row of pairs
    at a time keeps the temporaries at (T, w)."""
    p, z = _to_u32_values(pos), _to_u32_values(nz)
    rows = []
    for t in range(p.shape[0]):
        both = z[t] & z
        diff = both & (p[t] ^ p)
        rows.append(_popcount(both).sum(-1) - 2 * _popcount(diff).sum(-1))
    if not rows:
        return torch.zeros((0, 0), dtype=torch.int32, device=pos.device)
    return torch.stack(rows).to(torch.int32)
