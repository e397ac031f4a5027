"""Per-request modulated LoRA matmul for multi-tenant serving:
``y_b = x_b @ (base + λ_b · m_b ⊙ τ)`` with each request's modulator
mask kept bit-packed until the kernel builds its weight tile.

CUDA twin of the JAX package's ``modulated_matmul_pallas``;
``csrc/modulated_matmul.cu`` holds the kernels and their design note.
One C call takes one route: at decode (``S <= DECODE_MAX_S``) the
split-K kernel over the chunks of :func:`decode_chunks`, followed by a
fixed-order sum of the chunks' partials; at prefill, by
:func:`prefill_route`, the narrow-K kernel (every LoRA "b" factor), the
narrow-N kernel (every "a" factor) or the general tile, each output one
FMA chain over K in ascending order.  Its
plain version (:func:`repro_torch.kernels.ref.modulated_matmul_ref`,
unpack then matmul) builds the same effective weights bit for bit; the
product sums in another order, so the two agree to fp32 tolerance (and
bit for bit with ``x = I``, where every output is one exact product).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import bitpack, ref
from repro_torch.kernels.build import (CudaKernel, on_device, require_cuda,
                                      stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("modulated_matmul", "modulated_matmul.cu",
                    "modulated_matmul_launch",
                    [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P])

plain = ref.modulated_matmul_ref

# The decode route (the kernel's DECODE_MAX_S and KC_MAX): S up to
# DECODE_MAX_S splits K into chunks of CHUNK_MIN to CHUNK_MAX rows, a
# multiple of ROW_STEP, about TARGET_CHUNKS of them: at B = 8 and N = 16
# that is ~2 blocks for each of the H100's 132 SMs.
DECODE_MAX_S = 16
CHUNK_MIN, CHUNK_MAX, ROW_STEP = 16, 128, 16
TARGET_CHUNKS = 33


def decode_chunks(k: int) -> Tuple[int, int]:
    """(rows per chunk, number of chunks) of the decode route's split of
    K.  It depends on K alone, so the order of every sum, and with it
    request b's outputs, does not depend on the batch."""
    rows = -(-k // TARGET_CHUNKS)
    rows = min(CHUNK_MAX, max(CHUNK_MIN, -(-rows // ROW_STEP) * ROW_STEP))
    return rows, -(-k // rows)


def decode_workspace_shape(b: int, s: int, k: int, n: int
                           ) -> Optional[Tuple[int, int, int, int]]:
    """(B, chunks, S, N): the fp32 partials the decode route sums, or
    None where the call writes y directly (prefill, or one chunk)."""
    chunks = decode_chunks(k)[1]
    if s > DECODE_MAX_S or chunks == 1:
        return None
    return (b, chunks, s, n)


# The prefill routes (S > DECODE_MAX_S), chosen in the C call from the
# leaf's shape: K up to NARROW takes the narrow-K kernel, else N up to
# NARROW the narrow-N kernel, else the general tile.
NARROW = 32


def prefill_route(k: int, n: int) -> str:
    """The prefill route of a (K, N) leaf: "narrow_k", "narrow_n" or
    "tile"."""
    if k <= NARROW:
        return "narrow_k"
    return "narrow_n" if n <= NARROW else "tile"


def check_aligned(k: int, n: int) -> None:
    if (k * n) % bitpack.WORD_BITS:
        raise ValueError(f"modulated_matmul needs a word-aligned leaf "
                         f"(K*N % 32 == 0), got {(k, n)}")


def modulated_matmul(x, base, tau, words, lam) -> torch.Tensor:
    """x (B, S, K) fp32; base (K, N) fp32; tau (K, N) fp32/bf16; words
    (B, K·N/32) int32; lam (B,) fp32 -> (B, S, N) fp32.  CPU tensors
    take the plain version; CUDA tensors take the kernel."""
    check_aligned(*base.shape)
    if x.device.type == "cpu":
        return plain(x, base, tau, words, lam)
    return modulated_matmul_cuda(x, base, tau, words, lam)


def modulated_matmul_cuda(x, base, tau, words, lam) -> torch.Tensor:
    """The kernel path of :func:`modulated_matmul` (CUDA tensors only)."""
    require_cuda(x, "x", (torch.float32,), 3)
    require_cuda(base, "base", (torch.float32,), 2)
    require_cuda(tau, "tau", (torch.float32, torch.bfloat16), 2)
    require_cuda(words, "words", (torch.int32,), 2)
    require_cuda(lam, "lam", (torch.float32,), 1)
    b, s, k = x.shape
    k2, n = base.shape
    check_aligned(k2, n)
    if (k2 != k or tuple(tau.shape) != (k, n)
            or tuple(words.shape) != (b, k * n // bitpack.WORD_BITS)
            or tuple(lam.shape) != (b,)):
        raise ValueError(f"modulated_matmul shapes do not fit: x "
                         f"{tuple(x.shape)}, base {tuple(base.shape)}, tau "
                         f"{tuple(tau.shape)}, words {tuple(words.shape)}, "
                         f"lam {tuple(lam.shape)}")
    if not 1 <= b <= 65535 or s < 1:
        raise ValueError(f"modulated_matmul takes 1 <= B <= 65535 and "
                         f"S >= 1, got B={b}, S={s}")
    y = torch.empty((b, s, n), dtype=torch.float32, device=x.device)
    ws_shape = decode_workspace_shape(b, s, k, n)
    ws = (None if ws_shape is None else
          torch.empty(ws_shape, dtype=torch.float32, device=x.device))
    with on_device(x):
        KERNEL.launch(x.data_ptr(), base.data_ptr(), tau.data_ptr(),
                      int(tau.dtype == torch.bfloat16), words.data_ptr(),
                      lam.data_ptr(), b, s, k, n, decode_chunks(k)[0],
                      None if ws is None else ws.data_ptr(), y.data_ptr(),
                      stream_handle(x))
    return y
