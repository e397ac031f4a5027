"""Per-request modulated LoRA matmul for multi-tenant serving:
``y_b = x_b @ (base + λ_b · m_b ⊙ τ)`` with each request's modulator
mask kept bit-packed until the kernel builds its weight tile.

CUDA twin of the JAX package's ``modulated_matmul_pallas``;
``csrc/modulated_matmul.cu`` holds the kernel and its design note.  Its
plain version (:func:`repro_torch.kernels.ref.modulated_matmul_ref`,
unpack then matmul) builds the same effective weights bit for bit; the
product sums in another order, so the two agree to fp32 tolerance (and
bit for bit with ``x = I``, where every output is one exact product).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bitpack, ref
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("modulated_matmul", "modulated_matmul.cu",
                    "modulated_matmul_launch",
                    [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P])

plain = ref.modulated_matmul_ref


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
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), base.data_ptr(), tau.data_ptr(),
                      int(tau.dtype == torch.bfloat16), words.data_ptr(),
                      lam.data_ptr(), b, s, k, n, y.data_ptr(),
                      stream_handle(x))
    return y
