"""Eq. 5 sign dots, from packed sign bit-planes (popcount form) or from
dense fp32 task vectors.

CUDA twins of the JAX package's ``sign_sim_packed_pallas``
(``sign_sim_packed``: raw (T, T) dots, the caller normalises by the
unpacked d) and ``sign_sim_pallas`` (``sign_sim``, the bool/fp32 A/B
layout: S = ½(dots/d + 1)); ``csrc/sign_sim.cu`` holds the kernels and
their design note.  The dots are exact integers, so kernel and plain
version (:func:`repro_torch.kernels.ref.sign_sim_packed_ref`,
:func:`~repro_torch.kernels.ref.sign_sim_ref`) agree exactly, and S is
bitwise the same in both layouts.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("sign_sim_packed", "sign_sim.cu", "sign_sim_packed_launch",
                    [_P, _P, _I, _LL, _I, _P, _P])
KERNEL_DENSE = CudaKernel("sign_sim", "sign_sim.cu", "sign_sim_launch",
                          [_P, _I, _LL, _I, _P, _P])

plain = ref.sign_sim_packed_ref
plain_dense = ref.sign_sim_ref

_SMEM = 48 * 1024      # static shared-memory budget of one block
_MAX_W = 256           # words a block stages per task (both kernels)


def words_per_block(t: int) -> int:
    """Largest word range W whose pos/nz tiles for ``t`` tasks
    (2·t·(W+1) words, rows padded by one) fit in 48 KB."""
    return min(_MAX_W, _SMEM // (8 * t) - 1)


def sign_words_per_block(t: int) -> int:
    """Largest range of WW int8x4 sign words (4·WW coordinates) whose
    tile for ``t`` tasks (t·(WW+1) words) fits in 48 KB."""
    return min(_MAX_W, _SMEM // (4 * t) - 1)


def sign_sim_packed(pos: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """(T, T) fp32 sign dots from (T, w) int32 planes.  CPU tensors take
    the plain version; CUDA tensors take the kernel."""
    if pos.device.type == "cpu":
        return plain(pos, nz)
    return sign_sim_packed_cuda(pos, nz)


def sign_sim(tau_hats: torch.Tensor) -> torch.Tensor:
    """Eq. 5 similarity S = ½(sgn(τ̂)·sgn(τ̂)ᵀ/d + 1), (T, T) fp32, from
    (T, d) fp32.  CPU tensors take the plain version; CUDA tensors take
    the kernel."""
    if tau_hats.device.type == "cpu":
        return plain_dense(tau_hats)
    return sign_sim_cuda(tau_hats)


def sign_sim_packed_cuda(pos: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """The kernel path of :func:`sign_sim_packed`."""
    require_cuda(pos, "pos", (torch.int32,), 2)
    require_cuda(nz, "nz", (torch.int32,), 2)
    if pos.shape != nz.shape or pos.device != nz.device:
        raise ValueError(f"pos {tuple(pos.shape)} and nz {tuple(nz.shape)} "
                         f"must match")
    t, w = pos.shape
    blk = words_per_block(t)
    if blk < 1 or w < 1:
        raise ValueError(f"sign_sim_packed takes T <= {_SMEM // 16} and "
                         f"w >= 1, got {(t, w)}")
    dots = torch.zeros((t, t), dtype=torch.int32, device=pos.device)
    with torch.cuda.device(pos.device):
        KERNEL.launch(pos.data_ptr(), nz.data_ptr(), t, w, blk,
                      dots.data_ptr(), stream_handle(pos))
    return dots.float()


def sign_sim_cuda(tau_hats: torch.Tensor) -> torch.Tensor:
    """The kernel path of :func:`sign_sim`."""
    require_cuda(tau_hats, "tau_hats", (torch.float32,), 2)
    t, d = tau_hats.shape
    blk = sign_words_per_block(t)
    if blk < 1 or d < 1:
        raise ValueError(f"sign_sim takes T <= {_SMEM // 8} and d >= 1, got "
                         f"{(t, d)}")
    dots = torch.zeros((t, t), dtype=torch.int32, device=tau_hats.device)
    with torch.cuda.device(tau_hats.device):
        KERNEL_DENSE.launch(tau_hats.data_ptr(), t, d, blk, dots.data_ptr(),
                            stream_handle(tau_hats))
    return ref.sim_from_dots(dots, d)
