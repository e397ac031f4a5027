"""Eq. 5 sign dots from packed sign bit-planes (popcount form).

CUDA twin of the JAX package's ``sign_sim_packed_pallas``
(``csrc/sign_sim.cu`` holds the kernel and its design note).  Returns
the raw (T, T) dots in fp32 — exact integers, so kernel and plain
version (:func:`repro_torch.kernels.ref.sign_sim_packed_ref`) agree
exactly; the caller normalises by the unpacked d.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("sign_sim_packed", "sign_sim.cu", "sign_sim_packed_launch",
                    [_P, _P, _I, _LL, _I, _P, _P])

plain = ref.sign_sim_packed_ref

_SMEM = 48 * 1024      # static shared-memory budget of one block
_MAX_W = 256           # words a block stages per task


def words_per_block(t: int) -> int:
    """Largest word range W whose pos/nz tiles for ``t`` tasks
    (2·t·(W+1) words, rows padded by one) fit in 48 KB."""
    return min(_MAX_W, _SMEM // (8 * t) - 1)


def sign_sim_packed(pos: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """(T, T) fp32 sign dots from (T, w) int32 planes.  CPU tensors take
    the plain version; CUDA tensors take the kernel."""
    if pos.device.type == "cpu":
        return plain(pos, nz)
    return sign_sim_packed_cuda(pos, nz)


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
