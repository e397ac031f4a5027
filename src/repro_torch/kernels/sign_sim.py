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

Each kernel has two routes, chosen by T in the wrapper
(:func:`packed_plan`, :func:`dense_plan`): T <= 64 takes the int8 tensor
cores (each block owns one word or coordinate range; a sum kernel adds
the blocks' int32 partials in the same C call, and for the dense kernel
writes S), T > 64 the first design (pairs on ``__popc`` / ``__dp4a``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (CudaKernel, on_device, require_cuda,
                                      sm_count, stream_handle)

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
KERNEL = CudaKernel("sign_sim_packed", "sign_sim.cu", "sign_sim_packed_launch",
                    [_P, _P, _I, _LL, _I, _I, _LL, _P, _LL, _P, _P])
KERNEL_DENSE = CudaKernel("sign_sim", "sign_sim.cu", "sign_sim_launch",
                          [_P, _I, _LL, _I, _I, _LL, _F, _P, _LL, _P, _P])

plain = ref.sign_sim_packed_ref
plain_dense = ref.sign_sim_ref

_SMEM = 48 * 1024      # static shared-memory budget of one block
_MAX_W = 256           # words a block stages per task (both kernels)


def words_per_block(t: int) -> int:
    """Largest word range W whose pos/nz tiles for ``t`` tasks
    (2·t·(W+1) words, rows padded by one) fit in 48 KB."""
    return min(_MAX_W, _SMEM // (8 * t) - 1)


MMA_MAX_T = 64         # the tensor-core route's task rows (4 tiles of 16)
MMA_BLOCKS_PER_SM = 2
MMA_CHUNK = 64         # words a block stages at a time, for every row
MMA_STAGES = 3         # chunks in flight
ROUTES = ("popc", "mma")   # index = the C call's route argument


def packed_plan(t: int, w: int, sms: int = 132, route: str | None = None):
    """The packed kernel's launch plan for (T, w) planes on a card of
    ``sms`` SMs: (blocks, words a block, route).  By default T <= 64
    takes the tensor cores ("mma"): two blocks a SM, each owning one
    range of a multiple of 4 words, the ranges covering [0, w) once;
    T > 64 the first design ("popc", :func:`words_per_block` words a
    block).  ``route="popc"`` takes the first design at any T."""
    if route not in (None, *ROUTES):
        raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")
    if route == "mma" and t > MMA_MAX_T:
        raise ValueError(f"the tensor cores take T <= {MMA_MAX_T}, got {t}")
    if route == "popc" or t > MMA_MAX_T:
        per = words_per_block(t)
        return -(-w // per), per, "popc"
    per = -(-w // (MMA_BLOCKS_PER_SM * sms))
    per = max(4, -(-per // 4) * 4)
    return -(-w // per), per, "mma"


def packed_smem(t: int) -> int:
    """Shared-memory bytes of a tensor-core block for ``t`` tasks: the
    stage ring of both planes for 16, 32 or 64 rows, each row padded to
    68 words (``mma_smem`` in ``csrc/sign_sim.cu``), and each plane row's
    window start (8 bytes) and offset (4)."""
    rows = 16 if t <= 16 else 32 if t <= 32 else 64
    return MMA_STAGES * 2 * rows * (MMA_CHUNK + 4) * 4 + 2 * rows * 12


def packed_workspace(t: int, blocks: int, route: str) -> int:
    """int32 words of either C call's workspace: one partial a block and
    pair on the tensor-core route ("mma"), the (T, T) sums on the first
    designs ("popc", "dp4a")."""
    return blocks * (t * (t + 1) // 2) if route == "mma" else t * t


DENSE_ROUTES = ("dp4a", "mma")   # index = the dense C call's route argument
DENSE_K = 32           # coordinates of one k-step (mma.sync.m16n8k32.s8)


def dense_blocks_per_sm(t: int) -> int:
    """Blocks a SM of the dense tensor-core route: two, one for T > 32
    (whose 20 tiles' accumulators take a block's registers)."""
    return 1 if t > 32 else 2


def dense_plan(t: int, d: int, sms: int = 132, route: str | None = None):
    """The dense kernel's launch plan for (T, d) fp32 on a card of ``sms``
    SMs: (blocks, coordinates a block, route).  By default T <= 64 takes
    the tensor cores ("mma"): :func:`dense_blocks_per_sm` blocks a SM,
    each owning one range of a multiple of :data:`DENSE_K` coordinates,
    the ranges covering [0, d) once; T > 64 the first design ("dp4a",
    4 · :func:`sign_words_per_block` coordinates a block).
    ``route="dp4a"`` takes the first design at any T."""
    if route not in (None, *DENSE_ROUTES):
        raise ValueError(f"unknown route {route!r}; expected one of "
                         f"{DENSE_ROUTES}")
    if route == "mma" and t > MMA_MAX_T:
        raise ValueError(f"the tensor cores take T <= {MMA_MAX_T}, got {t}")
    if route == "dp4a" or t > MMA_MAX_T:
        per = 4 * sign_words_per_block(t)
        return -(-d // per), per, "dp4a"
    per = -(-d // (dense_blocks_per_sm(t) * sms))
    per = max(DENSE_K, -(-per // DENSE_K) * DENSE_K)
    return -(-d // per), per, "mma"


def dense_smem(t: int) -> int:
    """Shared-memory bytes of a dense tensor-core block for ``t`` tasks:
    its 8 warps' int32 accumulator fragments over the upper-triangle
    16 x 8 tiles of 16, 32 or 64 rows (``dense_smem`` in
    ``csrc/sign_sim.cu``)."""
    mt = 1 if t <= 16 else 2 if t <= 32 else 4
    return 8 * mt * (mt + 1) * 4 * 32 * 4


def reciprocal(d: int) -> float:
    """fl32(1 / fl32(d)): the factor by which torch divides a CUDA tensor
    by the Python scalar d (``ref.sim_from_dots`` on the card), which the
    dense C call's S takes."""
    return float(np.float32(1.0) / np.float32(d))


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


def sign_sim_packed_cuda(pos: torch.Tensor, nz: torch.Tensor,
                         route: str | None = None) -> torch.Tensor:
    """The kernel path of :func:`sign_sim_packed`: one C call, whose
    output is the fp32 dots (no fill, no conversion launch).  ``route``
    is :func:`packed_plan`'s: "popc" runs the first design at any T, so
    the two routes can be held against each other."""
    require_cuda(pos, "pos", (torch.int32,), 2)
    require_cuda(nz, "nz", (torch.int32,), 2)
    if pos.shape != nz.shape or pos.device != nz.device:
        raise ValueError(f"pos {tuple(pos.shape)} and nz {tuple(nz.shape)} "
                         f"must match")
    t, w = pos.shape
    if words_per_block(t) < 1 or w < 1:
        raise ValueError(f"sign_sim_packed takes T <= {_SMEM // 16} and "
                         f"w >= 1, got {(t, w)}")
    blocks, per, route = packed_plan(t, w, sm_count(pos.device.index),
                                     route)
    ws = torch.empty((packed_workspace(t, blocks, route),), dtype=torch.int32,
                     device=pos.device)
    dots = torch.empty((t, t), dtype=torch.float32, device=pos.device)
    with on_device(pos):
        KERNEL.launch(pos.data_ptr(), nz.data_ptr(), t, w,
                      ROUTES.index(route), blocks, per, ws.data_ptr(),
                      ws.numel(), dots.data_ptr(), stream_handle(pos))
    return dots


def sign_sim_cuda(tau_hats: torch.Tensor,
                  route: str | None = None) -> torch.Tensor:
    """The kernel path of :func:`sign_sim`: one C call, whose output is S
    (no fill, no torch launch after it).  ``route`` is
    :func:`dense_plan`'s: "dp4a" runs the first design at any T, so the
    two routes can be held against each other."""
    require_cuda(tau_hats, "tau_hats", (torch.float32,), 2)
    t, d = tau_hats.shape
    if sign_words_per_block(t) < 1 or d < 1:
        raise ValueError(f"sign_sim takes T <= {_SMEM // 8} and d >= 1, got "
                         f"{(t, d)}")
    blocks, per, route = dense_plan(t, d, sm_count(tau_hats.device.index),
                                    route)
    ws = torch.empty((packed_workspace(t, blocks, route),), dtype=torch.int32,
                     device=tau_hats.device)
    sim = torch.empty((t, t), dtype=torch.float32, device=tau_hats.device)
    with on_device(tau_hats):
        KERNEL_DENSE.launch(tau_hats.data_ptr(), t, d,
                            DENSE_ROUTES.index(route), blocks, per,
                            reciprocal(d), ws.data_ptr(), ws.numel(),
                            sim.data_ptr(), stream_handle(tau_hats))
    return sim
