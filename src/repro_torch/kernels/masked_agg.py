"""Eq. 3 + Eq. 4 (agreement + task merge): whole-round, every task in
one launch, over packed mask words or dense bool masks; and one task
alone.

CUDA twins of the JAX package's ``masked_agg_batched_packed_pallas``
(``masked_agg_batched_packed``: outputs τ̂ and the agreement numerator),
``masked_agg_batched_pallas`` (``masked_agg_batched``, the bool/fp32
A/B layout: outputs τ̂ and m̂) and ``masked_agg_pallas``
(``masked_agg``: one task, membership from γ > 0, outputs τ̂ and m̂);
``csrc/masked_agg.cu`` holds the kernels and their design note.  Their
plain versions (:func:`repro_torch.kernels.ref.masked_agg_batched_packed_ref`,
:func:`~repro_torch.kernels.ref.masked_agg_batched_ref`,
:func:`~repro_torch.kernels.ref.masked_agg_ref`) sum the clients in the
kernels' order with the kernels' roundings, so kernel and plain version
agree bit for bit, τ̂ is bitwise the same in both layouts, and the
single-task entry equals the batched kernel's row of the same task.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bitpack, ref
from repro_torch.kernels.build import (CudaKernel, on_device, require_cuda,
                                      sm_count, stream_handle)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNEL = CudaKernel("masked_agg_batched_packed", "masked_agg.cu",
                    "masked_agg_packed_launch",
                    [_P, _I, _P, _P, _P, _P, _I, _I, _I, _LL, _F, _I, _P, _LL,
                     _P, _P, _P])
KERNEL_BOOL = CudaKernel("masked_agg_batched", "masked_agg.cu",
                         "masked_agg_launch",
                         [_P, _I, _P, _P, _P, _P, _I, _I, _I, _LL, _F, _I, _P,
                          _LL, _P, _P, _P])
KERNEL_SINGLE = CudaKernel("masked_agg", "masked_agg.cu",
                           "masked_agg_single_launch",
                           [_P, _I, _P, _I, _P, _P, _I, _LL, _F, _I, _P, _LL,
                            _P, _P, _P])

plain = ref.masked_agg_batched_packed_ref
plain_bool = ref.masked_agg_batched_ref
plain_single = ref.masked_agg_ref

MAX_N = 4000       # member list of one task in shared memory (< 48 KB)
STAGE_BYTES = 48 * 1024   # the N staged unified rows of one packed tile


def packed_tile(n: int, elt: int) -> int:
    """The whole-round kernels' route and tile width (both layouts: the
    packed words and the bool bytes) for N rows of ``elt``-byte unified
    values (``tile_width`` in ``csrc/masked_agg.cu``): the widest
    of 1024, 512 and 256 coordinates whose N staged rows (``tile * elt +
    16`` bytes each) fit one stage of :data:`STAGE_BYTES`; 0 where none
    does, the wide-N route (first for N = 94 in bf16, 48 in fp32)."""
    for tile in (1024, 512, 256):
        if n * (tile * elt + 16) <= STAGE_BYTES:
            return tile
    return 0


def packed_workspace(n: int, t: int, tile: int) -> int:
    """4-byte words of a whole-round C call's workspace: the tile route's
    member lists, T rows of ``4 + 4 * max(N, 4)``; the wide-N route's
    fp32 γ·λ and member weights, ``2 * N * T``."""
    return t * (4 + 4 * max(n, 4)) if tile else 2 * n * t


SINGLE_TILE = 2048         # coordinates a tile of the single-task kernel
SINGLE_BLOCKS_PER_SM = 2


def single_workspace(n: int) -> int:
    """4-byte words of the single-task C call's workspace: one member list
    row (:func:`packed_workspace` at T = 1 on the tile route)."""
    return packed_workspace(n, 1, 1)


def single_grid(d: int, sms: int) -> int:
    """Blocks of the single-task kernel: persistent, at most
    :data:`SINGLE_BLOCKS_PER_SM` a SM, never more than its tiles."""
    return min(-(-d // SINGLE_TILE), SINGLE_BLOCKS_PER_SM * sms)


def masked_agg_batched_packed(unified, mask_words, lams, gammas, members,
                              d: int, rho: float):
    """(tau_hats (T, d) fp32, alpha_num (T, d) fp32) from unified (N, d)
    bf16/fp32, mask_words (N, T, ceil(d/32)) int32 and lams / gammas /
    members (N, T).  Rows with ``members[n, t] == 0`` must carry zero
    words and zero gamma (as the round's dense layout does): the kernel
    skips them.  CPU tensors take the plain version; CUDA tensors take
    the kernel."""
    if unified.device.type == "cpu":
        return plain(unified, mask_words, lams, gammas, members, d, rho)
    return masked_agg_batched_packed_cuda(unified, mask_words, lams, gammas,
                                          members, d, rho)


def masked_agg_batched(unified, masks, lams, gammas, members, rho: float):
    """The bool/fp32 layout: (tau_hats (T, d) fp32, m_hats (T, d) fp32)
    from unified (N, d) fp32/bf16, masks (N, T, d) bool and lams /
    gammas / members (N, T), with the same zero-row contract as
    :func:`masked_agg_batched_packed`.  CPU tensors take the plain
    version; CUDA tensors take the kernel."""
    if unified.device.type == "cpu":
        return plain_bool(unified, masks, lams, gammas, members, rho)
    return masked_agg_batched_cuda(unified, masks, lams, gammas, members, rho)


def masked_agg(unified, masks, lams, gammas, rho: float):
    """Single-task Eq. 3 + Eq. 4: (tau_hat (d,) fp32, m_hat (d,) fp32)
    from unified (N, d) fp32/bf16, masks (N, d) bool or {0, 1} in the
    unified dtype and lams / gammas (N,); the members are the rows with
    gamma > 0.  CPU tensors take the plain version; CUDA tensors take
    the kernel."""
    if unified.device.type == "cpu":
        return plain_single(unified, masks, lams, gammas, rho)
    return masked_agg_cuda(unified, masks, lams, gammas, rho)


_MASK_KINDS = {torch.bool: 0, torch.float32: 1, torch.bfloat16: 2}


def masked_agg_cuda(unified, masks, lams, gammas, rho: float):
    """The kernel path of :func:`masked_agg`: one C call builds the member
    list from gamma > 0 on the card (no host round trip) and streams only
    the member rows; the masks are read in their own dtype (no cast
    pass)."""
    require_cuda(unified, "unified", (torch.float32, torch.bfloat16), 2)
    require_cuda(masks, "masks", tuple(_MASK_KINDS), 2)
    n, d = unified.shape
    if tuple(masks.shape) != (n, d):
        raise ValueError(f"masks {tuple(masks.shape)} != unified {(n, d)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"masked_agg takes 1 <= N <= {MAX_N}, got {n}")
    lam = lams.float().contiguous()
    gam = gammas.float().contiguous()
    for name, x in (("lams", lam), ("gammas", gam)):
        require_cuda(x, name, (torch.float32,), 1)
        if tuple(x.shape) != (n,):
            raise ValueError(f"{name} {tuple(x.shape)} != {(n,)}")
    dev = unified.device
    ws = torch.empty((single_workspace(n),), dtype=torch.int32, device=dev)
    tau = torch.empty((d,), dtype=torch.float32, device=dev)
    m_hat = torch.empty_like(tau)
    with on_device(unified):
        KERNEL_SINGLE.launch(
            unified.data_ptr(), int(unified.dtype == torch.bfloat16),
            masks.data_ptr(), _MASK_KINDS[masks.dtype], lam.data_ptr(),
            gam.data_ptr(), n, d, float(rho), sm_count(dev.index),
            ws.data_ptr(), ws.numel(), tau.data_ptr(), m_hat.data_ptr(),
            stream_handle(unified))
    return tau, m_hat


def _check_round(kernel: CudaKernel, unified, n: int, t: int, d: int):
    if tuple(unified.shape) != (n, d):
        raise ValueError(f"unified {tuple(unified.shape)} does not fit "
                         f"N={n}, d={d}")
    if not 1 <= t <= 65535 or not 1 <= n <= MAX_N:
        raise ValueError(f"{kernel.name} takes 1 <= T <= 65535 and "
                         f"1 <= N <= {MAX_N}, got T={t}, N={n}")


def _launch_round(kernel: CudaKernel, unified, masks, lams, gammas, members,
                  n: int, t: int, d: int, rho: float):
    """One C call of either whole-round layout: it rounds γ·λ itself and
    reads bool (or fp32) members as they are, so fp32 ``lams`` /
    ``gammas`` and bool ``members`` take no other launch.  The route is
    :func:`packed_tile`'s.  Returns (tau_hats, the second output)."""
    _check_round(kernel, unified, n, t, d)
    lam = lams.float().contiguous()
    gam = gammas.float().contiguous()
    mem = members if members.dtype == torch.bool else members.float()
    mem = mem.contiguous()
    for name, x in (("lams", lam), ("gammas", gam), ("members", mem)):
        require_cuda(x, name, (torch.float32, torch.bool), 2)
        if tuple(x.shape) != (n, t):
            raise ValueError(f"{name} {tuple(x.shape)} != {(n, t)}")
    dev = unified.device
    tile = packed_tile(n, unified.element_size())
    ws_words = packed_workspace(n, t, tile)
    ws = torch.empty((ws_words,), dtype=torch.int32, device=dev)
    tau = torch.empty((t, d), dtype=torch.float32, device=dev)
    out2 = torch.empty_like(tau)
    with on_device(unified):
        kernel.launch(unified.data_ptr(), int(unified.dtype == torch.bfloat16),
                      masks.data_ptr(), lam.data_ptr(), gam.data_ptr(),
                      mem.data_ptr(), int(mem.dtype == torch.float32), n, t,
                      d, float(rho), tile, ws.data_ptr(), ws_words,
                      tau.data_ptr(), out2.data_ptr(), stream_handle(unified))
    return tau, out2


def masked_agg_batched_packed_cuda(unified, mask_words, lams, gammas, members,
                                   d: int, rho: float):
    """The kernel path of :func:`masked_agg_batched_packed`
    (:func:`_launch_round`)."""
    require_cuda(unified, "unified", (torch.float32, torch.bfloat16), 2)
    require_cuda(mask_words, "mask_words", (torch.int32,), 3)
    n, t, w = mask_words.shape
    if w != bitpack.packed_width(d):
        raise ValueError(f"mask_words {tuple(mask_words.shape)} do not fit "
                         f"d={d}")
    return _launch_round(KERNEL, unified, mask_words, lams, gammas, members,
                         n, t, d, rho)


def masked_agg_batched_cuda(unified, masks, lams, gammas, members,
                            rho: float):
    """The kernel path of :func:`masked_agg_batched`
    (:func:`_launch_round`); the kernel reads the bool masks' bytes as they
    are (no fp32 copy)."""
    require_cuda(unified, "unified", (torch.float32, torch.bfloat16), 2)
    require_cuda(masks, "masks", (torch.bool,), 3)
    n, t, d = masks.shape
    return _launch_round(KERNEL_BOOL, unified, masks, lams, gammas, members,
                         n, t, d, rho)
