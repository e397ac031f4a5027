"""Whole-round Eq. 3 + Eq. 4 (agreement numerator + task merge) over
packed mask words, every task in one launch.

CUDA twin of the JAX package's ``masked_agg_batched_packed_pallas``
(``csrc/masked_agg.cu`` holds the kernel and its design note).  Its
plain version is :func:`repro_torch.kernels.ref.
masked_agg_batched_packed_ref`, which sums the clients in the kernel's
order with the kernel's roundings, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bitpack, ref
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNEL = CudaKernel("masked_agg_batched_packed", "masked_agg.cu",
                    "masked_agg_packed_launch",
                    [_P, _I, _P, _P, _P, _I, _I, _LL, _F, _P, _P, _P])

plain = ref.masked_agg_batched_packed_ref

MAX_N = 4000       # member list of one task in shared memory (< 48 KB)


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


def masked_agg_batched_packed_cuda(unified, mask_words, lams, gammas, members,
                                   d: int, rho: float):
    """The kernel path of :func:`masked_agg_batched_packed`."""
    require_cuda(unified, "unified", (torch.float32, torch.bfloat16), 2)
    require_cuda(mask_words, "mask_words", (torch.int32,), 3)
    n, t, w = mask_words.shape
    if tuple(unified.shape) != (n, d) or w != bitpack.packed_width(d):
        raise ValueError(f"unified {tuple(unified.shape)} / mask_words "
                         f"{tuple(mask_words.shape)} do not fit N={n}, d={d}")
    if not 1 <= t <= 65535 or not 1 <= n <= MAX_N:
        raise ValueError(f"masked_agg_batched_packed takes 1 <= T <= 65535 "
                         f"and 1 <= N <= {MAX_N}, got T={t}, N={n}")
    gl = (gammas.float() * lams.float()).contiguous()
    mem = members.float().contiguous()
    for name, x in (("gamma*lambda", gl), ("members", mem)):
        require_cuda(x, name, (torch.float32,), 2)
        if tuple(x.shape) != (n, t):
            raise ValueError(f"{name} {tuple(x.shape)} != {(n, t)}")
    dev = unified.device
    tau = torch.empty((t, d), dtype=torch.float32, device=dev)
    a_num = torch.empty_like(tau)
    with torch.cuda.device(dev):
        KERNEL.launch(unified.data_ptr(), int(unified.dtype == torch.bfloat16),
                      mask_words.data_ptr(), gl.data_ptr(), mem.data_ptr(),
                      n, t, d, float(rho), tau.data_ptr(), a_num.data_ptr(),
                      stream_handle(unified))
    return tau, a_num
