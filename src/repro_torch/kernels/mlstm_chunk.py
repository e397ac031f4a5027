"""Chunkwise-parallel stabilised mLSTM, the xLSTM block's prefill:
``(q, k, v, i_pre, f_pre, (C0, n0, m0), chunk) -> (h, (C, n, m))``.

CUDA twin of the JAX package's ``mlstm_chunkwise_pallas``;
``csrc/mlstm_chunk.cu`` holds the kernel and its design note.  The
Pallas kernel's zero-state, h-only form is the special case ``C0 = n0 =
0``, ``m0 = -1e30``; the model path passes its cache's state in and
reads the final state back.  Its plain version is
:func:`repro_torch.kernels.ref.mlstm_chunkwise_ref` (the JAX package's
``nn/ssm.py::mlstm_chunkwise``), with the same padding, the same bf16
rounding points and the same fp64-summed ``bcum``; the two agree to
fp32 summation-order tolerance (and, in bf16, to the bf16 roundings that
such a difference can flip).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("mlstm_chunkwise", "mlstm_chunk.cu", "mlstm_chunk_launch",
                    [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _P])

plain = ref.mlstm_chunkwise_ref

MODES = (None, "ref")
MAX_DK = 256                  # one n coordinate per thread of a block
# dynamic shared memory one block may use: the H100's 227 KB less 1 KB
# kept for the kernel's static shared scalars
SMEM_LIMIT = 226 * 1024
_TV, _TQ, _TS = 64, 32, 32    # the kernel's tile sizes (csrc/mlstm_chunk.cu)


def smem_bytes(chunk: int, dk: int) -> int:
    """Shared memory one block of the kernel takes (the C source's
    ``smem_floats``)."""
    return 4 * (dk * _TV + _TS * _TV + _TQ * (dk + 1) + _TS * (dk + 1)
                + _TQ * (_TS + 1) + dk + 5 * chunk + 3 * _TQ)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state, *, chunk: int,
                    C_out=None, mode: Optional[str] = None):
    """q, k (B, H, S, Dk) — q pre-scaled by Dk**-0.5 — and v (B, H, S, Dv)
    in the model dtype; i_pre, f_pre (B, H, S); state (C (B, H, Dk, Dv),
    n (B, H, Dk), m (B, H)) fp32.  Returns (h (B, H, S, Dv) in v's
    dtype, (C, n, m) fp32, new tensors, except that a given ``C_out``
    receives the final C and is returned as C; it may be the state's C
    itself).  CPU tensors, or ``mode="ref"``, take the plain version;
    CUDA tensors take the kernel, which needs contiguous inputs and fp32
    gates."""
    if mode not in MODES:
        raise ValueError(f"unknown dispatch mode {mode!r}; expected one of "
                         f"{MODES} (None = by device)")
    if mode == "ref" or q.device.type == "cpu":
        h, (C, n, m) = plain(q, k, v, i_pre, f_pre, state, chunk=chunk)
        if C_out is not None:
            C = C_out.copy_(C)
        return h, (C, n, m)
    return mlstm_chunkwise_cuda(q, k, v, i_pre, f_pre, state, chunk=chunk,
                                C_out=C_out)


def mlstm_chunkwise_cuda(q, k, v, i_pre, f_pre, state, *, chunk: int,
                         C_out=None):
    """The kernel path of :func:`mlstm_chunkwise` (CUDA tensors only)."""
    C0, n0, m0 = state
    dts = (torch.float32, torch.bfloat16)
    require_cuda(q, "q", dts, 4)
    require_cuda(k, "k", (q.dtype,), 4)
    require_cuda(v, "v", (q.dtype,), 4)
    require_cuda(i_pre, "i_pre", (torch.float32,), 3)
    require_cuda(f_pre, "f_pre", (torch.float32,), 3)
    require_cuda(C0, "C", (torch.float32,), 4)
    require_cuda(n0, "n", (torch.float32,), 3)
    require_cuda(m0, "m", (torch.float32,), 2)
    if C_out is not None:
        require_cuda(C_out, "C_out", (torch.float32,), 4)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if (tuple(k.shape) != (b, h, s, dk) or tuple(v.shape) != (b, h, s, dv)
            or tuple(i_pre.shape) != (b, h, s)
            or tuple(f_pre.shape) != (b, h, s)
            or tuple(C0.shape) != (b, h, dk, dv)
            or tuple(n0.shape) != (b, h, dk) or tuple(m0.shape) != (b, h)
            or (C_out is not None and C_out.shape != C0.shape)):
        raise ValueError(f"mlstm_chunkwise shapes do not fit: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, gates {tuple(i_pre.shape)} / "
                         f"{tuple(f_pre.shape)}, C {tuple(C0.shape)}, n "
                         f"{tuple(n0.shape)}, m {tuple(m0.shape)}")
    if (s < 1 or chunk < 1 or not 1 <= dk <= MAX_DK or dv < 1
            or not 1 <= b * h <= 65535
            or smem_bytes(chunk, dk) > SMEM_LIMIT):
        raise ValueError(f"mlstm_chunkwise takes S >= 1, 1 <= Dk <= "
                         f"{MAX_DK}, 1 <= B*H <= 65535 and a chunk whose "
                         f"tiles fit {SMEM_LIMIT} B of shared memory; got "
                         f"S={s}, Dk={dk}, Dv={dv}, B*H={b * h}, "
                         f"chunk={chunk} ({smem_bytes(chunk, dk)} B)")
    out = torch.empty_like(v)
    C1 = torch.empty_like(C0) if C_out is None else C_out
    n1 = torch.empty_like(n0)
    m1 = torch.empty_like(m0)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      int(q.dtype == torch.bfloat16), i_pre.data_ptr(),
                      f_pre.data_ptr(), C0.data_ptr(), n0.data_ptr(),
                      m0.data_ptr(), out.data_ptr(), C1.data_ptr(),
                      n1.data_ptr(), m1.data_ptr(), b * h, s, chunk, dk, dv,
                      stream_handle(q))
    return out, (C1, n1, m1)
