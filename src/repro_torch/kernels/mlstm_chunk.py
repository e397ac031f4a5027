"""Chunkwise-parallel stabilised mLSTM, the xLSTM block's prefill:
``(q, k, v, i_pre, f_pre, (C0, n0, m0), chunk) -> (h, (C, n, m))``.

CUDA twin of the JAX package's ``mlstm_chunkwise_pallas``;
``csrc/mlstm_chunk.cu`` holds the kernels and their design note: one C
call runs a pre-pass (the gate statistics and the n / m chain, then the
causal scores w, qn_intra and h's divisors, once per (b·h, chunk), into
two workspaces from torch's caching allocator) and the main kernel (q·C,
w @ v and the state fold per 64-column Dv tile, its tiles loaded with
``cp.async``).  The Pallas kernel's zero-state, h-only form is the
special case ``C0 = n0 = 0``, ``m0 = -1e30``; the model path passes its
cache's state in and reads the final state back.  Its plain version is
:func:`repro_torch.kernels.ref.mlstm_chunkwise_ref` (the JAX package's
``nn/ssm.py::mlstm_chunkwise``), with the same padding, the same bf16
rounding points and the same fp64-summed ``bcum``; the two agree to
fp32 summation-order tolerance (and, in bf16, to the bf16 roundings that
such a difference can flip).  The pre-pass's own plain version is
:func:`repro_torch.kernels.ref.mlstm_chunk_prepass_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (CudaKernel, on_device, require_cuda,
                                      stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("mlstm_chunkwise", "mlstm_chunk.cu", "mlstm_chunk_launch",
                    [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _I, _I, _I, _I, _I, _P])
# the pre-pass alone, for its checks against its plain version; the main
# path runs it inside KERNEL's call
PREPASS = CudaKernel("mlstm_chunk_prepass", "mlstm_chunk.cu",
                     "mlstm_chunk_prepass_launch",
                     [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _P])

plain = ref.mlstm_chunkwise_ref
plain_prepass = ref.mlstm_chunk_prepass_ref

MODES = (None, "ref")
MAX_DK = 256                  # one n coordinate per thread of a block
# dynamic shared memory one block may use: the H100's 227 KB less 1 KB
# kept for the kernel's static shared scalars
SMEM_LIMIT = 226 * 1024
# at most this much, two blocks fit one SM (228 KB, 1 KB kept a block)
SMEM_TWO_BLOCKS = 113 * 1024
_TV, _TQ, _TS = 64, 32, 32    # the kernels' tile sizes (csrc/mlstm_chunk.cu)
# the fp32 workspace's rows of L values a (b·h, chunk), in the C
# source's order (G_BCUM .. G_DEN)
STAT_ROWS = ("bcum", "i", "m_t", "scale_inter", "wgt", "qn_intra", "den")


def smem_bytes(chunk: int, dk: int, elt: int) -> int:
    """Shared memory the largest block of a call takes (the C source's
    ``*_smem_floats``), q / k / v of ``elt`` bytes: the statistics
    kernel's, the scores kernel's, or the main kernel's (the C slice and
    three rows of L in fp32, two stage buffers of 32 key rows × (max(Dk,
    32) + 64) values in the model dtype)."""
    l, tq, ts, tv = chunk, _TQ, _TS, _TV
    stats = 4 * l
    scores = (tq + ts) * (dk + 1) + tq * (ts + 1) + 2 * l + dk + tq
    main = dk * tv + 3 * l + 2 * ts * (max(dk, ts) + tv) * elt // 4
    return 4 * max(stats, scores, main)


def workspace_shapes(bh: int, s: int, chunk: int, dk: int):
    """The pre-pass's two workspaces: fp32 (B·H, nc, rows · L + Dk + 2)
    -- the rows of ``STAT_ROWS``, n at the chunk's start, decay and m at
    the chunk's start -- and w in the model dtype (B·H, nc, L, L rounded
    up to whole key sub-tiles)."""
    nc = -(-s // chunk)
    return ((bh, nc, len(STAT_ROWS) * chunk + dk + 2),
            (bh, nc, chunk, -(-chunk // _TS) * _TS))


def workspace_bytes(bh: int, s: int, chunk: int, dk: int, elt: int) -> int:
    """Bytes of the two workspaces a call takes from torch's allocator."""
    f, w = workspace_shapes(bh, s, chunk, dk)
    return 4 * f[0] * f[1] * f[2] + elt * w[0] * w[1] * w[2] * w[3]


def occupancy(dtype, chunk: int, dk: int) -> Dict[str, int]:
    """Blocks of each of a call's kernels that fit one SM at this shape,
    as the CUDA runtime computes it (needs the card)."""
    KERNEL.load()
    fn = KERNEL._lib.mlstm_chunk_occupancy
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    blocks = (ctypes.c_int * 3)()
    err = fn(int(dtype == torch.bfloat16), chunk, dk, blocks)
    if err:
        raise RuntimeError(f"mlstm_chunk_occupancy: CUDA error {err}")
    return dict(zip(("stats", "scores", "main"), blocks))


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


def _check(q, k, v, i_pre, f_pre, C0, n0, m0, C_out, chunk):
    """What the kernels take, or raise: contiguous CUDA tensors, q / k / v
    of one dtype, fp32 gates and state, shapes that fit, rows of whole
    16-byte pieces (the main kernel's ``cp.async`` loads) and a chunk
    whose tiles fit shared memory."""
    dts = (torch.float32, torch.bfloat16)
    require_cuda(q, "q", dts, 4)
    require_cuda(k, "k", (q.dtype,), 4)
    if v is not None:
        require_cuda(v, "v", (q.dtype,), 4)
    require_cuda(i_pre, "i_pre", (torch.float32,), 3)
    require_cuda(f_pre, "f_pre", (torch.float32,), 3)
    if C0 is not None:
        require_cuda(C0, "C", (torch.float32,), 4)
    require_cuda(n0, "n", (torch.float32,), 3)
    require_cuda(m0, "m", (torch.float32,), 2)
    if C_out is not None:
        require_cuda(C_out, "C_out", (torch.float32,), 4)
    b, h, s, dk = q.shape
    dv = v.shape[-1] if v is not None else 1
    if (tuple(k.shape) != (b, h, s, dk)
            or (v is not None and tuple(v.shape) != (b, h, s, dv))
            or tuple(i_pre.shape) != (b, h, s)
            or tuple(f_pre.shape) != (b, h, s)
            or (C0 is not None and tuple(C0.shape) != (b, h, dk, dv))
            or tuple(n0.shape) != (b, h, dk) or tuple(m0.shape) != (b, h)
            or (C_out is not None and C_out.shape != C0.shape)):
        raise ValueError(f"mlstm_chunkwise shapes do not fit: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{None if v is None else tuple(v.shape)}, gates "
                         f"{tuple(i_pre.shape)} / {tuple(f_pre.shape)}, C "
                         f"{None if C0 is None else tuple(C0.shape)}, n "
                         f"{tuple(n0.shape)}, m {tuple(m0.shape)}")
    if (s < 1 or chunk < 1 or not 1 <= dk <= MAX_DK or dv < 1
            or not 1 <= b * h <= 65535 or -(-s // chunk) > 65535
            or smem_bytes(chunk, dk, q.element_size()) > SMEM_LIMIT):
        raise ValueError(f"mlstm_chunkwise takes S >= 1, 1 <= Dk <= "
                         f"{MAX_DK}, 1 <= B*H <= 65535 and a chunk whose "
                         f"tiles fit {SMEM_LIMIT} B of shared memory; got "
                         f"S={s}, Dk={dk}, Dv={dv}, B*H={b * h}, "
                         f"chunk={chunk} "
                         f"({smem_bytes(chunk, dk, q.element_size())} B)")
    per16 = 16 // q.element_size()
    if dk % per16 or (v is not None and dv % per16):
        raise ValueError(f"mlstm_chunkwise loads rows in 16-byte pieces: Dk "
                         f"and Dv must be multiples of {per16} in {q.dtype}; "
                         f"got Dk={dk}, Dv={dv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"mlstm_chunkwise: {name} must start on a "
                             f"16-byte boundary")


def _workspaces(q, chunk, zero=False):
    b, h, s, dk = q.shape
    fs, ws = workspace_shapes(b * h, s, chunk, dk)
    new = torch.zeros if zero else torch.empty
    return (new(fs, dtype=torch.float32, device=q.device),
            new(ws, dtype=q.dtype, device=q.device))


def mlstm_chunkwise_cuda(q, k, v, i_pre, f_pre, state, *, chunk: int,
                         C_out=None):
    """The kernel path of :func:`mlstm_chunkwise` (CUDA tensors only):
    one C call runs the pre-pass and the main kernel."""
    C0, n0, m0 = state
    _check(q, k, v, i_pre, f_pre, C0, n0, m0, C_out, chunk)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty_like(v)
    C1 = torch.empty_like(C0) if C_out is None else C_out
    n1 = torch.empty_like(n0)
    m1 = torch.empty_like(m0)
    ws, wsw = _workspaces(q, chunk)
    with on_device(q):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      int(q.dtype == torch.bfloat16), i_pre.data_ptr(),
                      f_pre.data_ptr(), C0.data_ptr(), n0.data_ptr(),
                      m0.data_ptr(), out.data_ptr(), C1.data_ptr(),
                      n1.data_ptr(), m1.data_ptr(), ws.data_ptr(),
                      wsw.data_ptr(), b * h, s, chunk, dk, dv,
                      stream_handle(q))
    return out, (C1, n1, m1)


def mlstm_chunk_prepass_cuda(q, k, i_pre, f_pre, n0, m0, *, chunk: int):
    """The pre-pass alone on the card, in the form of
    :func:`repro_torch.kernels.ref.mlstm_chunk_prepass_ref`'s dict (w
    zero above the diagonal: its workspace starts zeroed here)."""
    _check(q, k, None, i_pre, f_pre, None, n0, m0, None, chunk)
    b, h, s, dk = q.shape
    n1, m1 = torch.empty_like(n0), torch.empty_like(m0)
    ws, wsw = _workspaces(q, chunk, zero=True)
    with on_device(q):
        PREPASS.launch(q.data_ptr(), k.data_ptr(),
                       int(q.dtype == torch.bfloat16), i_pre.data_ptr(),
                       f_pre.data_ptr(), n0.data_ptr(), m0.data_ptr(),
                       n1.data_ptr(), m1.data_ptr(), ws.data_ptr(),
                       wsw.data_ptr(), b * h, s, chunk, dk,
                       stream_handle(q))
    nc, l = ws.shape[1], chunk
    ws = ws.reshape(b, h, nc, -1)
    res = {key: ws[..., r * l:(r + 1) * l] for r, key in enumerate(STAT_ROWS)}
    tail = len(STAT_ROWS) * l
    res["n"] = ws[..., tail:tail + dk]
    res["decay"], res["m"] = ws[..., tail + dk], ws[..., tail + dk + 1]
    res["w"] = wsw.reshape(b, h, nc, l, -1)[..., :l]
    res["n_final"], res["m_final"] = n1, m1
    return res
