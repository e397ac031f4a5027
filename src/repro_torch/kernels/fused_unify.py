"""Fused unify + task masks + λ scalers (Eq. 2 + §3.2 modulators) in the
packed wire format, batched over clients.

CUDA twin of the JAX package's ``fused_unify_packed_pallas``
(``csrc/fused_unify.cu`` holds the kernel and its design note).  It runs
at both ends of the wire: the clients' upload construction and the
server's downlink re-unification.  Its plain version is
:func:`repro_torch.kernels.ref.fused_unify_packed_ref`, which fixes the
same in-block and block-tree summation order, so kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bitpack, ref
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

KMAX = 16          # slots a lane keeps in registers (csrc/fused_unify.cu)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("fused_unify_packed", "fused_unify.cu",
                    "fused_unify_packed_launch",
                    [_P, _I, _P, _I, _I, _LL, _P, _P, _P, _P, _LL, _P])

plain = ref.fused_unify_packed_ref


def fused_unify_packed(task_vectors: torch.Tensor, valid: torch.Tensor):
    """(unified (B, d) bf16, mask_words (B, K, ceil(d/32)) int32,
    num (B, K), den (B, K)) from task_vectors (B, K, d) fp32/bf16 and
    valid (B, K) bool.  CPU tensors take the plain version; CUDA tensors
    take the kernel."""
    if task_vectors.device.type == "cpu":
        return plain(task_vectors, valid)
    return fused_unify_packed_cuda(task_vectors, valid)


def fused_unify_packed_cuda(task_vectors: torch.Tensor, valid: torch.Tensor):
    """The kernel path of :func:`fused_unify_packed` (CUDA tensors only)."""
    require_cuda(task_vectors, "task_vectors", (torch.float32, torch.bfloat16),
                 3)
    b, k, d = task_vectors.shape
    require_cuda(valid, "valid", (torch.bool,), 2)
    if tuple(valid.shape) != (b, k) or valid.device != task_vectors.device:
        raise ValueError(f"valid {tuple(valid.shape)} on {valid.device} does "
                         f"not match task_vectors {(b, k)} on "
                         f"{task_vectors.device}")
    if not 1 <= k <= KMAX or not 1 <= b <= 65535 or d < 1:
        raise ValueError(f"fused_unify_packed takes 1 <= K <= {KMAX}, "
                         f"1 <= B <= 65535 and d >= 1; got {(b, k, d)}")
    dev = task_vectors.device
    uni = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
    words = torch.empty((b, k, bitpack.packed_width(d)), dtype=torch.int32,
                        device=dev)
    # num and den partials side by side, each row already zero-padded to
    # the tree's power-of-two length: one tree over both
    n_pad = ref.next_pow2(-(-d // ref.LAMBDA_BLOCK))
    parts = torch.zeros((2, b, k, n_pad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(task_vectors.data_ptr(),
                      int(task_vectors.dtype == torch.bfloat16),
                      valid.data_ptr(), b, k, d, uni.data_ptr(),
                      words.data_ptr(), parts[0].data_ptr(),
                      parts[1].data_ptr(), n_pad, stream_handle(task_vectors))
    num, den = ref._tree_total(parts)
    return uni, words, num, den
