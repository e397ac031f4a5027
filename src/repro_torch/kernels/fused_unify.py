"""Fused unify + task masks + λ scalers (Eq. 2 + §3.2 modulators),
batched over clients, in either output layout; and Eq. 2 alone.

CUDA twins of three JAX kernels (``csrc/fused_unify.cu`` holds the
kernels and their design note):

* ``fused_unify_packed`` ↔ ``fused_unify_packed_pallas``: the packed
  wire layout (bf16 unified, int32 mask words);
* ``fused_unify`` ↔ ``fused_unify_pallas``: the bool/fp32 A/B layout
  (fp32 unified, bool masks);
* ``unify`` ↔ ``unify_pallas``: Eq. 2 for one client, (K, d) → (d,).

The fused kernels run at both ends of the wire: the clients' upload
construction and the server's downlink re-unification.  The packed one
is one C call with no other launch around it.  Their plain
versions (:func:`repro_torch.kernels.ref.fused_unify_packed_ref`,
:func:`~repro_torch.kernels.ref.fused_unify_ref`,
:func:`~repro_torch.kernels.ref.unify_ref`) fix the same in-block and
block-tree summation order, so kernel and plain version agree bit for
bit, and λ is bitwise the same in both layouts.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import bitpack, ref
from repro_torch.kernels.build import (CudaKernel, on_device, require_cuda,
                                      stream_handle)

KMAX = 16          # slots a lane keeps in registers (csrc/fused_unify.cu)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("fused_unify_packed", "fused_unify.cu",
                    "fused_unify_packed_launch",
                    [_P, _I, _P, _I, _I, _LL, _P, _P, _P, _LL, _P, _P])
KERNEL_BOOL = CudaKernel("fused_unify", "fused_unify.cu",
                         "fused_unify_launch",
                         [_P, _I, _P, _I, _I, _LL, _P, _P, _P, _P, _LL, _P])
KERNEL_UNIFY = CudaKernel("unify", "fused_unify.cu", "unify_launch",
                          [_P, _I, _I, _LL, _P, _P])

plain = ref.fused_unify_packed_ref
plain_bool = ref.fused_unify_ref
plain_unify = ref.unify_ref

_IN_DTYPES = (torch.float32, torch.bfloat16)


def fused_unify_packed(task_vectors: torch.Tensor, valid: torch.Tensor):
    """(unified (B, d) bf16, mask_words (B, K, ceil(d/32)) int32,
    num (B, K), den (B, K)) from task_vectors (B, K, d) fp32/bf16 and
    valid (B, K) bool.  CPU tensors take the plain version; CUDA tensors
    take the kernel."""
    if task_vectors.device.type == "cpu":
        return plain(task_vectors, valid)
    return fused_unify_packed_cuda(task_vectors, valid)


def fused_unify(task_vectors: torch.Tensor, valid: torch.Tensor):
    """The bool/fp32 layout: (unified (B, d) fp32, masks (B, K, d) bool,
    num (B, K), den (B, K)) from the same inputs as
    :func:`fused_unify_packed`.  CPU tensors take the plain version;
    CUDA tensors take the kernel."""
    if task_vectors.device.type == "cpu":
        return plain_bool(task_vectors, valid)
    return fused_unify_cuda(task_vectors, valid)


def unify(task_vectors: torch.Tensor) -> torch.Tensor:
    """Eq. 2 for one client: (K, d) fp32/bf16 → (d,) fp32, any K ≥ 1.
    CPU tensors take the plain version; CUDA tensors take the kernel."""
    if task_vectors.device.type == "cpu":
        return plain_unify(task_vectors)
    return unify_cuda(task_vectors)


def lambda_blocks(d: int) -> int:
    """λ blocks of :data:`ref.LAMBDA_BLOCK` coordinates that cover d: the
    length of each λ partials row the packed kernel writes."""
    return -(-d // ref.LAMBDA_BLOCK)


UNIFY_BLOCK = 256        # threads of a unify block
UNIFY_VEC_BYTES = 8      # the widest load a thread makes of one row
UNIFY_ROUTES = ("vec", "wide")


def unify_plan(k: int, d: int, dtype: torch.dtype, ptr_offset: int):
    """Kernel 7's launch plan for (K, d) ``dtype`` rows whose first
    element lies ``ptr_offset`` elements past an 8-byte boundary: (V,
    blocks, coordinates a block, route).

    K <= :data:`KMAX` takes the "vec" route: a thread loads V values of
    every row at once (2 fp32 or 4 bf16 at most), V the largest width
    every row start ``ptr_offset + k·d`` allows: gcd(8 / element size,
    ``ptr_offset``, d), so V divides d and the vectors cover [0, d) with
    no tail; block b takes the tile of ``UNIFY_BLOCK`` vectors b.  K >
    KMAX takes the first design ("wide"): one coordinate a thread, two
    passes over the rows.  The C launch computes V itself
    (``unify_vec`` in ``csrc/fused_unify.cu``); this is its mirror, held
    to it by a card test."""
    vec = 1 if k > KMAX else math.gcd(
        math.gcd(UNIFY_VEC_BYTES // dtype.itemsize, ptr_offset), d)
    return (vec, -(-(d // vec) // UNIFY_BLOCK), UNIFY_BLOCK * vec,
            UNIFY_ROUTES[k > KMAX])


def _launch_fused(kernel: CudaKernel, task_vectors: torch.Tensor,
                  valid: torch.Tensor, uni: torch.Tensor,
                  masks: torch.Tensor):
    """Check the inputs, launch the bool layout's ``kernel`` into ``uni``
    / ``masks`` and return (num, den) from its λ block partials."""
    b, k, d = task_vectors.shape
    dev = task_vectors.device
    # num and den partials side by side, each row already zero-padded to
    # the tree's power-of-two length: one tree over both
    n_pad = ref.next_pow2(-(-d // ref.LAMBDA_BLOCK))
    parts = torch.zeros((2, b, k, n_pad), dtype=torch.float32, device=dev)
    with on_device(task_vectors):
        kernel.launch(task_vectors.data_ptr(),
                      int(task_vectors.dtype == torch.bfloat16),
                      valid.data_ptr(), b, k, d, uni.data_ptr(),
                      masks.data_ptr(), parts[0].data_ptr(),
                      parts[1].data_ptr(), n_pad, stream_handle(task_vectors))
    return ref._tree_total(parts)


def _check_fused(task_vectors: torch.Tensor, valid: torch.Tensor, name: str):
    require_cuda(task_vectors, "task_vectors", _IN_DTYPES, 3)
    b, k, d = task_vectors.shape
    require_cuda(valid, "valid", (torch.bool,), 2)
    if tuple(valid.shape) != (b, k) or valid.device != task_vectors.device:
        raise ValueError(f"valid {tuple(valid.shape)} on {valid.device} does "
                         f"not match task_vectors {(b, k)} on "
                         f"{task_vectors.device}")
    if not 1 <= k <= KMAX or not 1 <= b <= 65535 or d < 1:
        raise ValueError(f"{name} takes 1 <= K <= {KMAX}, 1 <= B <= 65535 "
                         f"and d >= 1; got {(b, k, d)}")
    return b, k, d


def fused_unify_packed_cuda(task_vectors: torch.Tensor, valid: torch.Tensor):
    """The kernel path of :func:`fused_unify_packed` (CUDA tensors only).
    One C call, no other launch: the kernel writes one λ partial a λ
    block into a workspace from torch's allocator (no zero fill), and a
    second kernel in the same call sums each row by the tree of
    :func:`ref._tree_total`."""
    b, k, d = _check_fused(task_vectors, valid, "fused_unify_packed")
    dev = task_vectors.device
    uni = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
    words = torch.empty((b, k, bitpack.packed_width(d)), dtype=torch.int32,
                        device=dev)
    n_blk = lambda_blocks(d)
    part = torch.empty((2, b, k, n_blk), dtype=torch.float32, device=dev)
    num_den = torch.empty((2, b, k), dtype=torch.float32, device=dev)
    with on_device(task_vectors):
        KERNEL.launch(task_vectors.data_ptr(),
                      int(task_vectors.dtype == torch.bfloat16),
                      valid.data_ptr(), b, k, d, uni.data_ptr(),
                      words.data_ptr(), part.data_ptr(), n_blk,
                      num_den.data_ptr(), stream_handle(task_vectors))
    return uni, words, num_den[0], num_den[1]


def fused_unify_cuda(task_vectors: torch.Tensor, valid: torch.Tensor):
    """The kernel path of :func:`fused_unify` (CUDA tensors only); the
    kernel writes 0/1 bytes straight into the bool mask tensor."""
    b, k, d = _check_fused(task_vectors, valid, "fused_unify")
    dev = task_vectors.device
    uni = torch.empty((b, d), dtype=torch.float32, device=dev)
    masks = torch.empty((b, k, d), dtype=torch.bool, device=dev)
    num, den = _launch_fused(KERNEL_BOOL, task_vectors, valid, uni, masks)
    return uni, masks, num, den


def unify_cuda(task_vectors: torch.Tensor) -> torch.Tensor:
    """The kernel path of :func:`unify` (CUDA tensors only): one
    allocation and one launch, at the load width the C call takes from
    the stack's address (:func:`unify_plan`)."""
    require_cuda(task_vectors, "task_vectors", _IN_DTYPES, 2)
    k, d = task_vectors.shape
    if k < 1 or d < 1:
        raise ValueError(f"unify takes K >= 1 and d >= 1, got {(k, d)}")
    out = torch.empty((d,), dtype=torch.float32, device=task_vectors.device)
    with on_device(task_vectors):
        KERNEL_UNIFY.launch(task_vectors.data_ptr(),
                            int(task_vectors.dtype == torch.bfloat16), k, d,
                            out.data_ptr(), stream_handle(task_vectors))
    return out
