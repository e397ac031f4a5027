// Staging of row tiles in shared memory with Hopper's 1-D bulk copy
// (cp.async.bulk ... mbarrier::complete_tx::bytes), shared by the packed
// round's kernels (fused_unify.cu, masked_agg.cu).
//
// A bulk copy needs 16-byte-aligned source, destination and size, while
// a row of a (rows, d) tensor starts only elt-aligned when d * elt is not
// a multiple of 16 (bf16 at d = 1,327,140: 8-byte aligned every other
// row).  So a row's bytes [a, a + n) are staged as the aligned window
// [align_down(a), align_up(a + n)), clamped to the tensor's own aligned
// bytes [span.lo, span.hi): address y of the window lands at
// row + (y - align_down(a)) in the stage row, whose 16-byte slack holds
// the misalignment.  The window may take bytes of the neighbouring rows
// (never read); no copy reads outside the tensor.  What the clamp cuts
// off (at most 15 bytes at the tensor's start and end) is read from
// device memory by the thread that needs it (``in_span``).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The 16-byte-aligned bytes of a tensor: [align_up(base), align_down(end)).
struct Span {
  uintptr_t lo, hi;
};

inline Span tensor_span(const void* base, unsigned long long bytes) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  return Span{(b + 15) & ~uintptr_t(15), (b + bytes) & ~uintptr_t(15)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and add ``bytes`` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Arrive once (no transaction bytes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Block until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, uintptr_t src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The window of the row bytes [a, a + n) that is copied: [*lo, *hi).
__device__ __forceinline__ void row_window(uintptr_t a, unsigned n, Span s,
                                           uintptr_t* lo, uintptr_t* hi) {
  const uintptr_t a0 = a & ~uintptr_t(15);
  const uintptr_t a1 = (a + n + 15) & ~uintptr_t(15);
  *lo = a0 > s.lo ? a0 : s.lo;
  *hi = a1 < s.hi ? a1 : s.hi;
}

// Element address y of a staged row whose bytes start at a: its place in
// the stage row ``row``.
__device__ __forceinline__ const unsigned char* staged(
    const unsigned char* row, uintptr_t a, uintptr_t y) {
  return row + (y - (a & ~uintptr_t(15)));
}

// Whether the bytes [y, y + n) were copied (not cut off by the clamp).
__device__ __forceinline__ bool in_span(uintptr_t y, unsigned n, Span s) {
  return y >= s.lo && y + n <= s.hi;
}

// Called by all 32 lanes of one warp: stage the rows r < R with a nonzero
// address src(r) (their bytes [src(r), src(r) + n)) into stage row r at
// stage + r * row_bytes, completing on ``bar``: lane 0 arrives with the
// phase's byte count before any copy is issued.
template <class Src>
__device__ __forceinline__ void stage_rows(unsigned char* stage,
                                           int row_bytes, int R, Src src,
                                           unsigned n, Span s,
                                           uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  unsigned total = 0;
  for (int r = lane; r < R; r += 32) {
    const uintptr_t a = src(r);
    if (a) {
      uintptr_t lo, hi;
      row_window(a, n, s, &lo, &hi);
      if (hi > lo) total += static_cast<unsigned>(hi - lo);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, off);
  if (lane == 0) mbar_arrive_expect(bar, total);
  __syncwarp();
  for (int r = lane; r < R; r += 32) {
    const uintptr_t a = src(r);
    if (a) {
      uintptr_t lo, hi;
      row_window(a, n, s, &lo, &hi);
      unsigned char* row = stage + static_cast<long long>(r) * row_bytes;
      if (hi > lo)
        bulk_copy(row + (lo - (a & ~uintptr_t(15))), lo,
                  static_cast<unsigned>(hi - lo), bar);
    }
  }
}
