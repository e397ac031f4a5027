// Fused unify + task masks + lambda partials (paper Eq. 2 and the §3.2
// modulators), batched over clients, in either output layout; and Eq. 2
// alone for one client.
//
// Replaces three TPU kernels of src/repro/kernels/:
//  * fused_unify.py::fused_unify_packed_pallas (the packed wire layout:
//    bf16 unified, LSB-first mask words) -> fused_unify_packed_launch;
//  * fused_unify.py::fused_unify_pallas (the bool/fp32 A/B layout: fp32
//    unified, one byte per mask bit) -> fused_unify_launch;
//  * unify.py::unify_pallas (Eq. 2 alone, (K, d) -> (d,)) -> unify_launch.
// Per client b, over its valid slots k:
//   sigma = sgn(sum_k x_k), mu = max |x_k| over slots aligned with sigma,
//   tau = sigma * mu (bf16 in the packed layout, rounded after every
//   decision below; fp32 in the bool layout),
//   mask (b, k, j) = valid_k && x_kj * tau_j > 0,
//   lambda num = sum_j |x_kj|, den = sum_j mask * |tau_j|,
// with num/den as one partial per 256-coordinate block (the lambda grid of
// repro_torch.kernels.ref); the wrapper combines them by a fixed binary tree.
// Both layouts run the same block structure and the same partials, so
// masks and lambda are bitwise equal across them.
//
// What bounds it on the H100: device-memory bytes.  Per (client, coordinate)
// it reads K slot values once and writes one unified value and K mask
// entries — a few flops per byte, far under the card's flop/byte ridge.
// Design against that:
//  * one warp covers 32 consecutive coordinates of one client; every slot row
//    is one coalesced access per warp, and each lane keeps its coordinate's K
//    slot values in registers, so the (K, d) stack is read exactly once;
//    each thread loads its K values for 4 lambda blocks before using any,
//    so 4K loads per thread are in flight together;
//  * a few resident waves of blocks walk the 256-coordinate blocks, so
//    block start-up is paid per wave, not per 256 coordinates;
//  * invalid (padding) slots are never read;
//  * packed layout: __ballot_sync of the per-lane mask predicate IS the
//    LSB-first packed word (lane j <-> bit j): masks leave the SM at 1 bit
//    per element;
//  * bool layout: each lane writes its mask byte straight into the
//    torch.bool output (only 0/1 bytes), a 32-byte coalesced store per warp
//    and slot.  The TPU kernel's fp32 {0,1} masks (a tiling artefact there)
//    would cost 4x the mask bytes;
//  * lambda num/den reduce in-block (warp shuffle tree, then a halving tree
//    over the 8 warps) to one partial per block in a scratch buffer: no float
//    atomics, the same bits on every run.
// unify_launch: one thread per coordinate; up to 16 slots are loaded into
// registers together and elected as above; more slots take two passes over
// the slot rows (sum, then aligned max), the second from cache.  Bound:
// the (K, d) stack read once and d values written.
#include "launch.cuh"

namespace {

constexpr int KMAX = 16;                 // slots a lane keeps in registers
constexpr int GROUPS = 4;                // lambda blocks a block loads at once
constexpr int BLOCK = 256;               // == ref.LAMBDA_BLOCK
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sgn(float s) {
  return s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
}

// Eq. 2 on one coordinate's slot values (zero for invalid slots): the
// slot sum runs k = 0, 1, ..., then the max |x| over aligned slots.
template <int KM>
__device__ __forceinline__ float elect(const float (&xv)[KM], int K) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) s += xv[k];
  const float sigma = sgn(s);
  float mu = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K && xv[k] * sigma > 0.f) mu = fmaxf(mu, fabsf(xv[k]));
  return sigma * mu;
}

// PACKED: uni bf16 + LSB-first words; else uni fp32 + one byte per bit.
template <typename T, int KM, bool PACKED>
__global__ void __launch_bounds__(BLOCK)
fused_unify_kernel(const T* __restrict__ x,
                   const uint8_t* __restrict__ valid, int K, long long d,
                   long long n_words, long long n_blk, long long part_ld,
                   void* __restrict__ uni_out, void* __restrict__ mask_out,
                   float* __restrict__ num_part,
                   float* __restrict__ den_part) {
  __shared__ float red[2][KM][WARPS];
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* xb = x + b * K * d;
  unsigned vbits = 0;                     // bit k: slot k is valid
  for (int k = 0; k < K; ++k) vbits |= (valid[b * K + k] ? 1u : 0u) << k;

  for (long long g0 = (long long)blockIdx.x * GROUPS; g0 < n_blk;
       g0 += (long long)gridDim.x * GROUPS) {
    // the slot values of GROUPS lambda blocks: every load is issued before
    // any use, so they are in flight together; invalid slots are not read
    float xv[GROUPS][KM];
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      const long long j = (g0 + c) * BLOCK + threadIdx.x;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        float v = 0.f;
        if (k < K && j < d && ((vbits >> k) & 1u))
          v = to_f32(xb[(long long)k * d + j]);
        xv[c][k] = v;
      }
    }
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      const long long blk = g0 + c;
      if (blk >= n_blk) break;            // uniform over the block
      const long long j = blk * BLOCK + threadIdx.x;
      const float tau = elect<KM>(xv[c], K);
      if (j < d) {
        if constexpr (PACKED)
          static_cast<__nv_bfloat16*>(uni_out)[b * d + j] =
              __float2bfloat16_rn(tau);
        else
          static_cast<float*>(uni_out)[b * d + j] = tau;
      }

      const float atau = fabsf(tau);
      const long long w = blk * WARPS + warp;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {                      // uniform over the block
          // zero for invalid slots and tail lanes (their x is 0)
          const bool m = xv[c][k] * tau > 0.f;
          if constexpr (PACKED) {
            const unsigned bits = __ballot_sync(FULL, m);
            if (lane == 0 && w < n_words)
              static_cast<uint32_t*>(mask_out)[(b * K + k) * n_words + w] =
                  bits;
          } else if (j < d) {
            static_cast<uint8_t*>(mask_out)[(b * K + k) * d + j] = m;
          }
          float pn = fabsf(xv[c][k]);
          float pd = m ? atau : 0.f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            pn += __shfl_down_sync(FULL, pn, off);
            pd += __shfl_down_sync(FULL, pd, off);
          }
          if (lane == 0) {
            red[0][k][warp] = pn;
            red[1][k][warp] = pd;
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < 2 * K) {
        const int which = threadIdx.x / K;
        const int k = threadIdx.x % K;
        const float* r = red[which][k];
        // halving tree over the warps: (w, w + 4), (w, w + 2), then (0, 1)
        const float c0 = (r[0] + r[4]) + (r[2] + r[6]);
        const float c1 = (r[1] + r[5]) + (r[3] + r[7]);
        float* dst = which ? den_part : num_part;
        dst[(b * K + k) * part_ld + blk] = c0 + c1;
      }
      __syncthreads();                    // red is rewritten next block
    }
  }
}

template <typename T, int KM>
__global__ void __launch_bounds__(BLOCK)
unify_kernel(const T* __restrict__ x, int K, long long d,
             float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= d) return;
  float xv[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) xv[k] = k < K ? to_f32(x[k * d + j]) : 0.f;
  out[j] = elect<KM>(xv, K);
}

// more slots than registers hold: the same order in two passes
template <typename T>
__global__ void __launch_bounds__(BLOCK)
unify_wide_kernel(const T* __restrict__ x, int K, long long d,
                  float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += to_f32(x[k * d + j]);
  const float sigma = sgn(s);
  float mu = 0.f;
  for (int k = 0; k < K; ++k) {
    const float v = to_f32(x[k * d + j]);
    if (v * sigma > 0.f) mu = fmaxf(mu, fabsf(v));
  }
  out[j] = sigma * mu;
}

template <bool PACKED, int KM>
void launch_km(const void* x, int x_bf16, const uint8_t* v, int K, long long d,
               long long n_words, long long n_blk, long long ld, dim3 grid,
               cudaStream_t s, void* u, void* m, float* np, float* dp) {
  if (x_bf16)
    fused_unify_kernel<__nv_bfloat16, KM, PACKED><<<grid, BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, K, d, n_words, n_blk, ld, u,
        m, np, dp);
  else
    fused_unify_kernel<float, KM, PACKED><<<grid, BLOCK, 0, s>>>(
        static_cast<const float*>(x), v, K, d, n_words, n_blk, ld, u, m, np,
        dp);
}

template <bool PACKED>
int launch_fused(const void* x, int x_bf16, const void* valid, int B, int K,
                 long long d, void* uni, void* masks, void* num_part,
                 void* den_part, long long part_ld, void* stream) {
  const long long n_words = (d + 31) / 32;
  const long long n_blk = (d + BLOCK - 1) / BLOCK;
  if (K < 1 || K > KMAX || B < 1 || B > 65535 || d < 1 || part_ld < n_blk)
    return static_cast<int>(cudaErrorInvalidValue);
  // a few resident waves of blocks; each block walks lambda blocks
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (32LL * sms + B - 1) / B;
  const long long n_grp = (n_blk + GROUPS - 1) / GROUPS;
  const dim3 grid(static_cast<unsigned>(want < n_grp ? want : n_grp),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* np = static_cast<float*>(num_part);
  auto* dp = static_cast<float*>(den_part);
  auto* v = static_cast<const uint8_t*>(valid);
  // registers for the smallest power of two >= K slots
  if (K <= 1)
    launch_km<PACKED, 1>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid,
                         s, uni, masks, np, dp);
  else if (K <= 2)
    launch_km<PACKED, 2>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid,
                         s, uni, masks, np, dp);
  else if (K <= 4)
    launch_km<PACKED, 4>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid,
                         s, uni, masks, np, dp);
  else if (K <= 8)
    launch_km<PACKED, 8>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid,
                         s, uni, masks, np, dp);
  else
    launch_km<PACKED, 16>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid,
                          s, uni, masks, np, dp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch_unify(const T* x, int K, long long d, float* out, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((d + BLOCK - 1) / BLOCK);
  if (K <= 1)
    unify_kernel<T, 1><<<grid, BLOCK, 0, s>>>(x, K, d, out);
  else if (K <= 2)
    unify_kernel<T, 2><<<grid, BLOCK, 0, s>>>(x, K, d, out);
  else if (K <= 4)
    unify_kernel<T, 4><<<grid, BLOCK, 0, s>>>(x, K, d, out);
  else if (K <= 8)
    unify_kernel<T, 8><<<grid, BLOCK, 0, s>>>(x, K, d, out);
  else if (K <= KMAX)
    unify_kernel<T, KMAX><<<grid, BLOCK, 0, s>>>(x, K, d, out);
  else
    unify_wide_kernel<T><<<grid, BLOCK, 0, s>>>(x, K, d, out);
}

}  // namespace

// x (B, K, d) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); valid (B, K) uint8.
// Outputs: uni (B, d) bf16, words (B, K, ceil(d/32)) uint32, num_part and
// den_part (B, K, part_ld) fp32 with part_ld >= ceil(d/256); entries past
// ceil(d/256) are not written.  Returns cudaGetLastError().
extern "C" int fused_unify_packed_launch(const void* x, int x_bf16,
                                         const void* valid, int B, int K,
                                         long long d, void* uni, void* words,
                                         void* num_part, void* den_part,
                                         long long part_ld, void* stream) {
  return launch_fused<true>(x, x_bf16, valid, B, K, d, uni, words, num_part,
                            den_part, part_ld, stream);
}

// The bool/fp32 layout: as fused_unify_packed_launch, but uni (B, d) fp32
// and masks (B, K, d) uint8 holding 0 or 1 (a torch.bool tensor).
extern "C" int fused_unify_launch(const void* x, int x_bf16, const void* valid,
                                  int B, int K, long long d, void* uni,
                                  void* masks, void* num_part, void* den_part,
                                  long long part_ld, void* stream) {
  return launch_fused<false>(x, x_bf16, valid, B, K, d, uni, masks, num_part,
                             den_part, part_ld, stream);
}

// Eq. 2 for one client: x (K, d) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1),
// any K >= 1; out (d,) fp32.  Returns cudaGetLastError().
extern "C" int unify_launch(const void* x, int x_bf16, int K, long long d,
                            void* out, void* stream) {
  if (K < 1 || d < 1 || (d + BLOCK - 1) / BLOCK > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (x_bf16)
    launch_unify(static_cast<const __nv_bfloat16*>(x), K, d, o, s);
  else
    launch_unify(static_cast<const float*>(x), K, d, o, s);
  return static_cast<int>(cudaGetLastError());
}
