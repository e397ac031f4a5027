// Fused unify + task masks + lambda partials (paper Eq. 2 and the §3.2
// modulators), batched over clients, in the packed wire format.
//
// Replaces the TPU kernel src/repro/kernels/fused_unify.py::
// fused_unify_packed_pallas.  Per client b, over its valid slots k:
//   sigma = sgn(sum_k x_k), mu = max |x_k| over slots aligned with sigma,
//   tau = sigma * mu (emitted as bf16, rounded after every decision below),
//   mask bit (b, k, j) = valid_k && x_kj * tau_j > 0 (LSB-first words),
//   lambda num = sum_j |x_kj|, den = sum_j mask * |tau_j|,
// with num/den as one partial per 256-coordinate block (the lambda grid of
// repro_torch.kernels.ref); the wrapper combines them by a fixed binary tree.
//
// What bounds it on the H100: device-memory bytes.  Per (client, coordinate)
// it reads K slot values once and writes one bf16 value and K bits — a few
// flops per byte, far under the card's flop/byte ridge.  Design against that:
//  * one warp covers 32 consecutive coordinates of one client; every slot row
//    is one coalesced access per warp, and each lane keeps its coordinate's K
//    slot values in registers, so the (K, d) stack is read exactly once;
//    each thread loads its K values for 4 lambda blocks before using any,
//    so 4K loads per thread are in flight together;
//  * a few resident waves of blocks walk the 256-coordinate blocks, so
//    block start-up is paid per wave, not per 256 coordinates;
//  * invalid (padding) slots are never read;
//  * __ballot_sync of the per-lane mask predicate IS the LSB-first packed
//    word (lane j <-> bit j): masks leave the SM at 1 bit per element;
//  * lambda num/den reduce in-block (warp shuffle tree, then a halving tree
//    over the 8 warps) to one partial per block in a scratch buffer: no float
//    atomics, the same bits on every run.
#include "launch.cuh"

namespace {

constexpr int KMAX = 16;                 // slots a lane keeps in registers
constexpr int GROUPS = 4;                // lambda blocks a block loads at once
constexpr int BLOCK = 256;               // == ref.LAMBDA_BLOCK
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int KM>
__global__ void __launch_bounds__(BLOCK)
fused_unify_packed_kernel(const T* __restrict__ x,
                          const uint8_t* __restrict__ valid, int K,
                          long long d, long long n_words, long long n_blk,
                          long long part_ld, __nv_bfloat16* __restrict__ uni,
                          uint32_t* __restrict__ words,
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
      // the slot sum runs k = 0, 1, ...
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) s += xv[c][k];
      const float sigma = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
      float mu = 0.f;
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K && xv[c][k] * sigma > 0.f) mu = fmaxf(mu, fabsf(xv[c][k]));
      const float tau = sigma * mu;
      if (j < d) uni[b * d + j] = __float2bfloat16_rn(tau);

      const float atau = fabsf(tau);
      const long long w = blk * WARPS + warp;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {                      // uniform over the block
          // zero for invalid slots and tail lanes (their x is 0)
          const bool m = xv[c][k] * tau > 0.f;
          const unsigned bits = __ballot_sync(FULL, m);
          if (lane == 0 && w < n_words) words[(b * K + k) * n_words + w] = bits;
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

template <int KM>
void launch_km(const void* x, int x_bf16, const uint8_t* v, int K, long long d,
               long long n_words, long long n_blk, long long ld, dim3 grid,
               cudaStream_t s, __nv_bfloat16* u, uint32_t* wd, float* np,
               float* dp) {
  if (x_bf16)
    fused_unify_packed_kernel<__nv_bfloat16, KM><<<grid, BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, K, d, n_words, n_blk, ld, u,
        wd, np, dp);
  else
    fused_unify_packed_kernel<float, KM><<<grid, BLOCK, 0, s>>>(
        static_cast<const float*>(x), v, K, d, n_words, n_blk, ld, u, wd, np,
        dp);
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
  auto* u = static_cast<__nv_bfloat16*>(uni);
  auto* wd = static_cast<uint32_t*>(words);
  auto* np = static_cast<float*>(num_part);
  auto* dp = static_cast<float*>(den_part);
  auto* v = static_cast<const uint8_t*>(valid);
  // registers for the smallest power of two >= K slots
  if (K <= 1)
    launch_km<1>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid, s, u,
                  wd, np, dp);
  else if (K <= 2)
    launch_km<2>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid, s, u,
                  wd, np, dp);
  else if (K <= 4)
    launch_km<4>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid, s, u,
                  wd, np, dp);
  else if (K <= 8)
    launch_km<8>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid, s, u,
                  wd, np, dp);
  else
    launch_km<16>(x, x_bf16, v, K, d, n_words, n_blk, part_ld, grid, s, u,
                  wd, np, dp);
  return static_cast<int>(cudaGetLastError());
}
