// Eq. 5 raw sign dots, from packed sign bit-planes or from dense fp32.
//
// Replaces two TPU kernels of src/repro/kernels/sign_sim.py:
//  * sign_sim_packed_pallas (popcount algebra over (pos, nz) words)
//    -> sign_sim_packed_launch.  For tasks t, t' over the packed words:
//      dots[t, t'] = sum_w popc(both) - 2 * popc(both & (pos_t ^ pos_t'))
//      with both = nz_t & nz_t';
//  * sign_sim_pallas (sgn(tau) . sgn(tau)^T over dense (T, d) fp32, the
//    bool/fp32 A/B layout's Eq. 5) -> sign_sim_launch.
// Both give the exact integer sgn(tau_t) . sgn(tau_t'); the caller
// normalises by d: S = (dots / d + 1) / 2.
//
// What bounds it on the H100: device-memory bytes — the packed planes are
// 2 * T * w words, the dense input T * d fp32 values, each read once, and
// T(T+1)/2 pairs cost a few integer ops per word.  Design against that:
//  * each block stages one range of the input for all T tasks in shared
//    memory: packed, W words of pos/nz; dense, the signs of W coordinates
//    as int8, four to a 32-bit word (one coalesced read of the input, rows
//    padded by one word against bank conflicts); then every (t, t') pair
//    of the upper triangle reads its two rows from shared memory;
//  * threads take pairs: packed with __popc, dense with __dp4a (four int8
//    sign products and their sum in one instruction), and atomicAdd their
//    int32 partial into the (T, T) result (mirrored below the diagonal):
//    integer atomics are order-free, so the result is exact and the same
//    on every run.
#include "launch.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
sign_sim_packed_kernel(const uint32_t* __restrict__ pos,
                       const uint32_t* __restrict__ nz, int T_, long long w,
                       int W, int* __restrict__ dots) {
  extern __shared__ uint32_t smem[];
  const int S = W + 1;                    // padded row stride
  uint32_t* sp = smem;
  uint32_t* sn = smem + T_ * S;
  const long long w0 = (long long)blockIdx.x * W;
  const int width = static_cast<int>(w - w0 < W ? w - w0 : W);
  for (int i = threadIdx.x; i < T_ * W; i += blockDim.x) {
    const int t = i / W, c = i % W;
    const bool ok = c < width;
    sp[t * S + c] = ok ? pos[t * w + w0 + c] : 0u;
    sn[t * S + c] = ok ? nz[t * w + w0 + c] : 0u;
  }
  __syncthreads();
  const int pairs = T_ * (T_ + 1) / 2;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    int a = 0, rem = p;                   // p -> (a, b), a <= b
    while (rem >= T_ - a) {
      rem -= T_ - a;
      ++a;
    }
    const int b = a + rem;
    const uint32_t* pa = sp + a * S;
    const uint32_t* pb = sp + b * S;
    const uint32_t* na = sn + a * S;
    const uint32_t* nb = sn + b * S;
    int acc = 0;
    for (int c = 0; c < width; ++c) {
      const uint32_t both = na[c] & nb[c];
      acc += __popc(both) - 2 * __popc(both & (pa[c] ^ pb[c]));
    }
    if (acc != 0) {
      atomicAdd(&dots[a * T_ + b], acc);
      if (a != b) atomicAdd(&dots[b * T_ + a], acc);
    }
  }
}

// x (T, d) fp32; a block stages the signs of W = 4 * WW coordinates.
__global__ void __launch_bounds__(BLOCK)
sign_sim_kernel(const float* __restrict__ x, int T_, long long d, int WW,
                int* __restrict__ dots) {
  extern __shared__ int sw[];
  const int S = WW + 1;                   // padded row stride, in words
  const long long j0 = (long long)blockIdx.x * WW * 4;
  for (int i = threadIdx.x; i < T_ * WW; i += blockDim.x) {
    const int t = i / WW, c = i % WW;
    unsigned word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long j = j0 + 4LL * c + e;
      int sg = 0;
      if (j < d) {
        const float v = x[(long long)t * d + j];
        sg = (v > 0.f) - (v < 0.f);
      }
      word |= (static_cast<unsigned>(sg) & 0xffu) << (8 * e);
    }
    sw[t * S + c] = static_cast<int>(word);
  }
  __syncthreads();
  const int pairs = T_ * (T_ + 1) / 2;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    int a = 0, rem = p;                   // p -> (a, b), a <= b
    while (rem >= T_ - a) {
      rem -= T_ - a;
      ++a;
    }
    const int b = a + rem;
    const int* ra = sw + a * S;
    const int* rb = sw + b * S;
    int acc = 0;
    for (int c = 0; c < WW; ++c) acc = __dp4a(ra[c], rb[c], acc);
    if (acc != 0) {
      atomicAdd(&dots[a * T_ + b], acc);
      if (a != b) atomicAdd(&dots[b * T_ + a], acc);
    }
  }
}

}  // namespace

// pos, nz (T, w) uint32; dots (T, T) int32, zeroed by the caller.  W words
// per block; 2 * T * (W + 1) * 4 bytes of shared memory must fit in 48 KB.
extern "C" int sign_sim_packed_launch(const void* pos, const void* nz, int T_,
                                      long long w, int W, void* dots,
                                      void* stream) {
  const size_t smem = 2ull * T_ * (W + 1) * sizeof(uint32_t);
  if (T_ < 1 || w < 1 || W < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = (w + W - 1) / W;
  sign_sim_packed_kernel<<<static_cast<unsigned>(n_blocks), BLOCK, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(nz), T_,
      w, W, static_cast<int*>(dots));
  return static_cast<int>(cudaGetLastError());
}

// x (T, d) fp32; dots (T, T) int32, zeroed by the caller.  WW sign words
// (4 * WW coordinates) per block; T * (WW + 1) * 4 bytes of shared memory
// must fit in 48 KB.
extern "C" int sign_sim_launch(const void* x, int T_, long long d, int WW,
                               void* dots, void* stream) {
  const size_t smem = 1ull * T_ * (WW + 1) * sizeof(int);
  if (T_ < 1 || d < 1 || WW < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = (d + 4LL * WW - 1) / (4LL * WW);
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sign_sim_kernel<<<static_cast<unsigned>(n_blocks), BLOCK, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), T_, d, WW, static_cast<int*>(dots));
  return static_cast<int>(cudaGetLastError());
}
