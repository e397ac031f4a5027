// Per-request modulated LoRA matmul for multi-tenant serving:
//   y_b = x_b @ (base + (lam_b * m_b) * tau)
// x (B, S, K) fp32; base (K, N) fp32; tau (K, N) fp32 or bf16; words
// (B, ceil(K*N/32)) uint32, LSB-first over the row-major (K, N) leaf; lam
// (B,) fp32; y (B, S, N) fp32.  K*N must be a multiple of 32.
//
// Replaces modulated_matmul_pallas (src/repro/kernels/modulated_matmul.py),
// which stages the whole (K, N) leaf in VMEM per request.  On the H100 the
// largest serving leaf, (4864, 16), is 311 KB of fp32 effective weight,
// more than one block's 227 KB of shared memory, so the leaf is not carried
// over whole: each block owns one (request b, N-tile, S-tile) and walks K in
// tiles, staging the x tile and the effective-weight tile in shared memory.
// The effective weight is built in the tile and never exists in device
// memory (the plain version materialises (B, K, N)).
//
// What bounds it on this card: at decode (S = 1) the work is tiny (one
// (1, K) x (K, N) product per request, under 80 K multiply-adds) and the
// launch itself dominates; at prefill (S = 128) the reads of x, base and
// tau.  The design is the simple right one; wgmma over the request batch,
// one launch per layer, or CUDA graphs are later work.
//
// Numerics: the weight is built as
//   __fadd_rn(base, __fmul_rn(__fmul_rn(lam, bit), tau))
// with explicit round-to-nearest intrinsics, so nvcc cannot contract the
// add into an FMA: the effective weight is bitwise the materialised adapter
// lora0 + lam * where(m, tau, 0) in fp32 (with x = I every output is one
// exact product and equals that weight bit for bit).  The product x @ w
// accumulates in fp32 registers over ascending k and may use FMA; it is
// held to the plain version within a tolerance (cuBLAS sums in another
// order).
#include "launch.cuh"

namespace {

constexpr int TS = 16;     // output rows (sequence) per block
constexpr int TN = 16;     // output columns per block
constexpr int TK = 64;     // K per staged tile
constexpr int THREADS = TS * TN;

template <typename TauT>
__global__ void __launch_bounds__(THREADS)
modulated_matmul_kernel(const float* __restrict__ x,
                        const float* __restrict__ base,
                        const TauT* __restrict__ tau,
                        const uint32_t* __restrict__ words,
                        const float* __restrict__ lam, int S, int K, int N,
                        long long n_words, float* __restrict__ y) {
  __shared__ float s_x[TS][TK + 1];
  __shared__ float s_w[TK][TN + 1];
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * TS;
  const int n0 = blockIdx.x * TN;
  const int tr = threadIdx.x / TN;     // output row within the tile
  const int tc = threadIdx.x % TN;     // output column within the tile
  const float* xb = x + (long long)b * S * K;
  const uint32_t* wb = words + (long long)b * n_words;
  const float lb = lam[b];
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += TK) {
    // stage x[s0:s0+TS, k0:k0+TK]
    for (int i = threadIdx.x; i < TS * TK; i += THREADS) {
      const int r = i / TK, c = i % TK;
      const int s = s0 + r, k = k0 + c;
      s_x[r][c] = (s < S && k < K) ? xb[(long long)s * K + k] : 0.f;
    }
    // build the effective-weight tile w[k0:k0+TK, n0:n0+TN]
    for (int i = threadIdx.x; i < TK * TN; i += THREADS) {
      const int r = i / TN, c = i % TN;
      const int k = k0 + r, n = n0 + c;
      float w = 0.f;
      if (k < K && n < N) {
        const long long e = (long long)k * N + n;
        const float bit =
            static_cast<float>((__ldg(wb + (e >> 5)) >> (e & 31)) & 1u);
        w = __fadd_rn(base[e],
                      __fmul_rn(__fmul_rn(lb, bit), to_f32(tau[e])));
      }
      s_w[r][c] = w;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < TK; ++kk) acc += s_x[tr][kk] * s_w[kk][tc];
    __syncthreads();
  }
  const int s = s0 + tr, n = n0 + tc;
  if (s < S && n < N) y[((long long)b * S + s) * N + n] = acc;
}

}  // namespace

// tau_bf16 = 0: tau is fp32; 1: bf16.  Returns cudaGetLastError().
extern "C" int modulated_matmul_launch(const void* x, const void* base,
                                       const void* tau, int tau_bf16,
                                       const void* words, const void* lam,
                                       int B, int S, int K, int N, void* y,
                                       void* stream) {
  if (B < 1 || B > 65535 || S < 1 || K < 1 || N < 1 ||
      ((long long)K * N) % 32 != 0 || (S + TS - 1) / TS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_words = (long long)K * N / 32;
  const dim3 grid((N + TN - 1) / TN, (S + TS - 1) / TS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const float*>(x);
  auto* bp = static_cast<const float*>(base);
  auto* wp = static_cast<const uint32_t*>(words);
  auto* lp = static_cast<const float*>(lam);
  auto* yp = static_cast<float*>(y);
  if (tau_bf16)
    modulated_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        xp, bp, static_cast<const __nv_bfloat16*>(tau), wp, lp, S, K, N,
        n_words, yp);
  else
    modulated_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        xp, bp, static_cast<const float*>(tau), wp, lp, S, K, N, n_words,
        yp);
  return static_cast<int>(cudaGetLastError());
}
