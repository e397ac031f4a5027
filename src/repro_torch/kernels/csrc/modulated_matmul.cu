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
// over whole.  The effective weight is built on chip from the packed words
// and never exists in device memory (the plain version materialises
// (B, K, N)).  One C call takes one of two routes, chosen from S:
//
// Prefill (S > DECODE_MAX_S): each block owns one (request b, N-tile,
// S-tile) and walks K in tiles, staging the x tile and the effective-weight
// tile in shared memory.  What bounds it: the reads of x, base and tau.
//
// Decode (S <= DECODE_MAX_S): the work is tiny (one (S, K) x (K, N) product
// per request, under 80 K multiply-adds at S = 1), so latency bounds it,
// not bytes or operations.  The prefill grid would give B blocks at N = 16
// (every LoRA "a" factor), each walking 76 K-tiles in turn with two
// barriers a tile.  Here K is split over blocks instead: block (chunk c,
// N-tile, request b) owns kc rows of K (kc chosen by the wrapper from K
// alone, at most KC_MAX), stages x[b, :, chunk] once, and each thread
// builds its weight elements in registers straight from base, tau and the
// words and accumulates over its rows; the block then sums its row lanes
// in a fixed order through shared memory.  With one chunk (the "b"
// factors, K = r) the block writes y; otherwise it writes one partial per
// (b, chunk, s, n) to a workspace that the wrapper allocates, and a second
// kernel, launched in the same C call, sums the partials in ascending
// chunk order.  Every sum's order depends on K and N alone, so the result
// is deterministic and request b's outputs do not depend on the other
// requests of the batch.
//
// Numerics: the weight is built as
//   __fadd_rn(base, __fmul_rn(__fmul_rn(lam, bit), tau))
// with explicit round-to-nearest intrinsics, so nvcc cannot contract the
// add into an FMA: the effective weight is bitwise the materialised adapter
// lora0 + lam * where(m, tau, 0) in fp32 (with one-hot rows of x every
// output is one exact product and equals that weight bit for bit).  The
// product x @ w accumulates in fp32 and may use FMA; it is held to the
// plain version within a tolerance (cuBLAS sums in another order).
#include "launch.cuh"

namespace {

// -- prefill route: (N-tile, S-tile, request) blocks walking K --------------

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

// -- decode route: K split over blocks, a fixed-order reduction ------------

constexpr int DECODE_MAX_S = 16;   // S <= this takes the decode route
constexpr int KC_MAX = 128;        // most K rows per chunk (the x stage)
constexpr int DTHREADS = 256;

// Block (chunk c, N-tile, request b); thread (row lane tr, column tc)
// takes rows tr, tr + RL, ... of its chunk, in that order.  SMAX is 1 for
// S = 1, else DECODE_MAX_S (rows s >= S of the x stage are zero and never
// written).  out: y (B, S, N) when n_chunks == 1, else the workspace
// (B, n_chunks, S, N).
template <typename TauT, int TNC, int SMAX>
__global__ void __launch_bounds__(DTHREADS)
modulated_matmul_splitk_kernel(const float* __restrict__ x,
                               const float* __restrict__ base,
                               const TauT* __restrict__ tau,
                               const uint32_t* __restrict__ words,
                               const float* __restrict__ lam, int S, int K,
                               int N, int kc, int n_chunks, long long n_words,
                               float* __restrict__ out) {
  constexpr int RL = DTHREADS / TNC;   // row lanes
  __shared__ float s_x[SMAX][KC_MAX];
  __shared__ float s_red[RL][SMAX][TNC];
  const int c = blockIdx.x;
  const int n0 = blockIdx.y * TNC;
  const int b = blockIdx.z;
  const int k0 = c * kc;
  const int rows = min(kc, K - k0);
  const int tr = threadIdx.x / TNC;
  const int tc = threadIdx.x % TNC;
  const float* xb = x + (long long)b * S * K + k0;
  for (int i = threadIdx.x; i < SMAX * KC_MAX; i += DTHREADS) {
    const int s = i / KC_MAX, r = i % KC_MAX;
    s_x[s][r] = (s < S && r < rows) ? xb[(long long)s * K + r] : 0.f;
  }
  __syncthreads();
  const uint32_t* wb = words + (long long)b * n_words;
  const float lb = lam[b];
  const int n = n0 + tc;
  float acc[SMAX];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) acc[s] = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int r = tr; r < rows; r += RL) {
      const long long e = (long long)(k0 + r) * N + n;
      const float bit =
          static_cast<float>((__ldg(wb + (e >> 5)) >> (e & 31)) & 1u);
      const float w = __fadd_rn(
          __ldg(base + e), __fmul_rn(__fmul_rn(lb, bit), to_f32(tau[e])));
#pragma unroll
      for (int s = 0; s < SMAX; ++s) acc[s] = fmaf(s_x[s][r], w, acc[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < SMAX; ++s) s_red[tr][s][tc] = acc[s];
  __syncthreads();
  for (int i = threadIdx.x; i < S * TNC; i += DTHREADS) {
    const int s = i / TNC, j = i % TNC;
    if (n0 + j >= N) continue;
    float v = s_red[0][s][j];
#pragma unroll
    for (int t = 1; t < RL; ++t) v += s_red[t][s][j];
    out[(((long long)b * n_chunks + c) * S + s) * N + n0 + j] = v;
  }
}

// y[b, s, n] = the sum over chunks c = 0, 1, ... of ws[b, c, s, n], in
// that order; one thread per output.
__global__ void __launch_bounds__(DTHREADS)
modulated_matmul_reduce_kernel(const float* __restrict__ ws, int n_chunks,
                               long long sn, long long total,
                               float* __restrict__ y) {
  const long long i = (long long)blockIdx.x * DTHREADS + threadIdx.x;
  if (i >= total) return;
  const long long b = i / sn, j = i % sn;
  const float* p = ws + b * n_chunks * sn + j;
  float v = p[0];
#pragma unroll 8
  for (int c = 1; c < n_chunks; ++c) v += p[c * sn];
  y[i] = v;
}

template <typename TauT, int TNC, int SMAX>
void launch_splitk(const float* x, const float* base, const TauT* tau,
                   const uint32_t* words, const float* lam, int B, int S,
                   int K, int N, int kc, int n_chunks, long long n_words,
                   float* out, cudaStream_t st) {
  const dim3 grid(n_chunks, (N + TNC - 1) / TNC, B);
  modulated_matmul_splitk_kernel<TauT, TNC, SMAX><<<grid, DTHREADS, 0, st>>>(
      x, base, tau, words, lam, S, K, N, kc, n_chunks, n_words, out);
}

// N <= 16 (the "a" factors): 16 columns by 16 row lanes a block; wider N:
// 32 columns (a warp reads 128 contiguous bytes of base) by 8 row lanes.
template <typename TauT>
void launch_decode(const float* x, const float* base, const TauT* tau,
                   const uint32_t* words, const float* lam, int B, int S,
                   int K, int N, int kc, int n_chunks, long long n_words,
                   float* out, cudaStream_t st) {
  if (N <= 16) {
    if (S == 1)
      launch_splitk<TauT, 16, 1>(x, base, tau, words, lam, B, S, K, N, kc,
                                 n_chunks, n_words, out, st);
    else
      launch_splitk<TauT, 16, DECODE_MAX_S>(x, base, tau, words, lam, B, S,
                                            K, N, kc, n_chunks, n_words, out,
                                            st);
  } else {
    if (S == 1)
      launch_splitk<TauT, 32, 1>(x, base, tau, words, lam, B, S, K, N, kc,
                                 n_chunks, n_words, out, st);
    else
      launch_splitk<TauT, 32, DECODE_MAX_S>(x, base, tau, words, lam, B, S,
                                            K, N, kc, n_chunks, n_words, out,
                                            st);
  }
}

}  // namespace

// tau_bf16 = 0: tau is fp32; 1: bf16.  kc: K rows per chunk of the decode
// route (S <= DECODE_MAX_S; ignored above it); ws: the decode route's
// workspace of B * ceil(K / kc) * S * N floats, needed when K > kc (may be
// null otherwise).  Returns cudaGetLastError().
extern "C" int modulated_matmul_launch(const void* x, const void* base,
                                       const void* tau, int tau_bf16,
                                       const void* words, const void* lam,
                                       int B, int S, int K, int N, int kc,
                                       void* ws, void* y, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || K < 1 || N < 1 ||
      ((long long)K * N) % 32 != 0 || (S + TS - 1) / TS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_words = (long long)K * N / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const float*>(x);
  auto* bp = static_cast<const float*>(base);
  auto* wp = static_cast<const uint32_t*>(words);
  auto* lp = static_cast<const float*>(lam);
  auto* yp = static_cast<float*>(y);
  if (S <= DECODE_MAX_S) {
    if (kc < 1 || kc > KC_MAX || (N + 15) / 16 > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const int n_chunks = (K + kc - 1) / kc;
    if (n_chunks > 1 && ws == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    float* out = n_chunks > 1 ? static_cast<float*>(ws) : yp;
    if (tau_bf16)
      launch_decode(xp, bp, static_cast<const __nv_bfloat16*>(tau), wp, lp,
                    B, S, K, N, kc, n_chunks, n_words, out, s);
    else
      launch_decode(xp, bp, static_cast<const float*>(tau), wp, lp, B, S, K,
                    N, kc, n_chunks, n_words, out, s);
    if (n_chunks > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const long long sn = (long long)S * N, total = (long long)B * sn;
      const unsigned blocks =
          static_cast<unsigned>((total + DTHREADS - 1) / DTHREADS);
      modulated_matmul_reduce_kernel<<<blocks, DTHREADS, 0, s>>>(
          static_cast<const float*>(ws), n_chunks, sn, total, yp);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((N + TN - 1) / TN, (S + TS - 1) / TS, B);
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
