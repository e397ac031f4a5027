// Per-request modulated LoRA matmul for multi-tenant serving:
//   y_b = x_b @ (base + (lam_b * m_b) * tau)
// x (B, S, K) fp32; base (K, N) fp32; tau (K, N) fp32 or bf16; words
// (B, ceil(K*N/32)) uint32, LSB-first over the row-major (K, N) leaf; lam
// (B,) fp32; y (B, S, N) fp32.  K*N must be a multiple of 32.
//
// Replaces modulated_matmul_pallas (src/repro/kernels/modulated_matmul.py),
// which stages the whole (K, N) leaf in VMEM per request.  On the H100 the
// largest serving leaf, (18944, 16), is 1.2 MB of fp32 effective weight,
// more than one block's 227 KB of shared memory, so the leaf is not carried
// over whole.  The effective weight is built on chip from the packed words
// and never exists in device memory (the plain version materialises
// (B, K, N)).  One C call takes one of four routes, chosen from the shape:
//
// Decode (S <= DECODE_MAX_S): the work is tiny (one (S, K) x (K, N) product
// per request, under 80 K multiply-adds at S = 1), so latency bounds it,
// not bytes or operations.  K is split over blocks: block (chunk c,
// N-tile, request b) owns kc rows of K (kc chosen by the wrapper from K
// alone, at most KC_MAX), stages x[b, :, chunk] once, and each thread
// builds its weight elements in registers straight from base, tau and the
// words and accumulates over its rows; the block then sums its row lanes
// in a fixed order through shared memory.  With one chunk the block writes
// y; otherwise it writes one partial per (b, chunk, s, n) to a workspace
// that the wrapper allocates, and modulated_matmul_reduce_kernel, launched
// in the same C call, sums the partials in ascending chunk order.
//
// Prefill, narrow K (S > DECODE_MAX_S, K <= NARROW: every LoRA "b"
// factor, K = r = 16).  The product is K multiply-adds an output, so the
// writes of y bound it (at hymba's (16, 6400), S 2,040, B 8: 418 MB of y
// against 1 MB of x).  Block (N-tile of AK_TN columns, group of S-tiles,
// request b) builds its (K, AK_TN) weight tile once into shared memory,
// then for each of its S-tiles stages x[b, S-tile, :K] (a few KB) and
// each thread sums a register micro-tile of AK_RPT rows x 4 columns over
// k in ascending order and writes it as 16-byte stores along N.  No K
// loop, no padding of K to a wide tile.  The first design (a 16 x 16 x 64
// tile, kept below as the general route) ran 64 shared-memory multiply-
// adds, each with two shared loads, for 16 real products.
//
// Prefill, narrow N (K > NARROW, N <= NARROW: every "a" factor, N = r =
// 16).  Sixteen multiply-adds an x element, so reading x bounds it (at the
// vlm's (18944, 16), S 1,152, B 8: 698 MB).  K is not split: each output
// stays one FMA chain (below).  Block (S-tile of BN_TS rows, request b)
// streams x[b, S-tile, :] through a BN_STAGES-deep ring of BN_TK-wide
// stages by 16-byte cp.async (4-byte where K % 4 != 0); the stage's raw
// base, tau and mask words ride the same ring, and each (BN_TK, N) weight
// tile is built from them once, a stage ahead of its use (loaded from
// device memory into registers instead, their latency stalled every
// stage).  A lane owns one row and BN_SPLIT warps share its columns, so
// the weights a warp reads are the same address in every lane (one
// broadcast) and a 16-byte x read feeds 4 x N / BN_SPLIT multiply-adds
// (the first design paid two shared loads a multiply-add).
//
// Any other shape (K and N both above NARROW; none is served at rank 16)
// takes the general tile, modulated_matmul_kernel: block (N-tile, S-tile,
// request b) walks K in TK-wide tiles, staging x and the weight tile.
//
// No tensor cores: TF32 keeps 10 mantissa bits, which breaks the x = I
// bitwise check and, at K = 16, the 1e-4 bar; a 3 x TF32 split still
// drops the last bits of w; bf16 would change fp32 fused = dense.  Both
// narrow routes are bound by bytes (the vlm layer: 10.9 GFLOP, 0.16 ms
// at the fp32 peak, against 0.41 ms of bytes), so fp32 FMA on the CUDA
// cores keeps up.
//
// Every sum's order depends on K and N alone, never on B, S or the tile
// an output falls in: the result is deterministic and request b's outputs
// do not depend on the other requests of the batch.  At prefill each
// output is one FMA chain over k = 0, 1, ..., K - 1 from 0, the order of
// the first design, which on the H100 gave the plain version's cuBLAS
// products and the dense-routed model bit for bit at every served shape;
// a design that split K over blocks and warps missed the fp32
// fused-vs-dense logit bar (rtol 5e-4, atol 1e-5) on hymba and the vlm by
// 2e-5 to 3e-5, so K is not split at prefill.
//
// Numerics: the weight is built as
//   __fadd_rn(base, __fmul_rn(__fmul_rn(lam, bit), tau))
// with explicit round-to-nearest intrinsics, so nvcc cannot contract the
// add into an FMA: the effective weight is bitwise the materialised adapter
// lora0 + lam * where(m, tau, 0) in fp32 (with one-hot rows of x every
// output is one exact product and equals that weight bit for bit).  The
// product x @ w accumulates in fp32 with FMA; it is held to the plain
// version within a tolerance (the decode route sums in another order
// than cuBLAS, and no route relies on cuBLAS's order).
#include "launch.cuh"

namespace {

// The effective weight of element e = k * N + n of request b's leaf.
template <typename TauT>
__device__ __forceinline__ float eff_weight(const float* __restrict__ base,
                                            const TauT* __restrict__ tau,
                                            const uint32_t* __restrict__ wb,
                                            float lb, long long e) {
  const float bit =
      static_cast<float>((__ldg(wb + (e >> 5)) >> (e & 31)) & 1u);
  return __fadd_rn(__ldg(base + e),
                   __fmul_rn(__fmul_rn(lb, bit), to_f32(tau[e])));
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// src_bytes 0 fills the 16 (or 4) shared bytes with zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int G>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(G) : "memory");
}

constexpr int NARROW = 32;   // K (or else N) up to this: a narrow route

// -- prefill, narrow K: the weight tile once, register micro-tiles ---------

constexpr int AK_TN = 128;                  // columns a block (4 a lane)
constexpr int AK_RPT = 8;                   // rows a thread
constexpr int AK_THREADS = 256;
constexpr int AK_TS = AK_THREADS / 32 * AK_RPT;   // 64 rows an S-tile
constexpr int AK_XS = NARROW + 4;           // x stage row stride (floats)
constexpr long long AK_TARGET_BLOCKS = 2048;

// Block (N-tile, group g, request b) takes S-tiles g * per to
// min(tiles, (g + 1) * per); warp w of each tile rows 8w to 8w + 7, lane l
// columns 4l to 4l + 3 of the N-tile.  The next S-tile's x is loaded into
// registers while the current one is summed and stored.
template <typename TauT>
__global__ void __launch_bounds__(AK_THREADS)
modulated_matmul_narrow_k_kernel(const float* __restrict__ x,
                                 const float* __restrict__ base,
                                 const TauT* __restrict__ tau,
                                 const uint32_t* __restrict__ words,
                                 const float* __restrict__ lam, int S, int K,
                                 int N, int per, long long n_words,
                                 float* __restrict__ y) {
  constexpr int XPT = AK_TS * NARROW / AK_THREADS;   // x elements a thread
  __shared__ __align__(16) float s_w[NARROW][AK_TN];
  __shared__ __align__(16) float s_x[AK_TS][AK_XS];
  const int n0 = blockIdx.x * AK_TN;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = (K + 3) & ~3;   // K to a multiple of 4; rows past K are 0
  const float* xb = x + (long long)b * S * K;
  float* yb = y + (long long)b * S * N;
  const int nc = n0 + 4 * lane;
  const bool vec = (N & 3) == 0 && nc + 3 < N;
  const int r0 = warp * AK_RPT;
  const int tiles = (S + AK_TS - 1) / AK_TS;
  const int g = blockIdx.y;
  const int t_end = min(tiles, (g + 1) * per);
  // element i = threadIdx.x + j * AK_THREADS of an S-tile's (AK_TS, kp)
  // x stage
  float xr[XPT];
  auto load_x = [&](int t) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = threadIdx.x + j * AK_THREADS;
      const int r = i / kp, k = i - r * kp, s = t * AK_TS + r;
      xr[j] = (i < AK_TS * kp && s < S && k < K) ? xb[(long long)s * K + k]
                                                 : 0.f;
    }
  };
  load_x(g * per);
  const uint32_t* wb = words + (long long)b * n_words;
  const float lb = lam[b];
  for (int i = threadIdx.x; i < kp * AK_TN; i += AK_THREADS) {
    const int k = i / AK_TN, c = i % AK_TN, n = n0 + c;
    s_w[k][c] = (k < K && n < N)
                    ? eff_weight(base, tau, wb, lb, (long long)k * N + n)
                    : 0.f;
  }
  for (int t = g * per; t < t_end; ++t) {
    const int s0 = t * AK_TS;
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = threadIdx.x + j * AK_THREADS;
      const int r = i / kp;
      if (i < AK_TS * kp) s_x[r][i - r * kp] = xr[j];
    }
    __syncthreads();   // the weight tile built, this tile's x staged
    if (t + 1 < t_end) load_x(t + 1);
    float acc[AK_RPT][4];
#pragma unroll
    for (int j = 0; j < AK_RPT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k4 = 0; k4 < kp; k4 += 4) {
      float4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = *reinterpret_cast<const float4*>(&s_w[k4 + u][4 * lane]);
#pragma unroll
      for (int j = 0; j < AK_RPT; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(&s_x[r0 + j][k4]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float a = lane_of(xv, u);
          acc[j][0] = fmaf(a, w[u].x, acc[j][0]);
          acc[j][1] = fmaf(a, w[u].y, acc[j][1]);
          acc[j][2] = fmaf(a, w[u].z, acc[j][2]);
          acc[j][3] = fmaf(a, w[u].w, acc[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < AK_RPT; ++j) {
      const int s = s0 + r0 + j;
      if (s >= S) break;
      float* dst = yb + (long long)s * N + nc;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (nc + q < N) dst[q] = acc[j][q];
      }
    }
    __syncthreads();   // this tile's x read before the next is staged
  }
}

// -- prefill, narrow N: one FMA chain an output, x streamed by cp.async ----

constexpr int BN_TS = 64;         // rows a block: one a lane
constexpr int BN_SPLIT = 2;       // warps a row's columns are split over
constexpr int BN_THREADS = BN_TS * BN_SPLIT;
constexpr int BN_TK = 64;         // K a stage
constexpr int BN_STAGES = 4;
constexpr int BN_XS = BN_TK + 4;  // x stage row stride (floats)

// A ring slot holds a stage's x[S-tile, stage] (BN_TS rows) and its raw
// base, tau (as 4-byte words) and mask words; two more buffers hold the
// built weights w[k][n].
template <typename TauT, int NB>
struct NarrowN {
  static constexpr int X = BN_TS * BN_XS;
  static constexpr int BASE = BN_TK * NB;
  static constexpr int TAU = BN_TK * NB * sizeof(TauT) / 4;
  static constexpr int WORDS = BN_TK * NB / 32;
  static constexpr int SLOT = X + BASE + TAU + WORDS;
  static constexpr int W = BN_TK * NB;
  static constexpr size_t bytes() {
    return sizeof(float) * (BN_STAGES * SLOT + 2 * W);
  }
};

// 4-byte words [w0, w0 + count) of src into dst, past ``end`` zeros.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           long long w0, int count,
                                           long long end, int tid) {
  for (int i = tid; i < count; i += BN_THREADS) {
    const bool ok = w0 + i < end;
    cp_async4(reinterpret_cast<float*>(dst + i),
              reinterpret_cast<const float*>(ok ? src + w0 + i : src),
              ok ? 4 : 0);
  }
}

// NB: N rounded up to 16 or 32 (columns past N are 0 and never written).
// VEC: K % 4 == 0 and x 16-byte aligned, so x moves in 16-byte copies.
// Thread h * BN_TS + r takes row r of the S-tile and columns h * NB /
// BN_SPLIT to (h + 1) * NB / BN_SPLIT (the same columns in every lane of a
// warp); each output is one FMA chain over k = 0, 1, ..., K - 1.
template <typename TauT, int NB, bool VEC>
__global__ void __launch_bounds__(BN_THREADS)
modulated_matmul_narrow_n_kernel(const float* __restrict__ x,
                                 const float* __restrict__ base,
                                 const TauT* __restrict__ tau,
                                 const uint32_t* __restrict__ words,
                                 const float* __restrict__ lam, int S, int K,
                                 int N, long long n_words,
                                 float* __restrict__ y) {
  using L = NarrowN<TauT, NB>;
  constexpr int WPT = BN_TK * NB / BN_THREADS;    // weights a thread a stage
  constexpr int NC = NB / BN_SPLIT;               // columns a thread
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* s_w = sm + BN_STAGES * L::SLOT;          // [2][BN_TK][NB]
  const int s0 = blockIdx.x * BN_TS, b = blockIdx.y;
  const int n_tiles = (K + BN_TK - 1) / BN_TK;
  const int tid = threadIdx.x;
  const int r = tid % BN_TS, c0 = tid / BN_TS * NC;
  const float* xb = x + (long long)b * S * K;
  const uint32_t* wb = words + (long long)b * n_words;
  const float lb = lam[b];
  const long long kn = (long long)K * N;

  // stage t's x and raw weights into ring slot t % BN_STAGES.  A stage's
  // leaf elements k0 * N to (k0 + BN_TK) * N start on a mask word (k0 * N
  // is a multiple of 64) and on a 4-byte word of a bf16 tau.
  auto copy_stage = [&](int t) {
    const int k0 = t * BN_TK;
    float* slot = sm + (t % BN_STAGES) * L::SLOT;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < BN_TS * BN_TK / 4 / BN_THREADS; ++j) {
        const int i = tid + j * BN_THREADS;
        const int row = i / (BN_TK / 4), q = 4 * (i % (BN_TK / 4));
        const int s = s0 + row, k = k0 + q;
        const bool ok = s < S && k < K;
        cp_async16(slot + row * BN_XS + q, ok ? xb + (long long)s * K + k : xb,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < BN_TS * BN_TK / BN_THREADS; ++j) {
        const int i = tid + j * BN_THREADS;
        const int row = i / BN_TK, q = i % BN_TK;
        const int s = s0 + row, k = k0 + q;
        const bool ok = s < S && k < K;
        cp_async4(slot + row * BN_XS + q, ok ? xb + (long long)s * K + k : xb,
                  ok ? 4 : 0);
      }
    }
    const long long e0 = (long long)k0 * N;
    const int elems = BN_TK * N;
    auto* raw = reinterpret_cast<uint32_t*>(slot + L::X);
    copy_words(raw, reinterpret_cast<const uint32_t*>(base), e0, elems, kn,
               tid);
    constexpr int per = 4 / sizeof(TauT);   // tau elements a 4-byte word
    copy_words(raw + L::BASE, reinterpret_cast<const uint32_t*>(tau),
               e0 / per, elems / per, kn / per, tid);
    copy_words(raw + L::BASE + L::TAU, wb, e0 / 32, elems / 32, n_words,
               tid);
  };
  // stage t's weights from its raw slot into weight buffer t % 2
  auto build_w = [&](int t) {
    const int k0 = t * BN_TK;
    const float* r_base = sm + (t % BN_STAGES) * L::SLOT + L::X;
    const TauT* r_tau = reinterpret_cast<const TauT*>(r_base + L::BASE);
    const uint32_t* r_words =
        reinterpret_cast<const uint32_t*>(r_base + L::BASE + L::TAU);
    float* dst = s_w + (t % 2) * L::W;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int i = tid + j * BN_THREADS;
      const int kk = i / NB, n = i % NB;
      float w = 0.f;
      if (k0 + kk < K && n < N) {
        const int e = kk * N + n;
        const float bit =
            static_cast<float>((r_words[e >> 5] >> (e & 31)) & 1u);
        w = __fadd_rn(r_base[e],
                      __fmul_rn(__fmul_rn(lb, bit), to_f32(r_tau[e])));
      }
      dst[i] = w;
    }
  };

  float acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.f;

  constexpr int AHEAD = BN_STAGES - 1;   // stages in flight
#pragma unroll
  for (int t = 0; t < AHEAD; ++t) {
    if (t < n_tiles) copy_stage(t);
    cp_async_commit();
  }
  cp_async_wait<AHEAD - 1>();   // stage 0 has landed
  __syncthreads();
  build_w(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + AHEAD < n_tiles) copy_stage(t + AHEAD);   // slot of stage t - 1
    cp_async_commit();
    cp_async_wait<AHEAD - 1>();   // stages t and t + 1 have landed
    __syncthreads();              // and the weights of stage t are built
    const float* xr = sm + (t % BN_STAGES) * L::SLOT + r * BN_XS;
    const float* bw = s_w + (t % 2) * L::W + c0;
#pragma unroll 2
    for (int kk = 0; kk < BN_TK; kk += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = lane_of(xv, u);
        const float4* wr = reinterpret_cast<const float4*>(bw + (kk + u) * NB);
#pragma unroll
        for (int q = 0; q < NC / 4; ++q) {
          const float4 w = wr[q];   // the same address in every lane
          acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
        }
      }
    }
    if (t + 1 < n_tiles) build_w(t + 1);
    __syncthreads();   // slot t read before stage t + BN_STAGES lands in it
  }
  cp_async_wait<0>();
  const int s = s0 + r;
  if (s >= S) return;
  float* dst = y + ((long long)b * S + s) * N + c0;
  if ((N & 3) == 0) {
#pragma unroll
    for (int q = 0; q < NC / 4; ++q)
      if (c0 + 4 * q < N)
        *reinterpret_cast<float4*>(dst + 4 * q) =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                        acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (c0 + n < N) dst[n] = acc[n];
  }
}

// -- the general tile: (N-tile, S-tile, request) blocks walking K ----------

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

// The sum of the chunks' partials into y, in ascending chunk order.
cudaError_t launch_reduce(const float* ws, int B, int S, int N, int n_chunks,
                          float* y, cudaStream_t st) {
  const long long sn = (long long)S * N, total = (long long)B * sn;
  const unsigned blocks =
      static_cast<unsigned>((total + DTHREADS - 1) / DTHREADS);
  modulated_matmul_reduce_kernel<<<blocks, DTHREADS, 0, st>>>(ws, n_chunks,
                                                               sn, total, y);
  return cudaGetLastError();
}

template <typename TauT>
cudaError_t launch_narrow_k(const float* x, const float* base,
                            const TauT* tau, const uint32_t* words,
                            const float* lam, int B, int S, int K, int N,
                            long long n_words, float* y, cudaStream_t st) {
  const long long tiles = (S + AK_TS - 1) / AK_TS;
  const long long ntn = (N + AK_TN - 1) / AK_TN;
  long long per = (tiles * ntn * B + AK_TARGET_BLOCKS - 1) / AK_TARGET_BLOCKS;
  if (per < (tiles + 65534) / 65535) per = (tiles + 65534) / 65535;
  const long long groups = (tiles + per - 1) / per;
  if (ntn > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ntn), static_cast<unsigned>(groups),
                  B);
  modulated_matmul_narrow_k_kernel<TauT><<<grid, AK_THREADS, 0, st>>>(
      x, base, tau, words, lam, S, K, N, static_cast<int>(per), n_words, y);
  return cudaGetLastError();
}

// Opts one instance in to its dynamic shared memory once, then launches.
template <typename TauT, int NB, bool VEC>
cudaError_t launch_narrow_n_as(const float* x, const float* base,
                               const TauT* tau, const uint32_t* words,
                               const float* lam, int B, int S, int K, int N,
                               long long n_words, float* y, cudaStream_t st) {
  static bool opted_in = false;
  constexpr size_t bytes = NarrowN<TauT, NB>::bytes();
  auto kern = modulated_matmul_narrow_n_kernel<TauT, NB, VEC>;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((S + BN_TS - 1) / BN_TS, B);
  kern<<<grid, BN_THREADS, bytes, st>>>(x, base, tau, words, lam, S, K, N,
                                        n_words, y);
  return cudaGetLastError();
}

template <typename TauT>
cudaError_t launch_narrow_n(const float* x, const float* base,
                            const TauT* tau, const uint32_t* words,
                            const float* lam, int B, int S, int K, int N,
                            long long n_words, float* y, cudaStream_t st) {
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (N <= 16)
    return vec ? launch_narrow_n_as<TauT, 16, true>(x, base, tau, words, lam,
                                                    B, S, K, N, n_words, y, st)
               : launch_narrow_n_as<TauT, 16, false>(x, base, tau, words,
                                                     lam, B, S, K, N, n_words,
                                                     y, st);
  return vec ? launch_narrow_n_as<TauT, 32, true>(x, base, tau, words, lam, B,
                                                  S, K, N, n_words, y, st)
             : launch_narrow_n_as<TauT, 32, false>(x, base, tau, words, lam,
                                                   B, S, K, N, n_words, y, st);
}

template <typename TauT>
cudaError_t launch_prefill(const float* x, const float* base, const TauT* tau,
                           const uint32_t* words, const float* lam, int B,
                           int S, int K, int N, float* y, cudaStream_t st) {
  const long long n_words = (long long)K * N / 32;
  if (K <= NARROW)
    return launch_narrow_k(x, base, tau, words, lam, B, S, K, N, n_words, y,
                           st);
  if (N <= NARROW)
    return launch_narrow_n(x, base, tau, words, lam, B, S, K, N, n_words, y,
                           st);
  if ((S + TS - 1) / TS > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + TN - 1) / TN, (S + TS - 1) / TS, B);
  modulated_matmul_kernel<TauT><<<grid, THREADS, 0, st>>>(
      x, base, tau, words, lam, S, K, N, n_words, y);
  return cudaGetLastError();
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
      ((long long)K * N) % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_words = (long long)K * N / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const float*>(x);
  auto* bp = static_cast<const float*>(base);
  auto* wp = static_cast<const uint32_t*>(words);
  auto* lp = static_cast<const float*>(lam);
  auto* wsp = static_cast<float*>(ws);
  auto* yp = static_cast<float*>(y);
  if (S > DECODE_MAX_S) {
    const cudaError_t e =
        tau_bf16 ? launch_prefill(xp, bp,
                                  static_cast<const __nv_bfloat16*>(tau), wp,
                                  lp, B, S, K, N, yp, s)
                 : launch_prefill(xp, bp, static_cast<const float*>(tau), wp,
                                  lp, B, S, K, N, yp, s);
    return static_cast<int>(e);
  }
  if (kc < 1 || kc > KC_MAX || (N + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (K + kc - 1) / kc;
  if (n_chunks > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = n_chunks > 1 ? wsp : yp;
  if (tau_bf16)
    launch_decode(xp, bp, static_cast<const __nv_bfloat16*>(tau), wp, lp, B,
                  S, K, N, kc, n_chunks, n_words, out, s);
  else
    launch_decode(xp, bp, static_cast<const float*>(tau), wp, lp, B, S, K, N,
                  kc, n_chunks, n_words, out, s);
  if (n_chunks > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_reduce(wsp, B, S, N, n_chunks, yp, s));
  }
  return static_cast<int>(cudaGetLastError());
}
