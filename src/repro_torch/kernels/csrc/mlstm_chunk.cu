// Chunkwise-parallel stabilised mLSTM (the xLSTM block's prefill):
//   (q, k, v, i_pre, f_pre, (C0, n0, m0), chunk) -> (h, (C, n, m))
// q, k (BH, S, Dk) and v (BH, S, Dv) in T (fp32 or bf16); the gates
// i_pre, f_pre (BH, S) fp32; the state C (BH, Dk, Dv), n (BH, Dk), m (BH)
// fp32, read from C0/n0/m0 and written to C1/n1/m1.  n1/m1 must be
// separate buffers; C1 may be C0 itself, since each main-kernel block
// reads its own C tile once, at the start, and no other block touches
// that tile; h (BH, S, Dv) in T.  S is padded to a chunk multiple inside
// the kernels with the JAX package's identity steps (q = k = v = 0,
// i = -1e30, f = +40), so the final state is the padded computation's.
// Dk and Dv must make rows of whole 16-byte pieces (multiples of 8 in
// bf16, of 4 in fp32): the main kernel copies its tiles 16 bytes at a time.
//
// Replaces mlstm_chunkwise_pallas (src/repro/kernels/mlstm_chunk.py), which
// keeps one (batch, head)'s whole chunk working set in VMEM: the Dk x Dv C
// carry, the q/k/v chunk and the L x L decay matrix.  On this card a block
// has 227 KB of shared memory and B * H is only 32 pairs for 132 SMs, so
// one C call launches three kernels on the stream:
//
// 1. mlstm_stats_kernel, one block a b*h, walks the chunks in order: the
//    gate statistics (bcum, m_t, scale_inter, wgt, decay, m at the chunk's
//    start) and the n chain (n at each chunk's start, n += wgt k), into
//    an fp32 workspace; it writes the final n and m.
// 2. mlstm_scores_kernel, one block a (32-row query tile, chunk, b*h),
//    512 at the serving shape: the causal w = decay weight * round_T(q.k)
//    rounded to T into a T workspace (the sub-tiles on and below the
//    diagonal, zeros above it), qn_intra (the row sum of the unrounded
//    w), and the divisor max(|qn_inter + qn_intra|, exp(-m_t)).
// 3. mlstm_chunk_kernel, one block a (b*h, 64-column Dv tile), 512 at the
//    serving shape, keeps its Dk x 64 slice of C in shared memory in fp32
//    and walks the chunks: h = (q.C * scale_inter + w @ v) / den for each
//    32-row query sub-tile, then C = decay C + (wgt k)^T v.  Its q, w, k
//    and v sub-tiles go global -> shared with cp.async (16-byte
//    cp.async.cg) into two stage buffers kept in T, converted at use: the
//    next stage's copies fly while the current one's products run.
//
// What bounds it: at the serving shape (B 8, H 4, S 512, Dk 256, Dv 1024,
// L 256) about 17.2 GFLOP of fp32 work (q.C and the state fold, 67 TFLOP/s
// on the CUDA cores) and 5.4 GFLOP of causal q.k and w @ v (bf16 operands,
// tensor-core work at 989 TFLOP/s) against ~151 MB of traffic in bf16: the
// fp32 operations.  Before this design every one of a head's 16 Dv-tile
// blocks recomputed q.k and the row statistics (41 GFLOP of work for 22.6
// needed) and loaded each tile through registers in series (~2,000 load
// steps a block and chunk).  Now q.k and the statistics run once, and the
// main kernel's loads overlap its products; it runs every product on the
// CUDA cores from shared memory, so its floor is the shared-memory loads
// that feed them (about 150 k wavefronts a block and chunk).  In bf16 a
// block takes 107 KB of shared memory and at most 128 registers: two
// blocks a SM; fp32 (147 KB) runs one.  Left for later: bf16 q.k and
// w @ v on tensor cores (mma.sync, then wgmma), TMA with mbarriers in
// place of cp.async, register-blocked fp32 state products.
//
// Numerics (no fast math; expf/log1pf/IEEE division):
// * log sigmoid(f) = -(max(-f, 0) + log1p(exp(-|f|))), JAX's softplus;
// * bcum, the cumsum of log sigmoid(f) over the chunk, is summed in fp64 in
//   order and rounded to fp32 once per step: the plain version rounds its
//   fp64 cumsum the same way, so both hold the same bcum;
// * the q.k score, w before w @ v, and w @ v itself round to T (bf16) as
//   the JAX package's einsums do at bf16; in fp32 that is the identity;
//   qn_intra sums the unrounded w, as the plain version does;
// * nvcc contracts the multiply-adds of the dot products (q.k, q.C, q.n,
//   w @ v, (wgt k)^T v) into FMAs; w = decay weight * score,
//   h_inter * scale, qn_inter * scale, h_inter + h_intra, wgt * k,
//   decay * C and decay * n + sum wgt k round each op (__fmul_rn /
//   __fadd_rn), as the plain version's separate ops do;
// * the divisors are computed once per (b*h, chunk, row) by the scores
//   kernel, so all Dv tiles of a head divide by the same numbers by
//   construction; every sum has a fixed order, so a call is bitwise
//   repeatable.
#include "launch.cuh"

namespace {

constexpr int TV = 64;       // value columns per main-kernel block
constexpr int TQ = 32;       // query rows per sub-tile
constexpr int TS = 32;       // key rows per sub-tile
constexpr int THREADS = 256;
constexpr int MAX_DK = THREADS;  // n is updated one coordinate per thread

// The fp32 workspace of one (b*h, chunk): G_ROWS rows of L values, then
// n at the chunk's start (DK), then decay and m at the chunk's start.
enum { G_BCUM, G_I, G_MT, G_SC, G_WG, G_QN, G_DEN, G_ROWS };

__host__ __device__ __forceinline__ long long stats_floats(int L, int DK) {
  return (long long)G_ROWS * L + DK + 2;
}
// w's row stride in the T workspace: L rounded up to whole key sub-tiles
__host__ __device__ __forceinline__ int w_stride(int L) {
  return (L + TS - 1) / TS * TS;
}
// A main-kernel stage buffer, in values of T: region A, a q or k
// sub-tile (TS x DK) or a w sub-tile (TQ x TS, TQ = TS), then region B,
// a v sub-tile (TS x TV).
__host__ __device__ __forceinline__ int stage_a(int DK) {
  return TS * (DK > TS ? DK : TS);
}
__host__ __device__ __forceinline__ int stage_values(int DK) {
  return stage_a(DK) + TS * TV;
}

__device__ __forceinline__ float logsigmoid(float x) {
  const float y = -x;
  return -(fmaxf(y, 0.f) + log1pf(expf(-fabsf(y))));
}

template <typename T>
__device__ __forceinline__ float round_t(float x) { return x; }
template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// shared-memory floats of each kernel's block
// (kernels/mlstm_chunk.py::smem_bytes)
__host__ __forceinline__ long long stats_smem_floats(int L) {
  return 4LL * L;
}
__host__ __forceinline__ long long scores_smem_floats(int L, int DK) {
  return (long long)(TQ + TS) * (DK + 1) + TQ * (TS + 1) + 2LL * L + DK +
         TQ;
}
// the C slice and the divisor rows in fp32, two stage buffers in T
template <typename T>
__host__ __forceinline__ long long main_smem_floats(int L, int DK) {
  return (long long)DK * TV + 3LL * L +
         2LL * stage_values(DK) * (long long)sizeof(T) / sizeof(float);
}

// -- pre-pass 1: gate statistics and the n / m chain, one block a b*h ----
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_stats_kernel(const T* __restrict__ k, const float* __restrict__ ig,
                   const float* __restrict__ fg, const float* __restrict__ n0,
                   const float* __restrict__ m0, float* __restrict__ ws,
                   float* __restrict__ n1, float* __restrict__ m1, int S,
                   int L, int DK) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;        // L  log sigmoid(f), then bcum
  float* sI = sB + L;      // L  i
  float* sMt = sI + L;     // L  cummax of i - bcum
  float* sWg = sMt + L;    // L  wgt
  __shared__ float s_m, s_total, s_mnext;

  const int bh = blockIdx.x, tid = threadIdx.x;
  const long long k0 = (long long)bh * S * DK, g0 = (long long)bh * S;
  const int n_chunks = (S + L - 1) / L;
  const long long F = stats_floats(L, DK);
  float n = tid < DK ? n0[(long long)bh * DK + tid] : 0.f;
  if (tid == 0) s_m = m0[bh];

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int tb = ch * L;
    float* g = ws + ((long long)bh * n_chunks + ch) * F;
    for (int t = tid; t < L; t += THREADS) {
      const bool real = tb + t < S;
      sI[t] = real ? ig[g0 + tb + t] : -1e30f;
      sB[t] = logsigmoid(real ? fg[g0 + tb + t] : 40.f);
    }
    __syncthreads();
    if (tid == 0) {
      double acc = 0.0;
      float cmax = __int_as_float(0xff800000);  // -inf
      for (int t = 0; t < L; ++t) {
        acc += (double)sB[t];
        const float b = (float)acc;
        sB[t] = b;
        cmax = fmaxf(cmax, sI[t] - b);
        sMt[t] = cmax;
      }
      const float total = sB[L - 1];
      s_total = total;
      s_mnext = fmaxf(s_m + total, total + cmax);
    }
    __syncthreads();
    const float m = s_m, total = s_total, m_next = s_mnext;
    for (int t = tid; t < L; t += THREADS) {
      const float b = sB[t];
      const float mt = b + fmaxf(m, sMt[t]);
      const float wg = expf(((total - b) + sI[t]) - m_next);
      sWg[t] = wg;
      g[G_BCUM * L + t] = b;
      g[G_I * L + t] = sI[t];
      g[G_MT * L + t] = mt;
      g[G_SC * L + t] = expf((b + m) - mt);
      g[G_WG * L + t] = wg;
    }
    const float decay = expf((m + total) - m_next);
    if (tid < DK) g[G_ROWS * L + tid] = n;
    if (tid == 0) {
      g[G_ROWS * L + DK] = decay;
      g[G_ROWS * L + DK + 1] = m;
    }
    __syncthreads();                       // sWg complete
    if (tid < DK) {
      // sum of wgt * k over the chunk's real steps, in step order (the
      // padded steps add wgt * 0)
      const int real = min(L, S - tb);
      float nacc = 0.f;
      for (int s0 = 0; s0 < real; s0 += 8) {
        float kv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          kv[u] = s0 + u < real
                      ? to_f32(k[k0 + (long long)(tb + s0 + u) * DK + tid])
                      : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (s0 + u < real)
            nacc = __fadd_rn(nacc, __fmul_rn(sWg[s0 + u], kv[u]));
      }
      n = __fadd_rn(__fmul_rn(decay, n), nacc);
    }
    if (tid == 0) s_m = m_next;
    __syncthreads();                       // sB, sI, sWg reused
  }
  if (tid < DK) n1[(long long)bh * DK + tid] = n;
  if (tid == 0) m1[bh] = s_m;
}

// -- pre-pass 2: w, qn_intra and the divisor, one block a (query tile,
//    chunk, b*h) --------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    float* __restrict__ ws, T* __restrict__ wsw, int S,
                    int L, int DK) {
  extern __shared__ __align__(16) float smem[];
  const int DKP = DK + 1;                 // padded row: no bank conflicts
  float* sQ = smem;                       // TQ x DKP  q sub-tile
  float* sK = sQ + TQ * DKP;              // TS x DKP  k sub-tile
  float* sW = sK + TS * DKP;              // TQ x (TS+1) w sub-tile
  float* sB = sW + TQ * (TS + 1);         // L  bcum of the keys
  float* sI = sB + L;                     // L  i of the keys
  float* sN = sI + L;                     // DK n at the chunk's start
  float* sQa = sN + DK;                   // TQ qn_intra

  const int r0 = blockIdx.x * TQ, ch = blockIdx.y, bh = blockIdx.z;
  const int n_chunks = gridDim.y, tb = ch * L, LS = w_stride(L);
  const int last = min(r0 + TQ, L);       // causal: keys < last
  const int tid = threadIdx.x;
  const int rs = tid / 8, sg = tid % 8;   // score row rs; keys sg + 8j
  const long long qk0 = (long long)bh * S * DK;
  float* g = ws + ((long long)bh * n_chunks + ch) * stats_floats(L, DK);
  T* wrow = wsw + ((long long)bh * n_chunks + ch) * L * LS;

  for (int s = tid; s < last; s += THREADS) {
    sB[s] = g[G_BCUM * L + s];
    sI[s] = g[G_I * L + s];
  }
  for (int d = tid; d < DK; d += THREADS) sN[d] = g[G_ROWS * L + d];
  for (int i = tid; i < TQ * DK; i += THREADS) {
    const int r = i / DK, d = i % DK, t = r0 + r;
    sQ[r * DKP + d] = (t < L && tb + t < S)
                          ? to_f32(q[qk0 + (long long)(tb + t) * DK + d])
                          : 0.f;
  }
  const int t_s = r0 + rs;               // this thread's score row
  const float bt = t_s < L ? g[G_BCUM * L + t_s] : 0.f;
  const float mt = t_s < L ? g[G_MT * L + t_s] : 0.f;
  float qpart = 0.f;                     // sum of w over this thread's keys
  for (int s0 = 0; s0 < last; s0 += TS) {
    __syncthreads();                     // sK / sW free; sQ, sB ready
    for (int i = tid; i < TS * DK; i += THREADS) {
      const int r = i / DK, d = i % DK, s = s0 + r;
      sK[r * DKP + d] = (s < L && tb + s < S)
                            ? to_f32(k[qk0 + (long long)(tb + s) * DK + d])
                            : 0.f;
    }
    __syncthreads();
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < DK; ++d) {
      const float qv = sQ[rs * DKP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] += qv * sK[(sg + 8 * j) * DKP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + sg + 8 * j;
      float w = 0.f;
      if (t_s < L && s <= t_s) {
        const float dm = expf(((bt - sB[s]) + sI[s]) - mt);
        w = __fmul_rn(dm, round_t<T>(sc[j]));
      }
      qpart += w;
      sW[rs * (TS + 1) + sg + 8 * j] = w;
    }
    __syncthreads();
    // the whole sub-tile, zeros above the diagonal and past L included
    for (int i = tid; i < TQ * TS; i += THREADS) {
      const int r = i / TS, c = i % TS;
      if (r0 + r < L)
        store_t(wrow + (long long)(r0 + r) * LS + s0 + c, sW[r * (TS + 1) + c]);
    }
  }
  // qn_intra: the 8 lanes of a score row are adjacent in one warp
  qpart += __shfl_down_sync(0xffffffffu, qpart, 4, 8);
  qpart += __shfl_down_sync(0xffffffffu, qpart, 2, 8);
  qpart += __shfl_down_sync(0xffffffffu, qpart, 1, 8);
  if (sg == 0) sQa[rs] = qpart;
  __syncthreads();
  if (tid < TQ && r0 + tid < L) {
    const int t = r0 + tid;
    float a = 0.f;
    for (int d = 0; d < DK; ++d) a += sQ[tid * DKP + d] * sN[d];
    const float qn = __fmul_rn(a, g[G_SC * L + t]) + sQa[tid];
    g[G_QN * L + t] = sQa[tid];
    g[G_DEN * L + t] = fmaxf(fabsf(qn), expf(-g[G_MT * L + t]));
  }
}

// -- the main kernel: q.C, w @ v and the state fold, one block a (b*h,
//    Dv tile) --------------------------------------------------------------
// Its loads form one sequence of stages, walked in this order for each
// chunk: Q (a query sub-tile), then WV (a w sub-tile and the v sub-tile
// of its keys) for each causal key sub-tile, and after the last query
// sub-tile KV (a k sub-tile and its v sub-tile) for each key sub-tile.
enum { ST_Q, ST_WV, ST_KV, ST_DONE };
struct Stage {
  int kind, ch, r0, s0;
};

__device__ __forceinline__ Stage next_stage(Stage st, int L, int n_chunks) {
  if (st.kind == ST_Q) return {ST_WV, st.ch, st.r0, 0};
  if (st.kind == ST_WV) {
    if (st.s0 + TS < min(st.r0 + TQ, L))
      return {ST_WV, st.ch, st.r0, st.s0 + TS};
    if (st.r0 + TQ < L) return {ST_Q, st.ch, st.r0 + TQ, 0};
    return {ST_KV, st.ch, 0, 0};
  }
  if (st.kind == ST_KV) {
    if (st.s0 + TS < L) return {ST_KV, st.ch, 0, st.s0 + TS};
    if (st.ch + 1 < n_chunks) return {ST_Q, st.ch + 1, 0, 0};
  }
  return {ST_DONE, 0, 0, 0};
}

// 16 bytes global -> shared without a register stop; src_size 0 writes
// zeros (rows past S or L, columns past Dv)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive values of a shared tile as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One stage's copies into a buffer (stage_a / stage_values).
template <typename T>
__device__ __forceinline__ void copy_stage(
    const Stage& st, T* buf, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ wsw, int bh, int c0, int S, int L, int DK, int DV,
    int n_chunks) {
  constexpr int PER = 16 / sizeof(T);     // values a 16-byte piece
  T* A = buf;
  T* B = buf + stage_a(DK);
  const int tid = threadIdx.x, tb = st.ch * L;
  if (st.kind == ST_Q || st.kind == ST_KV) {
    const T* src = st.kind == ST_Q ? q : k;
    const int r0 = st.kind == ST_Q ? st.r0 : st.s0;
    const int per_row = DK / PER;
    for (int i = tid; i < TS * per_row; i += THREADS) {
      const int r = i / per_row, c = i % per_row * PER, t = r0 + r;
      const bool ok = t < L && tb + t < S;
      cp_async16(A + r * DK + c,
                 ok ? src + ((long long)bh * S + tb + t) * DK + c : src, ok);
    }
  } else {                                // ST_WV: the w sub-tile
    const int LS = w_stride(L), per_row = TS / PER;
    const T* wrow = wsw + ((long long)bh * n_chunks + st.ch) * L * LS;
    for (int i = tid; i < TQ * per_row; i += THREADS) {
      const int r = i / per_row, c = i % per_row * PER;
      const bool ok = st.r0 + r < L;
      cp_async16(A + r * TS + c,
                 ok ? wrow + (long long)(st.r0 + r) * LS + st.s0 + c : wsw,
                 ok);
    }
  }
  if (st.kind != ST_Q) {                  // the v sub-tile of the keys
    const int per_row = TV / PER;
    for (int i = tid; i < TS * per_row; i += THREADS) {
      const int r = i / per_row, c = i % per_row * PER, s = st.s0 + r;
      const bool ok = s < L && tb + s < S && c0 + c < DV;
      cp_async16(B + r * TV + c,
                 ok ? v + ((long long)bh * S + tb + s) * DV + c0 + c : v, ok);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ws,
                   const T* __restrict__ wsw, const float* C0,
                   T* __restrict__ h, float* C1, int S, int L, int DK,
                   int DV) {
  extern __shared__ __align__(16) float smem[];
  float* sC = smem;                       // DK x TV   the C slice
  T* bufs = reinterpret_cast<T*>(sC + DK * TV);  // 2 stage buffers, in T
  const int stage = stage_values(DK);
  float* sSc = reinterpret_cast<float*>(bufs + 2 * stage);  // L scale_inter
  float* sWg = sSc + L;                   // L  wgt
  float* sDen = sWg + L;                  // L  divisors

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * TV;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // rows ty, ty+16; cols 4tx..+3
  const long long v0 = (long long)bh * S * DV;
  const int n_chunks = (S + L - 1) / L;

  // the first stage's copies fly while the C slice loads
  Stage nxt = {ST_Q, 0, 0, 0};
  copy_stage(nxt, bufs, q, k, v, wsw, bh, c0, S, L, DK, DV, n_chunks);
  cp_async_commit();
  nxt = next_stage(nxt, L, n_chunks);
  int cur = 0;                            // the buffer of the current stage
  for (int i = tid; i < DK * TV; i += THREADS) {
    const int d = i / TV, c = c0 + i % TV;
    sC[i] = c < DV ? C0[((long long)bh * DK + d) * DV + c] : 0.f;
  }
  // Start a stage: put the next one's copies in flight into the other
  // buffer (free since the last stage's closing barrier), then wait for
  // this one's.  End a stage: a barrier, so the buffer may be refilled.
  auto begin = [&]() {
    if (nxt.kind != ST_DONE) {
      copy_stage(nxt, bufs + (cur ^ 1) * stage, q, k, v, wsw, bh, c0, S, L,
                 DK, DV, n_chunks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return bufs + cur * stage;
  };
  auto end = [&]() {
    __syncthreads();
    cur ^= 1;
    nxt = next_stage(nxt, L, n_chunks);
  };

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int tb = ch * L;
    const float* g = ws + ((long long)bh * n_chunks + ch) * stats_floats(L, DK);
    for (int t = tid; t < L; t += THREADS) {   // read after the next barrier
      sSc[t] = g[G_SC * L + t];
      sWg[t] = g[G_WG * L + t];
      sDen[t] = g[G_DEN * L + t];
    }
    const float decay = g[G_ROWS * L + DK];

    // -- outputs, one query sub-tile at a time -------------------------
    for (int r0 = 0; r0 < L; r0 += TQ) {
      float hi[2][4], ha[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) hi[u][j] = ha[u][j] = 0.f;
      {                                   // Q: h_inter = q . C
        const T* sQ = begin();
#pragma unroll 4
        for (int d = 0; d < DK; ++d) {
          const float4 cv = load4(sC + d * TV + 4 * tx);
          const float qa = to_f32(sQ[ty * DK + d]);
          const float qb = to_f32(sQ[(ty + 16) * DK + d]);
          hi[0][0] += qa * cv.x; hi[0][1] += qa * cv.y;
          hi[0][2] += qa * cv.z; hi[0][3] += qa * cv.w;
          hi[1][0] += qb * cv.x; hi[1][1] += qb * cv.y;
          hi[1][2] += qb * cv.z; hi[1][3] += qb * cv.w;
        }
        end();
      }
      const int last = min(r0 + TQ, L);    // causal: keys < last
      for (int s0 = 0; s0 < last; s0 += TS) {  // WV: h_intra = w @ v
        const T* sW = begin();
        const T* sV = sW + stage_a(DK);
#pragma unroll 4
        for (int s = 0; s < TS; ++s) {
          const float4 vv = load4(sV + s * TV + 4 * tx);
          const float wa = to_f32(sW[ty * TS + s]);
          const float wb = to_f32(sW[(ty + 16) * TS + s]);
          ha[0][0] += wa * vv.x; ha[0][1] += wa * vv.y;
          ha[0][2] += wa * vv.z; ha[0][3] += wa * vv.w;
          ha[1][0] += wb * vv.x; ha[1][1] += wb * vv.y;
          ha[1][2] += wb * vv.z; ha[1][3] += wb * vv.w;
        }
        end();
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = r0 + ty + 16 * u;
        if (t >= L || tb + t >= S) continue;
        const float sc_in = sSc[t], den = sDen[t];
        T* out = h + v0 + (long long)(tb + t) * DV;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 4 * tx + j;
          if (c >= DV) continue;
          const float num =
              __fadd_rn(__fmul_rn(hi[u][j], sc_in), round_t<T>(ha[u][j]));
          store_t(out + c, num / den);
        }
      }
    }

    // -- KV: fold the chunk into the state, C = decay C + (wgt k)^T v ----
    for (int s0 = 0; s0 < L; s0 += TS) {
      const T* sK = begin();
      const T* sV = sK + stage_a(DK);
      for (int d0 = ty; d0 < DK; d0 += 64) {   // rows d0 + 16u, u < 4
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = d0 + 16 * u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float c = d < DK ? sC[d * TV + 4 * tx + j] : 0.f;
            acc[u][j] = s0 == 0 ? __fmul_rn(decay, c) : c;
          }
        }
#pragma unroll 4
        for (int s = 0; s < TS; ++s) {
          const float4 vv = load4(sV + s * TV + 4 * tx);
          // a row past L holds zeros; any finite wgt leaves it so
          const float wg = sWg[min(s0 + s, L - 1)];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = d0 + 16 * u;
            const float kw =
                d < DK ? __fmul_rn(wg, to_f32(sK[s * DK + d])) : 0.f;
            acc[u][0] += kw * vv.x; acc[u][1] += kw * vv.y;
            acc[u][2] += kw * vv.z; acc[u][3] += kw * vv.w;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = d0 + 16 * u;
          if (d < DK)
#pragma unroll
            for (int j = 0; j < 4; ++j) sC[d * TV + 4 * tx + j] = acc[u][j];
        }
      }
      end();
    }
  }
  for (int i = tid; i < DK * TV; i += THREADS) {
    const int d = i / TV, c = c0 + i % TV;
    if (c < DV) C1[((long long)bh * DK + d) * DV + c] = sC[i];
  }
}

template <typename K>
cudaError_t set_smem(K kernel, long long floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float) * floats));
}

// the pre-pass: statistics and n / m chain, then w and the divisors
template <typename T>
cudaError_t prepass(const void* q, const void* k, const void* ig,
                    const void* fg, const void* n0, const void* m0, void* n1,
                    void* m1, void* ws, void* wsw, int BH, int S, int L,
                    int DK, cudaStream_t stream) {
  const long long f_stats = stats_smem_floats(L);
  const long long f_scores = scores_smem_floats(L, DK);
  cudaError_t err = set_smem(mlstm_stats_kernel<T>, f_stats);
  if (err == cudaSuccess) err = set_smem(mlstm_scores_kernel<T>, f_scores);
  if (err != cudaSuccess) return err;
  mlstm_stats_kernel<T><<<BH, THREADS, sizeof(float) * f_stats, stream>>>(
      static_cast<const T*>(k), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<float*>(ws),
      static_cast<float*>(n1), static_cast<float*>(m1), S, L, DK);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TQ - 1) / TQ, (S + L - 1) / L, BH);
  mlstm_scores_kernel<T><<<grid, THREADS, sizeof(float) * f_scores, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<float*>(ws), static_cast<T*>(wsw), S, L, DK);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ig, const void* fg, const void* C0,
                   const void* n0, const void* m0, void* h, void* C1,
                   void* n1, void* m1, void* ws, void* wsw, int BH, int S,
                   int L, int DK, int DV, cudaStream_t stream) {
  const long long f_main = main_smem_floats<T>(L, DK);
  cudaError_t err = set_smem(mlstm_chunk_kernel<T>, f_main);
  if (err != cudaSuccess) return err;
  err = prepass<T>(q, k, ig, fg, n0, m0, n1, m1, ws, wsw, BH, S, L, DK,
                   stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((DV + TV - 1) / TV, BH);
  mlstm_chunk_kernel<T><<<grid, THREADS, sizeof(float) * f_main, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ws),
      static_cast<const T*>(wsw), static_cast<const float*>(C0),
      static_cast<T*>(h), static_cast<float*>(C1), S, L, DK, DV);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int L, int DK, int* blocks) {
  const long long f[3] = {stats_smem_floats(L), scores_smem_floats(L, DK),
                          main_smem_floats<T>(L, DK)};
  cudaError_t err = set_smem(mlstm_stats_kernel<T>, f[0]);
  if (err == cudaSuccess) err = set_smem(mlstm_scores_kernel<T>, f[1]);
  if (err == cudaSuccess) err = set_smem(mlstm_chunk_kernel<T>, f[2]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, mlstm_stats_kernel<T>, THREADS, sizeof(float) * f[0]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 1, mlstm_scores_kernel<T>, THREADS, sizeof(float) * f[1]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, mlstm_chunk_kernel<T>, THREADS, sizeof(float) * f[2]);
  return err;
}

bool bad_shape(int BH, int S, int L, int DK) {
  return BH < 1 || BH > 65535 || S < 1 || L < 1 || DK < 1 || DK > MAX_DK;
}

}  // namespace

// bf16 = 0: q, k, v and h are fp32; 1: bf16.  ws: the fp32 workspace of
// BH * ceil(S / L) * (G_ROWS * L + DK + 2) floats; wsw: the T workspace
// of BH * ceil(S / L) * L * ceil(L / 32) * 32 values.  One call launches
// the pre-pass and the main kernel.  Returns cudaGetLastError().
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  int bf16, const void* ig, const void* fg,
                                  const void* C0, const void* n0,
                                  const void* m0, void* h, void* C1, void* n1,
                                  void* m1, void* ws, void* wsw, int BH,
                                  int S, int L, int DK, int DV,
                                  void* stream) {
  const int per = bf16 ? 8 : 4;            // values a 16-byte piece
  if (bad_shape(BH, S, L, DK) || DV < 1 || (S + L - 1) / L > 65535 ||
      DK % per || DV % per)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k, v, ig, fg, C0, n0, m0, h, C1, n1, m1, ws, wsw, BH, S, L, DK,
        DV, s));
  return static_cast<int>(launch<float>(q, k, v, ig, fg, C0, n0, m0, h, C1,
                                        n1, m1, ws, wsw, BH, S, L, DK, DV,
                                        s));
}

// The pre-pass alone, into the same workspaces (for its checks against
// its plain version).  Returns cudaGetLastError().
extern "C" int mlstm_chunk_prepass_launch(const void* q, const void* k,
                                          int bf16, const void* ig,
                                          const void* fg, const void* n0,
                                          const void* m0, void* n1, void* m1,
                                          void* ws, void* wsw, int BH, int S,
                                          int L, int DK, void* stream) {
  if (bad_shape(BH, S, L, DK) || (S + L - 1) / L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(prepass<__nv_bfloat16>(
        q, k, ig, fg, n0, m0, n1, m1, ws, wsw, BH, S, L, DK, s));
  return static_cast<int>(prepass<float>(q, k, ig, fg, n0, m0, n1, m1, ws,
                                         wsw, BH, S, L, DK, s));
}

// Resident blocks a SM of the statistics, scores and main kernels at this
// shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into blocks[0..2].
extern "C" int mlstm_chunk_occupancy(int bf16, int L, int DK, int* blocks) {
  if (L < 1 || DK < 1 || DK > MAX_DK)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bf16 ? occupancy<__nv_bfloat16>(L, DK, blocks)
                               : occupancy<float>(L, DK, blocks));
}
