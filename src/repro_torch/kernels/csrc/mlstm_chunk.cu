// Chunkwise-parallel stabilised mLSTM (the xLSTM block's prefill):
//   (q, k, v, i_pre, f_pre, (C0, n0, m0), chunk) -> (h, (C, n, m))
// q, k (BH, S, Dk) and v (BH, S, Dv) in T (fp32 or bf16); the gates
// i_pre, f_pre (BH, S) fp32; the state C (BH, Dk, Dv), n (BH, Dk), m (BH)
// fp32, read from C0/n0/m0 and written to C1/n1/m1.  n1/m1 must be
// separate buffers (an early block would overwrite the n and m another
// block has yet to read); C1 may be C0 itself, since each block reads its
// own C tile once, at the start, and no other block touches that tile;
// h (BH, S, Dv) in T.  S is padded to a chunk multiple inside the kernel
// with the JAX package's identity steps (q = k = v = 0, i = -1e30,
// f = +40), so the final state is the padded computation's.
//
// Replaces mlstm_chunkwise_pallas (src/repro/kernels/mlstm_chunk.py), which
// keeps one (batch, head)'s whole chunk working set in VMEM: the Dk x Dv C
// carry, the q/k/v chunk and the L x L decay matrix.  At xlstm-1.3b's width
// (Dk 256, Dv 1024, L 256) C alone is 1 MB of fp32, the q chunk 256 KB and
// the decay matrix 256 KB; a block has 227 KB of shared memory, and B * H
// is only 32 pairs for 132 SMs.  So one block owns one (b*h, 64-column
// Dv tile): it keeps its 256 x 64 slice of C (64 KB), n and m in shared
// memory and walks the chunks in order.  Within a chunk it takes the query
// rows in sub-tiles of 32, streams the causal key sub-tiles of 32 rows
// past them (scores, decay weights, w @ v), and then folds the chunk into
// its C slice.  The row statistics -- bcum, the cumulative max, m_t,
// qn_inter, qn_intra and the denominator -- depend on all Dk but on no
// value column, so every Dv-tile block of a (b, h) recomputes them, with
// the same code in the same order: all tiles divide by bitwise the same
// numbers.  B = 8, H = 4, Dv = 1024 gives 512 blocks.
//
// What bounds it on this card: at the serving shape (B 8, H 4, S 512) about
// 17.2 GFLOP of fp32 work (q.C and the state fold, 67 TFLOP/s on the CUDA
// cores) and 5.4 GFLOP of causal q.k and w @ v (in bf16, tensor-core work
// at 989 TFLOP/s) against ~109 MB of traffic, so the fp32 operations.
// This first kernel runs them all
// on the CUDA cores from shared memory, and recomputes the q.k scores in
// each of the 16 Dv tiles; wgmma, and sharing the row statistics across
// tiles, are the redesign's work.
//
// Numerics (no fast math; expf/log1pf/IEEE division):
// * log sigmoid(f) = -(max(-f, 0) + log1p(exp(-|f|))), JAX's softplus;
// * bcum, the cumsum of log sigmoid(f) over the chunk, is summed in fp64 in
//   order and rounded to fp32 once per step: the plain version rounds its
//   fp64 cumsum the same way, so both hold the same bcum;
// * the q.k score, w before w @ v, and w @ v itself round to T (bf16) as
//   the JAX package's einsums do at bf16; in fp32 that is the identity;
// * nvcc contracts the multiply-adds of the dot products (q.k, q.C, q.n,
//   w @ v, (wgt k)^T v) into FMAs; w = decay weight * score,
//   h_inter * scale, qn_inter * scale, h_inter + h_intra and
//   decay * n + sum wgt k round each op (__fmul_rn / __fadd_rn), as the
//   plain version's separate ops do.
#include "launch.cuh"

namespace {

constexpr int TV = 64;       // value columns per block (one Dv tile)
constexpr int TQ = 32;       // query rows per sub-tile
constexpr int TS = 32;       // key rows per sub-tile
constexpr int THREADS = 256;
constexpr int MAX_DK = THREADS;  // n is updated one coordinate per thread

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

// shared-memory floats of one block (kernels/mlstm_chunk.py::smem_bytes)
__host__ __forceinline__ long long smem_floats(int L, int DK) {
  return (long long)DK * TV + TS * TV + (long long)TQ * (DK + 1) +
         (long long)TS * (DK + 1) + TQ * (TS + 1) + DK + 5LL * L + 3 * TQ;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, const float* C0,
                   const float* __restrict__ n0, const float* __restrict__ m0,
                   T* __restrict__ h, float* C1,
                   float* __restrict__ n1, float* __restrict__ m1, int S,
                   int L, int DK, int DV) {
  extern __shared__ __align__(16) float smem[];
  const int DKP = DK + 1;                 // padded row: no bank conflicts
  float* sC = smem;                       // DK x TV   the C slice
  float* sV = sC + DK * TV;               // TS x TV   v sub-tile
  float* sQ = sV + TS * TV;               // TQ x DKP  q sub-tile
  float* sK = sQ + TQ * DKP;              // TS x DKP  k (or wgt*k) sub-tile
  float* sW = sK + TS * DKP;              // TQ x (TS+1) w sub-tile
  float* sN = sW + TQ * (TS + 1);         // DK        n
  float* sB = sN + DK;                    // L  log sigmoid(f), then bcum
  float* sI = sB + L;                     // L  i
  float* sMt = sI + L;                    // L  cummax of i - bcum, then m_t
  float* sSc = sMt + L;                   // L  scale_inter
  float* sWg = sSc + L;                   // L  wgt
  float* sQnI = sWg + L;                  // TQ qn_inter of the sub-tile
  float* sQnA = sQnI + TQ;                // TQ qn_intra of the sub-tile
  float* sDen = sQnA + TQ;                // TQ denominators
  __shared__ float s_m, s_total, s_mnext;

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * TV;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // rows ty, ty+16; cols 4tx..+3
  const int rs = tid / 8, sg = tid % 8;     // score row rs; keys sg + 8j
  const long long qk0 = (long long)bh * S * DK;
  const long long v0 = (long long)bh * S * DV;
  const long long g0 = (long long)bh * S;

  for (int i = tid; i < DK * TV; i += THREADS) {
    const int d = i / TV, c = c0 + i % TV;
    sC[i] = c < DV ? C0[((long long)bh * DK + d) * DV + c] : 0.f;
  }
  for (int d = tid; d < DK; d += THREADS) sN[d] = n0[(long long)bh * DK + d];
  if (tid == 0) s_m = m0[bh];
  __syncthreads();

  const int n_chunks = (S + L - 1) / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int tb = ch * L;               // first step of the chunk
    // -- row statistics ------------------------------------------------
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
      sMt[t] = mt;
      sSc[t] = expf((b + m) - mt);
      sWg[t] = expf(((total - b) + sI[t]) - m_next);
    }
    __syncthreads();

    // -- outputs, one query sub-tile at a time -------------------------
    for (int r0 = 0; r0 < L; r0 += TQ) {
      for (int i = tid; i < TQ * DK; i += THREADS) {
        const int r = i / DK, d = i % DK;
        const int t = r0 + r;
        sQ[r * DKP + d] = (t < L && tb + t < S)
                              ? to_f32(q[qk0 + (long long)(tb + t) * DK + d])
                              : 0.f;
      }
      __syncthreads();
      if (tid < TQ && r0 + tid < L) {
        float a = 0.f;
        for (int d = 0; d < DK; ++d) a += sQ[tid * DKP + d] * sN[d];
        sQnI[tid] = __fmul_rn(a, sSc[r0 + tid]);
      }
      float hi[2][4], ha[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) hi[u][j] = ha[u][j] = 0.f;
      for (int d = 0; d < DK; ++d) {
        const float4 cv = *reinterpret_cast<const float4*>(sC + d * TV + 4 * tx);
        const float qa = sQ[ty * DKP + d], qb = sQ[(ty + 16) * DKP + d];
        hi[0][0] += qa * cv.x; hi[0][1] += qa * cv.y;
        hi[0][2] += qa * cv.z; hi[0][3] += qa * cv.w;
        hi[1][0] += qb * cv.x; hi[1][1] += qb * cv.y;
        hi[1][2] += qb * cv.z; hi[1][3] += qb * cv.w;
      }

      float qpart = 0.f;                   // sum of w over this thread's keys
      const int t_s = r0 + rs;             // this thread's score row
      const int last = min(r0 + TQ, L);    // causal: keys < last
      for (int s0 = 0; s0 < last; s0 += TS) {
        __syncthreads();                   // sK/sV/sW free
        for (int i = tid; i < TS * DK; i += THREADS) {
          const int r = i / DK, d = i % DK;
          const int s = s0 + r;
          sK[r * DKP + d] = (s < L && tb + s < S)
                                ? to_f32(k[qk0 + (long long)(tb + s) * DK + d])
                                : 0.f;
        }
        for (int i = tid; i < TS * TV; i += THREADS) {
          const int r = i / TV, c = c0 + i % TV;
          const int s = s0 + r;
          sV[i] = (s < L && tb + s < S && c < DV)
                      ? to_f32(v[v0 + (long long)(tb + s) * DV + c])
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
            const float dm = expf(((sB[t_s] - sB[s]) + sI[s]) - sMt[t_s]);
            w = __fmul_rn(dm, round_t<T>(sc[j]));
          }
          qpart += w;
          sW[rs * (TS + 1) + sg + 8 * j] = round_t<T>(w);
        }
        __syncthreads();
        for (int s = 0; s < TS; ++s) {
          const float4 vv = *reinterpret_cast<const float4*>(sV + s * TV + 4 * tx);
          const float wa = sW[ty * (TS + 1) + s], wb = sW[(ty + 16) * (TS + 1) + s];
          ha[0][0] += wa * vv.x; ha[0][1] += wa * vv.y;
          ha[0][2] += wa * vv.z; ha[0][3] += wa * vv.w;
          ha[1][0] += wb * vv.x; ha[1][1] += wb * vv.y;
          ha[1][2] += wb * vv.z; ha[1][3] += wb * vv.w;
        }
      }
      // qn_intra: the 8 lanes of a score row are adjacent in one warp
      qpart += __shfl_down_sync(0xffffffffu, qpart, 4, 8);
      qpart += __shfl_down_sync(0xffffffffu, qpart, 2, 8);
      qpart += __shfl_down_sync(0xffffffffu, qpart, 1, 8);
      if (sg == 0) sQnA[rs] = qpart;
      __syncthreads();
      if (tid < TQ && r0 + tid < L) {
        const float qn = sQnI[tid] + sQnA[tid];
        sDen[tid] = fmaxf(fabsf(qn), expf(-sMt[r0 + tid]));
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = ty + 16 * u, t = r0 + r;
        if (t >= L || tb + t >= S) continue;
        const float sc_in = sSc[t], den = sDen[r];
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
      __syncthreads();                     // sQ, sW, sDen reused
    }

    // -- fold the chunk into the state ---------------------------------
    const float decay = expf((m + total) - m_next);
    for (int i = tid; i < DK * TV; i += THREADS) sC[i] = decay * sC[i];
    float nacc = 0.f;
    for (int s0 = 0; s0 < L; s0 += TS) {
      __syncthreads();
      for (int i = tid; i < TS * DK; i += THREADS) {
        const int r = i / DK, d = i % DK;
        const int s = s0 + r;
        sK[r * DKP + d] =
            (s < L && tb + s < S)
                ? sWg[s] * to_f32(k[qk0 + (long long)(tb + s) * DK + d])
                : 0.f;
      }
      for (int i = tid; i < TS * TV; i += THREADS) {
        const int r = i / TV, c = c0 + i % TV;
        const int s = s0 + r;
        sV[i] = (s < L && tb + s < S && c < DV)
                    ? to_f32(v[v0 + (long long)(tb + s) * DV + c])
                    : 0.f;
      }
      __syncthreads();
      if (tid < DK)
        for (int s = 0; s < TS; ++s) nacc += sK[s * DKP + tid];
      for (int d0 = ty; d0 < DK; d0 += 64) {   // rows d0 + 16u, u < 4
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = d0 + 16 * u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[u][j] = d < DK ? sC[d * TV + 4 * tx + j] : 0.f;
        }
        for (int s = 0; s < TS; ++s) {
          const float4 vv = *reinterpret_cast<const float4*>(sV + s * TV + 4 * tx);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = d0 + 16 * u;
            const float kw = d < DK ? sK[s * DKP + d] : 0.f;
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
    }
    __syncthreads();
    if (tid < DK) sN[tid] = __fadd_rn(__fmul_rn(decay, sN[tid]), nacc);
    if (tid == 0) s_m = m_next;
    __syncthreads();
  }

  for (int i = tid; i < DK * TV; i += THREADS) {
    const int d = i / TV, c = c0 + i % TV;
    if (c < DV) C1[((long long)bh * DK + d) * DV + c] = sC[i];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < DK; d += THREADS) n1[(long long)bh * DK + d] = sN[d];
    if (tid == 0) m1[bh] = s_m;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, const void* C0, const void* n0, const void* m0,
           void* h, void* C1, void* n1, void* m1, int BH, int S, int L,
           int DK, int DV, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(L, DK);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((DV + TV - 1) / TV, BH);
  mlstm_chunk_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<T*>(h), static_cast<float*>(C1), static_cast<float*>(n1),
      static_cast<float*>(m1), S, L, DK, DV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 = 0: q, k, v and h are fp32; 1: bf16.  Returns cudaGetLastError().
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  int bf16, const void* ig, const void* fg,
                                  const void* C0, const void* n0,
                                  const void* m0, void* h, void* C1, void* n1,
                                  void* m1, int BH, int S, int L, int DK,
                                  int DV, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || L < 1 || DK < 1 || DK > MAX_DK ||
      DV < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, ig, fg, C0, n0, m0, h, C1, n1, m1,
                                 BH, S, L, DK, DV, s);
  return launch<float>(q, k, v, ig, fg, C0, n0, m0, h, C1, n1, m1, BH, S, L,
                       DK, DV, s);
}
