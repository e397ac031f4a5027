// Whole-round Eq. 3 + Eq. 4 over packed mask words, every task in one launch.
//
// Replaces the TPU kernel src/repro/kernels/masked_agg.py::
// masked_agg_batched_packed_pallas.  Per task t and coordinate j, over the
// member clients n (ascending):
//   votes  = sum_n mem * (bit(m & pos) - bit(m & neg)),   a_num = |votes|
//   m_hat  = 1 if a_num / N_t >= rho else a_num / N_t
//   tau    = m_hat * sum_n (gamma*lambda)_n * u_nj * (bit(m & pos) + bit(m & neg))
// where (pos, neg) is the sign of the unified vector u_n and N_t the member
// count.  Outputs tau_hat (T, d) fp32 and a_num (T, d) fp32 (exact integers).
//
// What bounds it on the H100: device-memory bytes (a handful of flops per
// loaded value).  Design against that:
//  * rows with members[n, t] == 0 are skipped — their words are zero and
//    their gamma is zero, so they add nothing.  The TPU kernel's BlockSpec
//    streams all N unified rows for every task; at N = 32, T = 30 and
//    d = 1.3M that is ~2.5 GB a round against ~0.3 GB for the member rows.
//    Each block builds task t's member list once (a warp ballot, ascending
//    n, in shared memory) and walks only those rows;
//  * one thread per coordinate: a warp's unified loads are one coalesced
//    access and all 32 lanes share one mask word (a broadcast load); each
//    thread issues the loads of 4 member rows for 4 coordinates before any
//    use, so 16 of them are in flight together;
//  * pos/neg come from the sign of the bf16 unified value in-register, so
//    no separate sign-plane pass over u is needed;
//  * a few resident waves of blocks walk the coordinate blocks, task the
//    fastest grid axis: the T blocks of one d-range run side by side, so a
//    unified tile is re-read from L2, not from device memory;
//  * sums use __fadd_rn/__fmul_rn: no FMA contraction, the rounding of the
//    plain version in ref.masked_agg_batched_packed_ref, bit for bit.
#include "launch.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 4;                // member rows loaded together
constexpr int GROUPS = 4;                // coordinate blocks per pass

template <typename T>
__global__ void __launch_bounds__(BLOCK)
masked_agg_packed_kernel(const T* __restrict__ unified,
                         const uint32_t* __restrict__ words,
                         const float* __restrict__ gl,
                         const float* __restrict__ mem, int N, int T_,
                         long long d, long long n_words, float rho,
                         float* __restrict__ tau_out,
                         float* __restrict__ anum_out) {
  // the member rows of task t, ascending: index, member weight, gamma*lambda
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_mem = smem + N;
  float* s_gl = smem + 2 * N;
  __shared__ int s_count;
  __shared__ float s_nt;
  const int t = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < N; base += 32) {
      const int n = base + lane;
      const float m = n < N ? mem[n * T_ + t] : 0.f;
      const unsigned bal = __ballot_sync(FULL, m != 0.f);
      if (m != 0.f) {
        const int at = count + __popc(bal & ((1u << lane) - 1u));
        s_idx[at] = n;
        s_mem[at] = m;
        s_gl[at] = gl[n * T_ + t];
      }
      count += __popc(bal);
    }
    __syncwarp();
    if (lane == 0) {
      float n_t = 0.f;                    // exact: 0/1 terms
      for (int i = 0; i < count; ++i) n_t += s_mem[i];
      s_count = count;
      s_nt = fmaxf(n_t, 1.f);
    }
  }
  __syncthreads();
  const int count = s_count;
  const float n_t1 = s_nt;
  const long long n_blk = (d + BLOCK - 1) / BLOCK;
  for (long long g0 = (long long)blockIdx.y * GROUPS; g0 < n_blk;
       g0 += (long long)gridDim.y * GROUPS) {
    // GROUPS coordinate blocks per pass: the loads of UNROLL member rows
    // for every group are issued before any use
    long long jc[GROUPS];
    float votes[GROUPS], acc[GROUPS];
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      jc[c] = (g0 + c) * BLOCK + threadIdx.x;
      votes[c] = 0.f;
      acc[c] = 0.f;
    }
    for (int i0 = 0; i0 < count; i0 += UNROLL) {
      uint32_t w[UNROLL][GROUPS];
      float u[UNROLL][GROUPS];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        const long long n = i0 + q < count ? s_idx[i0 + q] : 0;
#pragma unroll
        for (int c = 0; c < GROUPS; ++c) {
          w[q][c] = 0u;
          u[q][c] = 0.f;
          if (i0 + q < count && jc[c] < d) {
            w[q][c] = words[(n * T_ + t) * n_words + (jc[c] >> 5)];
            u[q][c] = to_f32(unified[n * d + jc[c]]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {  // the sums, in member order
        if (i0 + q < count) {
          const float m = s_mem[i0 + q];
          const float g = s_gl[i0 + q];
#pragma unroll
          for (int c = 0; c < GROUPS; ++c) {
            const bool set = (w[q][c] >> (jc[c] & 31)) & 1u;
            const float sp = (set && u[q][c] > 0.f) ? 1.f : 0.f;
            const float sn = (set && u[q][c] < 0.f) ? 1.f : 0.f;
            votes[c] = __fadd_rn(votes[c], __fmul_rn(m, sp - sn));
            acc[c] = __fadd_rn(acc[c],
                               __fmul_rn(g, __fmul_rn(u[q][c], sp + sn)));
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      if (jc[c] >= d) continue;
      const float a_num = fabsf(votes[c]);
      const float alpha = __fdiv_rn(a_num, n_t1);
      const float m_hat = alpha >= rho ? 1.f : alpha;
      tau_out[(long long)t * d + jc[c]] = __fmul_rn(acc[c], m_hat);
      anum_out[(long long)t * d + jc[c]] = a_num;
    }
  }
}

}  // namespace

// unified (N, d) fp32 (u_bf16 = 0) or bf16 (u_bf16 = 1); words (N, T,
// ceil(d/32)) uint32; gl = gamma * lambda and mem (N, T) fp32.  Outputs
// tau_out and anum_out (T, d) fp32.  Returns cudaGetLastError().
extern "C" int masked_agg_packed_launch(const void* unified, int u_bf16,
                                        const void* words, const void* gl,
                                        const void* mem, int N, int T_,
                                        long long d, float rho, void* tau_out,
                                        void* anum_out, void* stream) {
  // 3 * N words of dynamic shared memory plus the static ones stay under
  // the 48 KB a block gets without opting in
  if (N < 1 || N > 4000 || T_ < 1 || T_ > 65535 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_words = (d + 31) / 32;
  const long long n_blk = (d + BLOCK - 1) / BLOCK;
  // a few resident waves of blocks; each block walks coordinate blocks
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long gy = (32LL * sms + T_ - 1) / T_;
  const long long n_grp = (n_blk + GROUPS - 1) / GROUPS;
  if (gy > n_grp) gy = n_grp;
  if (gy > 65535) gy = 65535;
  const dim3 grid(static_cast<unsigned>(T_), static_cast<unsigned>(gy));
  const size_t smem = 3ull * N * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const uint32_t*>(words);
  auto* g = static_cast<const float*>(gl);
  auto* m = static_cast<const float*>(mem);
  auto* to = static_cast<float*>(tau_out);
  auto* ao = static_cast<float*>(anum_out);
  if (u_bf16)
    masked_agg_packed_kernel<__nv_bfloat16><<<grid, BLOCK, smem, s>>>(
        static_cast<const __nv_bfloat16*>(unified), w, g, m, N, T_, d,
        n_words, rho, to, ao);
  else
    masked_agg_packed_kernel<float><<<grid, BLOCK, smem, s>>>(
        static_cast<const float*>(unified), w, g, m, N, T_, d, n_words, rho,
        to, ao);
  return static_cast<int>(cudaGetLastError());
}
