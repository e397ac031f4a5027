// Whole-round Eq. 3 + Eq. 4, every task in one launch, over packed mask
// words or dense byte masks.
//
// Replaces three TPU kernels of src/repro/kernels/masked_agg.py:
//  * masked_agg_batched_packed_pallas (masks as (N, T, ceil(d/32)) words;
//    outputs tau_hat and the agreement numerator a_num)
//    -> masked_agg_packed_launch;
//  * masked_agg_batched_pallas (the bool/fp32 A/B layout: masks as
//    (N, T, d) bytes of a torch.bool tensor; outputs tau_hat and m_hat)
//    -> masked_agg_launch;
//  * masked_agg_pallas (one task: masks (N, d) as bool bytes or {0, 1} in
//    fp32/bf16; membership derived here from gamma > 0, N_t = max(#members,
//    1); outputs tau_hat and m_hat) -> masked_agg_single_launch, the bool
//    kernel at T = 1 with the member list built from gamma on the device.
// Per task t and coordinate j, over the member clients n (ascending):
//   votes  = sum_n mem * (m & pos - m & neg),   a_num = |votes|
//   m_hat  = 1 if a_num / N_t >= rho else a_num / N_t
//   tau    = m_hat * sum_n (gamma*lambda)_n * u_nj * (m & pos + m & neg)
// where (pos, neg) is the sign of the unified vector u_n and N_t the member
// count (a member with zero data weight still counts).  Outputs are fp32;
// a_num holds exact integers.
//
// What bounds it on the H100: device-memory bytes (a handful of flops per
// loaded value).  Design against that:
//  * rows with members[n, t] == 0 are skipped — their masks are zero and
//    their gamma is zero, so they add nothing.  The TPU kernels' BlockSpecs
//    stream all N unified rows for every task; at N = 32, T = 30 and
//    d = 1.3M that is ~2.5 GB a round (and for the dense layout 5.1 GB of
//    fp32-cast masks) against ~0.3 GB for the member rows.
//    Each block builds task t's member list once (a warp ballot, ascending
//    n, in shared memory) and walks only those rows;
//  * one thread per coordinate: a warp's unified loads are one coalesced
//    access; packed, all 32 lanes share one mask word (a broadcast load);
//    dense, a warp reads 32 consecutive mask bytes (one sector).  The mask
//    bytes are read as they are: no fp32 copy of the masks is ever made.
//    Each thread issues the loads of 4 member rows for 4 coordinates before
//    any use, so 16 of them are in flight together;
//  * pos/neg come from the sign of the unified value in-register, so no
//    separate sign-plane pass over u is needed;
//  * a few resident waves of blocks walk the coordinate blocks, task the
//    fastest grid axis: the T blocks of one d-range run side by side, so a
//    unified tile is re-read from L2, not from device memory;
//  * sums use __fadd_rn/__fmul_rn: no FMA contraction, the rounding of the
//    plain version in ref._masked_agg, bit for bit.  Both layouts share it,
//    so tau_hat is bitwise equal across them on the same mask bits.
#include "launch.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 4;                // member rows loaded together
constexpr int GROUPS = 4;                // coordinate blocks per pass

__device__ __forceinline__ bool mask_set(uint8_t v) { return v != 0; }
__device__ __forceinline__ bool mask_set(float v) { return v != 0.f; }
__device__ __forceinline__ bool mask_set(__nv_bfloat16 v) {
  return __bfloat162float(v) != 0.f;
}

// PACKED: masks are uint32 words and out2 gets a_num; else masks are
// MaskT values (0/1 bytes in the batched bool layout) and out2 gets m_hat.
// SINGLE (T = 1): ``mem`` holds gamma and ``gl`` lambda; a row is a member
// iff gamma > 0 and its weight is gamma * lambda, rounded once.
template <typename T, typename MaskT, bool PACKED, bool SINGLE>
__global__ void __launch_bounds__(BLOCK)
masked_agg_kernel(const T* __restrict__ unified,
                  const MaskT* __restrict__ masks,
                  const float* __restrict__ gl, const float* __restrict__ mem,
                  int N, int T_, long long d, long long n_words, float rho,
                  float* __restrict__ tau_out, float* __restrict__ out2) {
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
      const float raw = n < N ? mem[n * T_ + t] : 0.f;
      const float m = SINGLE ? (raw > 0.f ? 1.f : 0.f) : raw;
      const unsigned bal = __ballot_sync(FULL, m != 0.f);
      if (m != 0.f) {
        const int at = count + __popc(bal & ((1u << lane) - 1u));
        s_idx[at] = n;
        s_mem[at] = m;
        s_gl[at] = SINGLE ? __fmul_rn(raw, gl[n]) : gl[n * T_ + t];
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
            if constexpr (PACKED)
              w[q][c] = masks[(n * T_ + t) * n_words + (jc[c] >> 5)];
            else
              w[q][c] = mask_set(masks[(n * T_ + t) * d + jc[c]]);
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
            bool set;
            if constexpr (PACKED)
              set = (w[q][c] >> (jc[c] & 31)) & 1u;
            else
              set = w[q][c] != 0u;
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
      out2[(long long)t * d + jc[c]] = PACKED ? a_num : m_hat;
    }
  }
}

template <typename MaskT, bool PACKED, bool SINGLE>
int launch(const void* unified, int u_bf16, const void* masks, const void* gl,
           const void* mem, int N, int T_, long long d, float rho,
           void* tau_out, void* out2, void* stream) {
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
  auto* g = static_cast<const float*>(gl);
  auto* m = static_cast<const float*>(mem);
  auto* to = static_cast<float*>(tau_out);
  auto* o2 = static_cast<float*>(out2);
  auto* mk = static_cast<const MaskT*>(masks);
  if (u_bf16)
    masked_agg_kernel<__nv_bfloat16, MaskT, PACKED, SINGLE>
        <<<grid, BLOCK, smem, s>>>(static_cast<const __nv_bfloat16*>(unified),
                                   mk, g, m, N, T_, d, n_words, rho, to, o2);
  else
    masked_agg_kernel<float, MaskT, PACKED, SINGLE><<<grid, BLOCK, smem, s>>>(
        static_cast<const float*>(unified), mk, g, m, N, T_, d, n_words, rho,
        to, o2);
  return static_cast<int>(cudaGetLastError());
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
  return launch<uint32_t, true, false>(unified, u_bf16, words, gl, mem, N, T_,
                                      d, rho, tau_out, anum_out, stream);
}

// The bool/fp32 layout: masks (N, T, d) uint8 holding 0 or 1 (a torch.bool
// tensor); outputs tau_out and mhat_out (T, d) fp32.
extern "C" int masked_agg_launch(const void* unified, int u_bf16,
                                 const void* masks, const void* gl,
                                 const void* mem, int N, int T_, long long d,
                                 float rho, void* tau_out, void* mhat_out,
                                 void* stream) {
  return launch<uint8_t, false, false>(unified, u_bf16, masks, gl, mem, N, T_,
                                      d, rho, tau_out, mhat_out, stream);
}

// One task: unified (N, d); masks (N, d) of mask_kind 0 = uint8 0/1 (a
// torch.bool tensor), 1 = fp32 {0, 1}, 2 = bf16 {0, 1}; lam and gamma (N,)
// fp32.  Members are the rows with gamma > 0; outputs tau_out and mhat_out
// (d,) fp32.
extern "C" int masked_agg_single_launch(const void* unified, int u_bf16,
                                        const void* masks, int mask_kind,
                                        const void* lam, const void* gamma,
                                        int N, long long d, float rho,
                                        void* tau_out, void* mhat_out,
                                        void* stream) {
  if (mask_kind == 0)
    return launch<uint8_t, false, true>(unified, u_bf16, masks, lam, gamma, N,
                                        1, d, rho, tau_out, mhat_out, stream);
  if (mask_kind == 1)
    return launch<float, false, true>(unified, u_bf16, masks, lam, gamma, N, 1,
                                      d, rho, tau_out, mhat_out, stream);
  if (mask_kind == 2)
    return launch<__nv_bfloat16, false, true>(unified, u_bf16, masks, lam,
                                              gamma, N, 1, d, rho, tau_out,
                                              mhat_out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
