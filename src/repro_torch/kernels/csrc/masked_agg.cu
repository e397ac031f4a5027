// Whole-round Eq. 3 + Eq. 4, every task in one launch, over packed mask
// words or dense byte masks.
//
// Replaces three TPU kernels of src/repro/kernels/masked_agg.py:
//  * masked_agg_batched_packed_pallas (masks as (N, T, ceil(d/32)) words;
//    outputs tau_hat and the agreement numerator a_num)
//    -> masked_agg_packed_launch (two routes, chosen by N; see below);
//  * masked_agg_batched_pallas (the bool/fp32 A/B layout: masks as
//    (N, T, d) bytes of a torch.bool tensor; outputs tau_hat and m_hat)
//    -> masked_agg_launch (the same two routes);
//  * masked_agg_pallas (one task: masks (N, d) as bool bytes or {0, 1} in
//    fp32/bf16; membership derived here from gamma > 0, N_t = max(#members,
//    1); outputs tau_hat and m_hat) -> masked_agg_single_launch, the
//    member-row route below.
// Per task t and coordinate j, over the member clients n (ascending):
//   votes  = sum_n mem * (m & pos - m & neg),   a_num = |votes|
//   m_hat  = 1 if a_num / N_t >= rho else a_num / N_t
//   tau    = m_hat * sum_n (gamma*lambda)_n * u_nj * (m & pos + m & neg)
// where (pos, neg) is the sign of the unified vector u_n and N_t the member
// count (a member with zero data weight still counts).  Outputs are fp32;
// a_num holds exact integers.
//
// What bounds it on the H100: device-memory bytes (a handful of flops per
// loaded value).  Of the packed kernel's bytes at the full-width round
// (N 32, T 30, d 1,327,140) three quarters are its fp32 (T, d) outputs;
// of the bool layout's, half (its mask bytes are another quarter).
//
// Both layouts' tile route (masked_agg_lists_kernel +
// masked_agg_tile_kernel<T, BYTES>, one C call), taken when N rows of a
// tile fit one
// 48 KB stage — the widest tile of 1024, 512 or 256 coordinates that does
// (tile_width; up to N = 93 in bf16, 47 in fp32; mirrored by
// repro_torch.kernels.masked_agg.packed_tile):
//  * persistent blocks walk d-tiles; a tile's N unified rows are staged
//    in shared memory by 1-D bulk copies (stage.cuh: any d, any row
//    offset), so unified is read from device memory exactly once: packed,
//    in a ring of two stages, the next tile's rows in flight while this
//    one is summed (two blocks a SM); bool, in one stage, three blocks a
//    SM hiding each other's waits (its mask loads gain more from warps
//    than from the ring);
//  * masked_agg_lists_kernel first writes every task's member list once
//    (one warp a task: a ballot over its (N, T) flags, ascending n; the
//    member weight, gamma * lambda rounded once as the plain version
//    rounds it, and N_t) into a workspace the tile kernel reads through
//    L1, so the C call takes lams, gammas and bool members as they are;
//  * for every task the block's threads own 8 consecutive coordinates
//    each (tile / 8 threads a task, 256 / that many tasks at once): they
//    share one mask word (bool layout: 8 mask bytes, turned into the same
//    8 bits by a multiply), and their unified values are shared loads as
//    wide as the staged row's alignment allows, unchecked when every
//    staged row of the tile is whole and no coordinate is past d (one
//    test a tile); a task's first four members' mask words are loaded
//    together;
//  * bool layout: its mask bytes are 8x the words, and loaded where they
//    are used they set the pace (each task waits for its own); so on whole
//    tiles with 4-byte-aligned rows every thread copies its 8 bytes of a
//    task's first 8 members by cp.async into a buffer of its own in
//    shared memory a task ahead, and the next tile's first task while the
//    block waits at the tile's barrier (staging a tile's mask rows for the
//    whole block instead left room for fewer blocks a SM, and was slower);
//  * m_hat of a count of unit votes below 32 is a shuffle from the lane
//    that divided that count by N_t once a task, where each coordinate
//    took a division;
//  * tau_hat and a_num (m_hat) go out as 16-byte streaming stores (__stcs:
//    written once, evicted first); plain float4 stores compiled to 4-byte
//    ones here;
//  * registers are capped for two blocks a SM (16 warps; bool: three).
// Larger N keep the first design below as the second route: one block
// per (task, coordinate range), with gamma * lambda and the member flags
// as fp32 first written by masked_agg_prep_kernel in the same C call.
//
// One task (kernel 8; masked_agg_lists_kernel + masked_agg_single_kernel,
// one C call, every mask kind):
//  * what bounds it: the member rows' bytes (9 of 32 rows at the serve
//    round's task: bf16 unified and bool masks, 97 MB) and the two fp32
//    outputs (29 MB) at d = 3,588,168, 0.0375 ms; kernel 5's tile route
//    would stage all N unified rows of a tile, 3.5x the unified bytes;
//  * the lists kernel writes the member list once (one warp: gamma > 0,
//    ascending n, gamma * lambda rounded once, N_t = max(count, 1)); the
//    wrapper passes the SM count, so the call queries nothing;
//  * persistent blocks walk tiles of 2048 coordinates, each thread 8
//    consecutive ones, reading only member rows: per member one 16-byte
//    load of bf16 unified (two of fp32) and 8 mask values (8 bytes of
//    bool), the loads of a chunk of members issued together and the next
//    chunk's issued before this chunk's sums (4 members a chunk for bf16
//    unified and bool masks, 2 for wider kinds); scalar loads where a
//    tensor's rows are not so aligned;
//  * two blocks a SM: their 128 registers a thread hold both chunks
//    without spilling (three blocks a SM capped them at 80 and spilled,
//    10 % slower; contiguous ranges a block in place of the tile walk
//    were slower still);
//  * the sums run in ascending member order with __fadd_rn / __fmul_rn,
//    as the plain version and the batched kernels do; m_hat comes from a
//    table of v / N_t over the vote counts v <= count (the same division
//    on the same values, once a block); tau_hat and m_hat go out as
//    16-byte __stcs stores, scalar at d's end or unaligned outputs.
//
// The first design (the wide-N route of both layouts):
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
//    plain version in ref._masked_agg, bit for bit.  Both layouts and both
//    routes share it (the members in ascending order), so tau_hat is
//    bitwise equal across them on the same mask bits.
#include "launch.cuh"
#include "stage.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 4;                // member rows loaded together
constexpr int GROUPS = 4;                // coordinate blocks per pass

// PACKED: masks are uint32 words and out2 gets a_num; else masks are
// MaskT values (0/1 bytes in the batched bool layout) and out2 gets m_hat.
template <typename T, typename MaskT, bool PACKED>
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
            if constexpr (PACKED)
              w[q][c] = masks[(n * T_ + t) * n_words + (jc[c] >> 5)];
            else
              w[q][c] = masks[(n * T_ + t) * d + jc[c]] != 0;
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

template <typename MaskT, bool PACKED>
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
    masked_agg_kernel<__nv_bfloat16, MaskT, PACKED>
        <<<grid, BLOCK, smem, s>>>(static_cast<const __nv_bfloat16*>(unified),
                                   mk, g, m, N, T_, d, n_words, rho, to, o2);
  else
    masked_agg_kernel<float, MaskT, PACKED><<<grid, BLOCK, smem, s>>>(
        static_cast<const float*>(unified), mk, g, m, N, T_, d, n_words, rho,
        to, o2);
  return static_cast<int>(cudaGetLastError());
}

// -- both layouts' tile route ----------------------------------------

// Unified stages a block and blocks a SM: the packed layout keeps the
// next tile's rows in flight; the bool layout, whose mask-byte waits set
// its pace, trades that for a third block a SM (one stage, its prefetch).
template <bool BYTES>
__host__ __device__ constexpr int tile_stages() { return BYTES ? 1 : 2; }
template <bool BYTES>
__host__ __device__ constexpr int tile_blocks() { return BYTES ? 3 : 2; }
constexpr int PREFETCH = 8;     // members a task whose mask bytes are
                                // prefetched (bool layout)
constexpr size_t PREFETCH_BYTES = 2ull * PREFETCH * BLOCK * 8;
constexpr long long STAGE_BYTES = 48 * 1024;  // N staged rows of a tile
constexpr int QUADS = 2;                 // a thread's coordinates / 4

// Coordinates a tile takes for N rows of elt-byte unified values: the
// widest of 1024, 512, 256 whose N staged rows (each tile * elt + 16
// bytes) fit one stage; 0 if none does (the wide-N route).
int tile_width(int N, int elt) {
  for (int t = 1024; t >= 256; t /= 2)
    if (static_cast<long long>(N) * (t * elt + 16) <= STAGE_BYTES) return t;
  return 0;
}

// The member lists, one row of 4 + 4 * max(N, 4) words a task: count,
// N_t = max(sum of member weights in ascending order, 1) as fp32, then
// {n, weight, gamma * lambda (rounded once), 0} for each member,
// ascending, and zero entries after them.  One warp a task.  The member
// weights are mem_f, or mem_b as 0/1; with neither (one task, kernel 8)
// a row is a member of weight 1 iff gamma > 0.
__global__ void __launch_bounds__(BLOCK)
masked_agg_lists_kernel(const float* __restrict__ lams,
                        const float* __restrict__ gammas,
                        const uint8_t* __restrict__ mem_b,
                        const float* __restrict__ mem_f, int N, int T_,
                        int* __restrict__ lists) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * (BLOCK / 32) + (threadIdx.x >> 5);
  if (t >= T_) return;                    // uniform over the warp
  const int cap = N < 4 ? 4 : N;
  int* row = lists + t * (4 + 4 * cap);
  int count = 0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    const long long at = static_cast<long long>(n) * T_ + t;
    const float m = n >= N  ? 0.f
                    : mem_f ? mem_f[at]
                    : mem_b ? (mem_b[at] ? 1.f : 0.f)
                            : (gammas[at] > 0.f ? 1.f : 0.f);
    const unsigned bal = __ballot_sync(FULL, m != 0.f);
    if (m != 0.f) {
      int4 e;
      e.x = n;
      e.y = __float_as_int(m);
      e.z = __float_as_int(__fmul_rn(gammas[at], lams[at]));
      e.w = 0;
      *reinterpret_cast<int4*>(
          row + 4 + 4 * (count + __popc(bal & ((1u << lane) - 1u)))) = e;
    }
    count += __popc(bal);
  }
  for (int i = count + lane; i < cap; i += 32)
    *reinterpret_cast<int4*>(row + 4 + 4 * i) = make_int4(0, 0, 0, 0);
  __syncwarp();
  if (lane == 0) {
    float n_t = 0.f;                      // in member order
    for (int i = 0; i < count; ++i) n_t += __int_as_float(row[5 + 4 * i]);
    row[0] = count;
    row[1] = __float_as_int(fmaxf(n_t, 1.f));
  }
}

// 4 consecutive unified values of a staged row at p (the row aligned to
// ``align`` bytes there), as fp32.
__device__ __forceinline__ void load_quad(const float* p, int align,
                                          float (&u)[4]) {
  if (align >= 16) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    u[0] = a.x;
    u[1] = a.y;
    u[2] = a.z;
    u[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] = p[c];
  }
}
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, int align,
                                          float (&u)[4]) {
  uint32_t v[2];                         // bf16 pairs
  if (align >= 8) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const auto* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      v[i] = static_cast<uint32_t>(h[2 * i]) |
             (static_cast<uint32_t>(h[2 * i + 1]) << 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {          // bf16 -> fp32 is exact
    u[2 * i] = __uint_as_float(v[i] << 16);
    u[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A task's count, N_t and first four members, with their mask bits for
// the thread's coordinates, loaded together before its sums.
struct TaskFetch {
  int count;
  float n_t1;
  int4 e[4];                              // {n, weight, gamma*lambda, 0}
  uint32_t w[4];
};

// Bytes 0..3 of x (each 0 or 1, as in a torch.bool tensor) as bits 0..3.
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  return (x * 0x01020408u) >> 24;
}

// The mask bits of the 8 bool bytes at p (coordinates c < m valid): loads
// as wide as p's alignment allows (the row's: the same for the warp),
// streaming (each byte is read once).
__device__ __forceinline__ uint32_t mask_byte_bits(const uint8_t* p, int m) {
  uint32_t v[2] = {0u, 0u};
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (m >= 8 && (a & 7) == 0) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else if (m >= 8 && (a & 3) == 0) {
    v[0] = __ldcs(reinterpret_cast<const unsigned*>(p));
    v[1] = __ldcs(reinterpret_cast<const unsigned*>(p + 4));
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < m) v[c / 4] |= static_cast<uint32_t>(p[c]) << (8 * (c % 4));
  }
  return byte_bits(v[0]) | (byte_bits(v[1]) << 4);
}

// BYTES: masks are the bool layout's (N, T, d) bytes and out2 gets m_hat;
// else (N, T, ceil(d/32)) words and out2 gets a_num.
template <typename T, bool BYTES>
__global__ void __launch_bounds__(BLOCK, tile_blocks<BYTES>())
masked_agg_tile_kernel(const T* __restrict__ unified, Span span,
                       const void* __restrict__ masks,
                       const int* __restrict__ lists, int list_ld,
                       int members_f32, int N, int T_, long long d,
                       long long n_words, int tile, float rho,
                       float* __restrict__ tau_out,
                       float* __restrict__ out2) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  constexpr int TILE_STAGES = tile_stages<BYTES>();
  const int row = tile * static_cast<int>(sizeof(T)) + 16;
  const long long stage = static_cast<long long>(N) * row;
  auto* bar = reinterpret_cast<uint64_t*>(tile_smem + TILE_STAGES * stage);
  // bool layout: each thread's 8 mask bytes of the first PREFETCH members
  // of a task, [buffer][member][thread], for the next task while this one
  // is summed (a thread reads only what it copied)
  auto* pbuf = reinterpret_cast<uint2*>(bar + TILE_STAGES);
  const long long n_tiles = (d + tile - 1) / tile;
  const int per_task = tile / (4 * QUADS);  // threads a task (>= 32)
  const int groups = BLOCK / per_task;      // tasks at once
  const int grp = threadIdx.x / per_task;
  // the thread's 8 coordinates of a tile: [jt, jt + 8), one mask word
  const long long jt = 4LL * QUADS * (threadIdx.x % per_task);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec_out =
      ((reinterpret_cast<uintptr_t>(tau_out) |
        reinterpret_cast<uintptr_t>(out2)) & 15) == 0;

  auto row_addr = [&](long long r, long long j0) -> uintptr_t {
    return reinterpret_cast<uintptr_t>(unified + (r * d + j0));
  };
  auto issue = [&](long long tl, int s) {  // one warp
    const long long j0 = tl * tile;
    const long long n = d - j0 < tile ? d - j0 : tile;
    stage_rows(tile_smem + s * stage, row, N,
               [&](int r) { return row_addr(r, j0); },
               static_cast<unsigned>(n * sizeof(T)), span, &bar[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < TILE_STAGES; ++s) mbar_init(&bar[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < TILE_STAGES; ++s)
      if (blockIdx.x + s * (long long)gridDim.x < n_tiles)
        issue(blockIdx.x + s * (long long)gridDim.x, s);

  // every staged row of tile tl copied whole and no coordinate past d: the
  // sums read shared memory unchecked (only rows 0 and N - 1 can be cut at
  // the tensor's ends)
  auto fast_of = [&](long long tl) {
    const long long j0 = tl * tile;
    return d - j0 >= tile && in_span(row_addr(0, j0), tile * sizeof(T), span) &&
           in_span(row_addr(N - 1, j0), tile * sizeof(T), span);
  };
  // bool layout, fast tiles with 4-byte-aligned rows: the mask bytes of a
  // task's first PREFETCH members come by cp.async a task ahead (across
  // tiles too), into buffer b
  auto pre_of = [&](long long tl) {
    return BYTES && fast_of(tl) &&
           ((d | reinterpret_cast<uintptr_t>(masks)) & 3) == 0;
  };
  auto prefetch = [&](long long tl, int t, int b) {
    const int* lrow = lists + static_cast<long long>(t) * list_ld;
    const int count = lrow[0];
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q)
      if (q < count) {
        const auto* src = static_cast<const uint8_t*>(masks) +
                          (lrow[4 + 4 * q] * static_cast<long long>(T_) + t) *
                              d + tl * tile + jt;
        uint2* dst = pbuf + (b * PREFETCH + q) * BLOCK + threadIdx.x;
        if ((reinterpret_cast<uintptr_t>(src) & 7) == 0) {
          cp_async(dst, src, 8);
        } else {
          cp_async(dst, src, 4);
          cp_async(reinterpret_cast<unsigned char*>(dst) + 4, src + 4, 4);
        }
      }
    cp_async_commit();
  };
  auto prefetched = [&](int b, int q) -> uint32_t {
    const uint2 v = pbuf[(b * PREFETCH + q) * BLOCK + threadIdx.x];
    return byte_bits(v.x) | (byte_bits(v.y) << 4);
  };
  int b = 0;
  if (blockIdx.x < n_tiles && grp < T_ && pre_of(blockIdx.x))
    prefetch(blockIdx.x, grp, 0);

  int it = 0;
  for (long long tl = blockIdx.x; tl < n_tiles; tl += gridDim.x, ++it) {
    const int s = it % TILE_STAGES;
    const long long j0 = tl * tile;
    const long long n = d - j0 < tile ? d - j0 : tile;
    const unsigned char* st = tile_smem + s * stage;

    const bool fast = fast_of(tl);
    // member (row n) of task t: its mask word (0 past d), or the mask
    // bits of the thread's 8 bytes (shift 0)
    const int shift = BYTES ? 0 : static_cast<int>((j0 + jt) & 31);
    auto word = [&](long long nrow, int t) -> uint32_t {
      if (jt >= n) return 0u;
      if constexpr (BYTES)
        return mask_byte_bits(static_cast<const uint8_t*>(masks) +
                                  (nrow * T_ + t) * d + j0 + jt,
                              static_cast<int>(n - jt));
      else
        return static_cast<const uint32_t*>(
            masks)[(nrow * T_ + t) * n_words + (j0 + jt) / 32];
    };
    const bool pre = pre_of(tl);
    auto fetch = [&](int t, int b) {
      TaskFetch f;
      const int* lrow = lists + static_cast<long long>(t) * list_ld;
      const int2 h = *reinterpret_cast<const int2*>(lrow);
      f.count = h.x;
      f.n_t1 = __int_as_float(h.y);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f.e[q] = reinterpret_cast<const int4*>(lrow + 4)[q];
#pragma unroll
      for (int q = 0; q < 4; ++q)         // zero entries read row 0
        f.w[q] = pre ? prefetched(b, q) : word(f.e[q].x, t);
      return f;
    };

    // one task's sums and outputs from its fetched members
    auto task = [&](int t, const TaskFetch& cur, int b) {
      float votes[QUADS][4], acc[QUADS][4];
#pragma unroll
      for (int i = 0; i < QUADS; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) votes[i][c] = acc[i][c] = 0.f;
      // one member's sums over the thread's coordinates, in member order
      auto add = [&](int4 e, uint32_t w) {
        const uintptr_t a = row_addr(e.x, j0);
        const unsigned char* p =
            staged(st + e.x * row, a, a) + jt * sizeof(T);
        float u[QUADS][4];
        if (fast) {
          // the row's alignment in the stage, the same for every thread
          const int low =
              static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
#pragma unroll
          for (int i = 0; i < QUADS; ++i)
            load_quad(reinterpret_cast<const T*>(p) + 4 * i,
                      low ? (low & -low) : 16, u[i]);
        } else {
#pragma unroll
          for (int c = 0; c < 4 * QUADS; ++c) {
            const uintptr_t y = a + (jt + c) * sizeof(T);
            u[c / 4][c % 4] =
                jt + c < n
                    ? to_f32(*reinterpret_cast<const T*>(
                          in_span(y, sizeof(T), span)
                              ? p + c * sizeof(T)
                              : reinterpret_cast<const unsigned char*>(y)))
                    : 0.f;
          }
        }
        const float m = __int_as_float(e.y), g = __int_as_float(e.z);
        const uint32_t bits = w >> shift;
#pragma unroll
        for (int i = 0; i < QUADS; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {   // the sums, in member order
            const bool set = (bits >> (4 * i + c)) & 1u;
            const float sp = (set && u[i][c] > 0.f) ? 1.f : 0.f;
            const float sn = (set && u[i][c] < 0.f) ? 1.f : 0.f;
            votes[i][c] = __fadd_rn(votes[i][c], __fmul_rn(m, sp - sn));
            acc[i][c] = __fadd_rn(acc[i][c],
                                  __fmul_rn(g, __fmul_rn(u[i][c], sp + sn)));
          }
      };
      const int count = cur.count;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < count) add(cur.e[q], cur.w[q]);
      const int* lrow = lists + static_cast<long long>(t) * list_ld + 4;
      for (int k = 4; k < count; ++k) {   // members past the fetched four
        const int4 e = reinterpret_cast<const int4*>(lrow)[k];
        add(e, pre && k < PREFETCH ? prefetched(b, k) : word(e.x, t));
      }
      // m_hat: lane a holds its value at a_num = a when a_num is a count
      // of unit votes below 32 (bool members), else divide per value
      const bool table = !members_f32 && count < 32;
      float mh_tab = 0.f;
      if (table) {
        const float alpha = __fdiv_rn(static_cast<float>(lane), cur.n_t1);
        mh_tab = alpha >= rho ? 1.f : alpha;
      }
      // av: a_num (words) or m_hat (bytes), the second output
      float tv[QUADS][4], av[QUADS][4];
#pragma unroll
      for (int i = 0; i < QUADS; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float a_num = fabsf(votes[i][c]);
          float m_hat;
          if (table) {
            m_hat = __shfl_sync(FULL, mh_tab, static_cast<int>(a_num));
          } else {
            const float alpha = __fdiv_rn(a_num, cur.n_t1);
            m_hat = alpha >= rho ? 1.f : alpha;
          }
          tv[i][c] = __fmul_rn(acc[i][c], m_hat);
          av[i][c] = BYTES ? m_hat : a_num;
        }
      const long long o = static_cast<long long>(t) * d + j0 + jt;
      if (vec_out && jt + 4 * QUADS <= n && (o & 3) == 0) {
#pragma unroll
        for (int i = 0; i < QUADS; ++i) {
          __stcs(reinterpret_cast<float4*>(tau_out + o + 4 * i),
                 make_float4(tv[i][0], tv[i][1], tv[i][2], tv[i][3]));
          __stcs(reinterpret_cast<float4*>(out2 + o + 4 * i),
                 make_float4(av[i][0], av[i][1], av[i][2], av[i][3]));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4 * QUADS; ++c)
          if (jt + c < n) {
            tau_out[o + c] = tv[c / 4][c % 4];
            out2[o + c] = av[c / 4][c % 4];
          }
      }
    };

    mbar_wait(&bar[s], (it / TILE_STAGES) & 1);
    for (int t = grp; t < T_; t += groups, b ^= 1) {
      if (pre) {
        if (t + groups < T_)
          prefetch(tl, t + groups, b ^ 1);
        else
          cp_async_commit();
        cp_async_wait1();                 // this task's bytes have landed
      }
      task(t, fetch(t, b), b);
    }
    // the next tile's first task, while this block waits at the barrier
    if (tl + gridDim.x < n_tiles && grp < T_ && pre_of(tl + gridDim.x))
      prefetch(tl + gridDim.x, grp, b);
    __syncthreads();                      // stage s is read
    if (warp == 0 && tl + TILE_STAGES * (long long)gridDim.x < n_tiles)
      issue(tl + TILE_STAGES * (long long)gridDim.x, s);
  }
}

// The wide-N route's inputs: gamma * lambda (rounded once) and the
// member weights as fp32 (N, T), the form masked_agg_kernel reads.
__global__ void __launch_bounds__(BLOCK)
masked_agg_prep_kernel(const float* __restrict__ lams,
                       const float* __restrict__ gammas,
                       const uint8_t* __restrict__ mem_b,
                       const float* __restrict__ mem_f, long long count,
                       float* __restrict__ gl, float* __restrict__ mem) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= count) return;
  gl[i] = __fmul_rn(gammas[i], lams[i]);
  mem[i] = mem_f ? mem_f[i] : (mem_b[i] ? 1.f : 0.f);
}

// Workspace words of the tile route's member lists: T rows of
// 4 + 4 * max(N, 4).
long long list_words(int N, int T_) {
  return static_cast<long long>(T_) * (4 + 4 * (N < 4 ? 4 : N));
}

template <typename T, bool BYTES>
int launch_tile(const T* u, const void* masks, const float* lams,
                const float* gammas, const uint8_t* mem_b,
                const float* mem_f, int N, int T_, long long d, int tile,
                float rho, int* lists, float* tau, float* out2,
                cudaStream_t s) {
  masked_agg_lists_kernel<<<static_cast<unsigned>((T_ + 7) / 8), BLOCK, 0,
                            s>>>(lams, gammas, mem_b, mem_f, N, T_, lists);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kern = masked_agg_tile_kernel<T, BYTES>;
  static bool opted_in = false;           // the largest stage ring
  if (!opted_in) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_stages<BYTES>() * (STAGE_BYTES + 8) +
                         (BYTES ? PREFETCH_BYTES : 0)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const size_t smem =
      tile_stages<BYTES>() *
          (static_cast<size_t>(N) * (tile * sizeof(T) + 16) + 8) +
      (BYTES ? PREFETCH_BYTES : 0);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BLOCK,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long n_tiles = (d + tile - 1) / tile;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned grid =
      static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
  const Span span = tensor_span(u, static_cast<unsigned long long>(N) * d *
                                       sizeof(T));
  const int ld = 4 + 4 * (N < 4 ? 4 : N);
  kern<<<grid, BLOCK, smem, s>>>(u, span, masks, lists, ld, mem_f != nullptr,
                                 N, T_, d, (d + 31) / 32, tile, rho, tau,
                                 out2);
  return static_cast<int>(cudaGetLastError());
}

// Both whole-round layouts: the tile route (tile > 0) or the first design
// (the wide-N route), with the workspace and plan checks they share.
template <bool BYTES>
int round_launch(const void* unified, int u_bf16, const void* masks,
                 const void* lams, const void* gammas, const void* members,
                 int mem_f32, int N, int T_, long long d, float rho, int tile,
                 void* ws, long long ws_words, void* tau_out, void* out2,
                 void* stream) {
  if (N < 1 || N > 4000 || T_ < 1 || T_ > 65535 || d < 1 ||
      tile != tile_width(N, u_bf16 ? 2 : 4) || ws == nullptr ||
      ws_words != (tile ? list_words(N, T_) : 2LL * N * T_))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* lam = static_cast<const float*>(lams);
  auto* gam = static_cast<const float*>(gammas);
  auto* mem_b = mem_f32 ? nullptr : static_cast<const uint8_t*>(members);
  auto* mem_f = mem_f32 ? static_cast<const float*>(members) : nullptr;
  auto* to = static_cast<float*>(tau_out);
  auto* o2 = static_cast<float*>(out2);
  if (tile) {
    auto* lists = static_cast<int*>(ws);
    if (u_bf16)
      return launch_tile<__nv_bfloat16, BYTES>(
          static_cast<const __nv_bfloat16*>(unified), masks, lam, gam, mem_b,
          mem_f, N, T_, d, tile, rho, lists, to, o2, s);
    return launch_tile<float, BYTES>(static_cast<const float*>(unified),
                                     masks, lam, gam, mem_b, mem_f, N, T_, d,
                                     tile, rho, lists, to, o2, s);
  }
  const long long count = static_cast<long long>(N) * T_;
  auto* gl = static_cast<float*>(ws);
  masked_agg_prep_kernel<<<static_cast<unsigned>((count + BLOCK - 1) / BLOCK),
                           BLOCK, 0, s>>>(lam, gam, mem_b, mem_f, count, gl,
                                          gl + count);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (BYTES)
    return launch<uint8_t, false>(unified, u_bf16, masks, gl, gl + count, N,
                                  T_, d, rho, tau_out, out2, stream);
  else
    return launch<uint32_t, true>(unified, u_bf16, masks, gl, gl + count, N,
                                  T_, d, rho, tau_out, out2, stream);
}

// -- one task's member-row route (kernel 8) ---------------------------

constexpr int SINGLE_BLOCKS = 2;          // blocks a SM
constexpr int SINGLE_TILE = 8 * BLOCK;    // coordinates a tile: 8 a thread
constexpr int MH_TABLE = 1024;            // m_hat table: vote counts 0..1023

// The raw bytes of 8 consecutive V values (the words they fill), loaded
// together so that a chunk's loads are all in flight before the first is
// used: 16-byte (or 8-byte, for bytes) streaming loads where ``vec``
// (every row's 8 values aligned to that), else one value a load, zero past
// the m valid ones.
template <typename V>
struct Raw8 {
  uint32_t w[2 * sizeof(V)];
};
__device__ __forceinline__ uint32_t raw_of(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t raw_of(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t raw_of(float v) {
  return __float_as_uint(v);
}
template <typename V>
__device__ __forceinline__ void load8(const V* p, bool vec, int m,
                                      Raw8<V>& r) {
  if (vec && m >= 8) {
    if constexpr (sizeof(V) == 1) {
      const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
      r.w[0] = a.x;
      r.w[1] = a.y;
    } else {
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(V)) / 2; ++i) {
        const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p) + i);
        r.w[4 * i] = a.x;
        r.w[4 * i + 1] = a.y;
        r.w[4 * i + 2] = a.z;
        r.w[4 * i + 3] = a.w;
      }
    }
  } else {
    constexpr int per = 4 / static_cast<int>(sizeof(V));  // values a word
#pragma unroll
    for (int i = 0; i < 2 * static_cast<int>(sizeof(V)); ++i) r.w[i] = 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < m) r.w[c / per] |= raw_of(p[c]) << (8 * sizeof(V) * (c % per));
  }
}
// Value c of 8 raw unified values as fp32 (bf16 -> fp32 is exact).
__device__ __forceinline__ float raw_f32(const Raw8<float>& r, int c) {
  return __uint_as_float(r.w[c]);
}
__device__ __forceinline__ float raw_f32(const Raw8<__nv_bfloat16>& r,
                                         int c) {
  const uint32_t w = r.w[c / 2];
  return __uint_as_float(c % 2 ? w & 0xffff0000u : w << 16);
}
// The 8 mask values as bits: bool bytes (0 or 1) as kernel 5 turns them,
// fp32 / bf16 {0, 1} by value != 0.
__device__ __forceinline__ uint32_t raw_bits(const Raw8<uint8_t>& r) {
  return byte_bits(r.w[0]) | (byte_bits(r.w[1]) << 4);
}
template <typename V>
__device__ __forceinline__ uint32_t raw_bits(const Raw8<V>& r) {
  uint32_t bits = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) bits |= (raw_f32(r, c) != 0.f ? 1u : 0u) << c;
  return bits;
}

// Whether every row's 8 values at a thread's coordinates (8 t) can be
// loaded as Raw8 vectors: p and each row's start aligned to them.
template <typename V>
bool rows_vec(const V* p, long long d) {
  constexpr long long a = 8 * sizeof(V) < 16 ? 8 * sizeof(V) : 16;
  return reinterpret_cast<uintptr_t>(p) % a == 0 &&
         (d * static_cast<long long>(sizeof(V))) % a == 0;
}

// One task: unified (N, d), masks (N, d) of MaskT, and its member list
// (masked_agg_lists_kernel's row: count, N_t, {n, 1, gamma * lambda, 0}
// a member, ascending).  Persistent blocks walk tiles of SINGLE_TILE
// coordinates; a thread owns 8 consecutive ones and reads only the member
// rows, a chunk of CH members' 8 unified values and 8 mask values loaded
// together, the next chunk's loads issued before this chunk's sums.
template <typename T, typename MaskT>
__global__ void __launch_bounds__(BLOCK, SINGLE_BLOCKS)
masked_agg_single_kernel(const T* __restrict__ unified,
                         const MaskT* __restrict__ masks,
                         const int* __restrict__ list, long long d, float rho,
                         int vec_u, int vec_m, int vec_o,
                         float* __restrict__ tau_out,
                         float* __restrict__ mhat_out) {
  constexpr int CH = sizeof(T) + sizeof(MaskT) <= 3 ? 4 : 2;
  struct Member {
    Raw8<T> u;
    Raw8<MaskT> m;
    float gl;                             // gamma * lambda
  };
  __shared__ float mh_tab[MH_TABLE];
  const int count = list[0];
  const float n_t1 = __int_as_float(list[1]);
  const int4* entries = reinterpret_cast<const int4*>(list + 4);
  // m_hat of each vote count a_num = v <= count (the member weights are
  // 1, so a_num is one): the same division on the same values
  const bool table = count < MH_TABLE;
  for (int v = threadIdx.x; v <= count && v < MH_TABLE; v += BLOCK) {
    const float alpha = __fdiv_rn(static_cast<float>(v), n_t1);
    mh_tab[v] = alpha >= rho ? 1.f : alpha;
  }
  __syncthreads();

  const long long n_tiles = (d + SINGLE_TILE - 1) / SINGLE_TILE;
  for (long long tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const long long j = tl * SINGLE_TILE + 8LL * threadIdx.x;
    if (j >= d) continue;
    const int m = d - j < 8 ? static_cast<int>(d - j) : 8;  // coordinates
    auto fetch = [&](int k, Member& f) {
      const int4 e = __ldg(entries + k);
      f.gl = __int_as_float(e.z);
      const long long at = e.x * d + j;
      load8(unified + at, vec_u, m, f.u);
      load8(masks + at, vec_m, m, f.m);
    };
    float votes[8], acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) votes[c] = acc[c] = 0.f;
    // one member's sums, in member order (its weight 1: the vote is
    // sp - sn, exactly weight * (sp - sn))
    auto add = [&](const Member& f) {
      const uint32_t bits = raw_bits(f.m);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float u = raw_f32(f.u, c);
        const bool set = (bits >> c) & 1u;
        const float sp = (set && u > 0.f) ? 1.f : 0.f;
        const float sn = (set && u < 0.f) ? 1.f : 0.f;
        votes[c] = __fadd_rn(votes[c], sp - sn);
        acc[c] = __fadd_rn(acc[c], __fmul_rn(f.gl, __fmul_rn(u, sp + sn)));
      }
    };
    Member a[CH], b[CH];
    auto fetch_chunk = [&](int k0, Member (&f)[CH]) {
#pragma unroll
      for (int q = 0; q < CH; ++q)
        if (k0 + q < count) fetch(k0 + q, f[q]);
    };
    auto add_chunk = [&](int k0, const Member (&f)[CH]) {
#pragma unroll
      for (int q = 0; q < CH; ++q)
        if (k0 + q < count) add(f[q]);
    };
    fetch_chunk(0, a);
    for (int k0 = 0; k0 < count; k0 += 2 * CH) {
      fetch_chunk(k0 + CH, b);
      add_chunk(k0, a);
      fetch_chunk(k0 + 2 * CH, a);
      add_chunk(k0 + CH, b);
    }

    float tv[8], mv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float a_num = fabsf(votes[c]);
      float m_hat;
      if (table) {
        m_hat = mh_tab[static_cast<int>(a_num)];
      } else {
        const float alpha = __fdiv_rn(a_num, n_t1);
        m_hat = alpha >= rho ? 1.f : alpha;
      }
      tv[c] = __fmul_rn(acc[c], m_hat);
      mv[c] = m_hat;
    }
    if (vec_o && m == 8) {                // j is a multiple of 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        __stcs(reinterpret_cast<float4*>(tau_out + j) + i,
               make_float4(tv[4 * i], tv[4 * i + 1], tv[4 * i + 2],
                           tv[4 * i + 3]));
        __stcs(reinterpret_cast<float4*>(mhat_out + j) + i,
               make_float4(mv[4 * i], mv[4 * i + 1], mv[4 * i + 2],
                           mv[4 * i + 3]));
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < m) {
          tau_out[j + c] = tv[c];
          mhat_out[j + c] = mv[c];
        }
    }
  }
}

template <typename T, typename MaskT>
int launch_single(const T* u, const void* masks, const float* lam,
                  const float* gam, int N, long long d, float rho, int sms,
                  int* list, float* tau, float* mhat, cudaStream_t s) {
  masked_agg_lists_kernel<<<1, BLOCK, 0, s>>>(lam, gam, nullptr, nullptr, N,
                                              1, list);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* mk = static_cast<const MaskT*>(masks);
  const long long n_tiles = (d + SINGLE_TILE - 1) / SINGLE_TILE;
  const long long resident = static_cast<long long>(SINGLE_BLOCKS) * sms;
  const unsigned grid =
      static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
  const int vec_o = ((reinterpret_cast<uintptr_t>(tau) |
                      reinterpret_cast<uintptr_t>(mhat)) & 15) == 0;
  masked_agg_single_kernel<T, MaskT><<<grid, BLOCK, 0, s>>>(
      u, mk, list, d, rho, rows_vec(u, d), rows_vec(mk, d), vec_o, tau, mhat);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int single_by_mask(const T* u, const void* masks, int mask_kind,
                   const float* lam, const float* gam, int N, long long d,
                   float rho, int sms, int* list, float* tau, float* mhat,
                   cudaStream_t s) {
  if (mask_kind == 0)
    return launch_single<T, uint8_t>(u, masks, lam, gam, N, d, rho, sms,
                                     list, tau, mhat, s);
  if (mask_kind == 1)
    return launch_single<T, float>(u, masks, lam, gam, N, d, rho, sms, list,
                                   tau, mhat, s);
  return launch_single<T, __nv_bfloat16>(u, masks, lam, gam, N, d, rho, sms,
                                         list, tau, mhat, s);
}

}  // namespace

// unified (N, d) fp32 (u_bf16 = 0) or bf16 (u_bf16 = 1); words (N, T,
// ceil(d/32)) uint32; lams and gammas (N, T) fp32; members (N, T) fp32
// (mem_f32 = 1) or uint8 0/1 (a torch.bool tensor).  tile must be
// tile_width(N, sizeof element), 0 taking the wide-N route; ws is a
// workspace of ws_words 4-byte words, T * (4 + 4 * max(N, 4)) on the
// tile route (the member lists), 2 * N * T on the wide-N route.  Outputs
// tau_out and anum_out (T, d) fp32.  Returns cudaGetLastError().
extern "C" int masked_agg_packed_launch(const void* unified, int u_bf16,
                                        const void* words, const void* lams,
                                        const void* gammas,
                                        const void* members, int mem_f32,
                                        int N, int T_, long long d, float rho,
                                        int tile, void* ws, long long ws_words,
                                        void* tau_out, void* anum_out,
                                        void* stream) {
  return round_launch<false>(unified, u_bf16, words, lams, gammas, members,
                             mem_f32, N, T_, d, rho, tile, ws, ws_words,
                             tau_out, anum_out, stream);
}

// The bool/fp32 layout: masks (N, T, d) uint8 holding 0 or 1 (a torch.bool
// tensor), the rest as masked_agg_packed_launch takes it; outputs tau_out
// and mhat_out (T, d) fp32.
extern "C" int masked_agg_launch(const void* unified, int u_bf16,
                                 const void* masks, const void* lams,
                                 const void* gammas, const void* members,
                                 int mem_f32, int N, int T_, long long d,
                                 float rho, int tile, void* ws,
                                 long long ws_words, void* tau_out,
                                 void* mhat_out, void* stream) {
  return round_launch<true>(unified, u_bf16, masks, lams, gammas, members,
                            mem_f32, N, T_, d, rho, tile, ws, ws_words,
                            tau_out, mhat_out, stream);
}

// One task: unified (N, d); masks (N, d) of mask_kind 0 = uint8 0/1 (a
// torch.bool tensor), 1 = fp32 {0, 1}, 2 = bf16 {0, 1}; lam and gamma (N,)
// fp32.  Members are the rows with gamma > 0; outputs tau_out and mhat_out
// (d,) fp32.  sms: the card's SM count; ws: a workspace of ws_words =
// 4 + 4 * max(N, 4) words (the member list), needing no fill.
extern "C" int masked_agg_single_launch(const void* unified, int u_bf16,
                                        const void* masks, int mask_kind,
                                        const void* lam, const void* gamma,
                                        int N, long long d, float rho,
                                        int sms, void* ws, long long ws_words,
                                        void* tau_out, void* mhat_out,
                                        void* stream) {
  if (N < 1 || N > 4000 || d < 1 || sms < 1 || mask_kind < 0 ||
      mask_kind > 2 || ws == nullptr || ws_words != list_words(N, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* lm = static_cast<const float*>(lam);
  auto* gm = static_cast<const float*>(gamma);
  auto* list = static_cast<int*>(ws);
  auto* tau = static_cast<float*>(tau_out);
  auto* mhat = static_cast<float*>(mhat_out);
  if (u_bf16)
    return single_by_mask(static_cast<const __nv_bfloat16*>(unified), masks,
                          mask_kind, lm, gm, N, d, rho, sms, list, tau, mhat,
                          s);
  return single_by_mask(static_cast<const float*>(unified), masks, mask_kind,
                        lm, gm, N, d, rho, sms, list, tau, mhat, s);
}
