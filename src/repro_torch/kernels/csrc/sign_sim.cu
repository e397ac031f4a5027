// Eq. 5: raw sign dots from packed sign bit-planes, S from dense fp32.
//
// Replaces two TPU kernels of src/repro/kernels/sign_sim.py:
//  * sign_sim_packed_pallas (popcount algebra over (pos, nz) words)
//    -> sign_sim_packed_launch.  For tasks t, t' over the packed words:
//      dots[t, t'] = sum_w popc(both) - 2 * popc(both & (pos_t ^ pos_t'))
//      with both = nz_t & nz_t';
//  * sign_sim_pallas (sgn(tau) . sgn(tau)^T over dense (T, d) fp32, the
//    bool/fp32 A/B layout's Eq. 5) -> sign_sim_launch.
// Both sum the exact integer sgn(tau_t) . sgn(tau_t'); the packed call
// returns it (the caller normalises by d), the dense call S = (dots / d +
// 1) / 2.
//
// The packed kernel, T <= 64 (the tensor-core route; one C call launches
// sign_sim_packed_mma_kernel and sign_sim_packed_sum_kernel):
//  * what bounds it on the H100: the planes are 2 * T * w words, read
//    once (3 us at the full-width round, T 30, w 41,474).  The popcount
//    identity takes two __popc a pair and word, 38.6 M there: at 16 a
//    cycle a SM that alone is ~10 us.  The int8 tensor cores take the
//    pair products instead.  Bit j of a word is coordinate 32k + j, and
//    its sign as the identity defines it is +1 (nz and pos), -1 (nz, not
//    pos) or 0 (no nz, whatever pos holds); the dots are the Gram matrix
//    of those signs, exact in int32.  What bounds this design is integer
//    instruction issue and each block's serial start and end, not bytes:
//    turning plane bits into int8 operands costs ~6 integer instructions
//    a row and word, and variants with the loads or the products left
//    out each still take most of the kernel's time;
//  * a group of 4 plane words of every task row is 4 k-steps of
//    mma.sync.m16n8k32.s8: thread tig of a quad takes word tig of the
//    group, and the mma of offset o = 0..3 its bits 8j + o and 8j + o + 4
//    (j = 0..3) as int8 +-1/0 in registers: the word shifted by 0 or 2, a
//    bit (o mod 2) of each byte masked, and one multiply-add make 4 of
//    them, the odd offsets as +-2 into accumulators of their own (4 times
//    the dots, divided out exactly).  The k order is free, as A and B
//    share the registers: registers 0 and 2 of the A fragment of rows
//    r..r+7 hold what the B fragment of those rows holds, so the Gram
//    product needs no second operand, and only the upper-triangle 16 x 8
//    tiles are multiplied (2, 6, 20 for T <= 16, 32, 64);
//  * each block (two a SM) owns one contiguous range of words, staged for
//    all T rows in chunks of 64 words by 16-byte cp.async into a ring of
//    three stages (rows start only 4-byte aligned: a row's 16-byte-aligned
//    window is copied, its few words cut off at the tensors' ends by
//    4-byte copies; 1-D bulk copies of these 272-byte rows were slower);
//    rows padded to 68 words (4 banks apart), so the 8 rows a fragment
//    load touches fall in at most 2-way bank conflicts;
//  * the 8 warps take groups in turn and keep int32 accumulators; the
//    block adds the warps' fragments in shared memory (int32: exact in any
//    order) and writes one partial a pair to a workspace; the sum kernel
//    (one warp a pair) adds the blocks' partials in int32 and writes the
//    fp32 dots, mirrored.  No atomics on device memory, no zero fill, no
//    conversion pass after the call.
// T > 64 keeps the first design as a second route (sign_sim_packed_kernel,
// below, after sign_sim_packed_zero_kernel clears its int32 sums; the sum
// kernel converts them), in the same C call.
//
// The dense kernel, T <= 64 (sign_sim_dense_mma_kernel + the same sum
// kernel, one C call): kernel 3's tensor-core route without its hard part.
//  * what bounds it on the H100: the T * d fp32 values, read once (159 MB,
//    0.0475 ms at the full-width bool round); the pair products, T(T+1)/2
//    a coordinate, are int8 tensor-core work two orders below that;
//  * a thread's A-fragment register holds 4 consecutive k values of one
//    row (k columns 4 tig + 16 h), so it is one 16-byte load of 4 fp32
//    values, turned into 4 int8 signs (v > 0) - (v < 0) a byte; registers
//    0 and 2 of rows r..r+7 are also their B fragment, so the Gram product
//    needs no second operand, and only the upper-triangle 16 x 8 tiles are
//    multiplied (6 at T = 30);
//  * each block (two a SM; one for T > 32, whose accumulators take the
//    registers) owns one contiguous range of a multiple of 32 coordinates;
//    its warps take k-steps in turn and load the fragments straight from
//    device memory (16-byte streaming loads where every row is 16-byte
//    aligned: x aligned and d a multiple of 4, as at the round's d; else
//    4-byte loads), two k-steps' loads in flight before the first product;
//  * the warps' fragments are summed in shared memory into one int32
//    partial a pair a block (store_partials, shared with kernel 3), and the
//    sum kernel writes S = 1/2 (dots / d + 1) itself, in the rounding torch
//    gives ref.sim_from_dots on the card: no zero fill, no atomics, no
//    torch launch after the call.
// T > 64 keeps the first design (sign_sim_kernel) as a second route, its
// fill and S in the same C call; route 0 forces it at any T.
//
// The first design (the packed route for T > 64, and the dense one):
// what bounds it on the H100 is device-memory bytes — the packed planes
// are 2 * T * w words, the dense input T * d fp32 values, each read once,
// and T(T+1)/2 pairs cost a few integer ops per word.  Design against that:
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


// -- the tensor-core route (T <= 64) ------------------------------------

constexpr int MMA_THREADS = 256;         // 8 warps
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int CHUNK = 64;                // words a chunk
constexpr int STAGES = 3;                // chunks in flight
constexpr int ROW_W = CHUNK + 4;         // words a stage row (4 mod 32)
constexpr int SEGS = CHUNK / 4 + 1;      // 16-byte segments a row window

// Shared-memory bytes of the mma kernel for MT 16-row task tiles: STAGES
// chunks of both planes (the warps' accumulator fragments reuse it).
constexpr size_t mma_smem(int MT) {
  return static_cast<size_t>(STAGES) * 2 * 16 * MT * ROW_W * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, uintptr_t src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The int8 signs of the coordinates at bits q, 8 + q, 16 + q, 24 + q of
// the plane words p (pos) and z (nz), scaled by 2^q: +2^q, -2^q or 0 a
// byte (q = 0: 0x01, 0xff; q = 1: 0x02, 0xfe).  The positive and negative
// bits are disjoint, so the add is an or.
__device__ __forceinline__ uint32_t signs4(uint32_t p, uint32_t z, int q) {
  const uint32_t m = 0x01010101u << q;
  const uint32_t pb = p & z & m, nb = ~p & z & m;
  return pb + nb * ((0x100u >> q) - 1u);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Index of the pair (a, b), a <= b < T, in row-major upper-triangle order.
__device__ __forceinline__ int pair_index(int a, int b, int T_) {
  return a * T_ - a * (a - 1) / 2 + (b - a);
}

// int32 entries of one warp's accumulator fragments over the MT * (MT + 1)
// upper-triangle 16 x 8 tiles of 16 * MT task rows.
__host__ __device__ constexpr int frag_entries(int MT) {
  return MT * (MT + 1) * 4 * 32;
}

// Both tensor-core routes' block epilogue: red holds the MMA_WARPS warps'
// fragments side by side (warp v's entry (tile i, register q, lane l) at
// red[v * frag_entries(MT) + (i * 4 + q) * 32 + l]); each entry is summed
// over the warps (int32: exact in any order) and written as the block's
// partial of its pair, ws[blockIdx.x * T(T+1)/2 + pair_index(row, col)],
// where row <= col < T (a contiguous row a block, so that blocks share no
// sector but at their rows' ends).
template <int MT>
__device__ __forceinline__ void store_partials(const int* red, int T_,
                                               int* __restrict__ ws) {
  constexpr int NT = 2 * MT;
  constexpr int FRAG = frag_entries(MT);
  for (int i = threadIdx.x; i < FRAG; i += MMA_THREADS) {
    int sum = 0;
#pragma unroll
    for (int v = 0; v < MMA_WARPS; ++v) sum += red[v * FRAG + i];
    const int l = i & 31, q = (i >> 5) & 3;
    int tile = i >> 7, mt = 0;             // tile -> (mt, nt >= 2 mt)
    while (tile >= NT - 2 * mt) {
      tile -= NT - 2 * mt;
      ++mt;
    }
    const int nt = 2 * mt + tile;
    const int row = 16 * mt + (l >> 2) + 8 * (q >> 1);
    const int col = 8 * nt + 2 * (l & 3) + (q & 1);
    if (row <= col && col < T_)
      ws[static_cast<long long>(blockIdx.x) * (T_ * (T_ + 1) / 2) +
         pair_index(row, col, T_)] = sum;
  }
}

// pos, nz (T, w) words, T <= 16 * MT.  Block blk owns the words
// [blk * W, min((blk + 1) * W, w)), W a multiple of 4; it writes its sum
// of every pair (a <= b) to ws[blk * T(T+1)/2 + pair_index(a, b)] (a
// contiguous row of its own, so that blocks share no sector but at their
// rows' ends).
template <int MT>
__global__ void __launch_bounds__(MMA_THREADS, MT == 4 ? 1 : 2)
sign_sim_packed_mma_kernel(const uint32_t* __restrict__ pos,
                           const uint32_t* __restrict__ nz, int T_,
                           long long w, long long W, int* __restrict__ ws) {
  constexpr int R = 16 * MT;               // task rows, zero past T
  constexpr int NT = 2 * MT;               // 8-column tiles
  constexpr int TILES = MT * (MT + 1);     // upper-triangle 16 x 8 tiles
  constexpr int PLANE = R * ROW_W;         // words of one plane a stage
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long w0 = blockIdx.x * W;
  const long long w1 = w0 + W < w ? w0 + W : w;
  const int n_chunks = static_cast<int>((w1 - w0 + CHUNK - 1) / CHUNK);
  // the planes' addresses and their bytes (both tensors the same size)
  const uintptr_t base[2] = {reinterpret_cast<uintptr_t>(pos),
                             reinterpret_cast<uintptr_t>(nz)};
  const unsigned long long bytes = 4ull * T_ * w;

  // rows past T stay zero in every stage
  for (int sp = 0; sp < 2 * STAGES; ++sp)
    for (int i = tid; i < (R - T_) * ROW_W; i += MMA_THREADS)
      sm[sp * PLANE + T_ * ROW_W + i] = 0u;
  // the 16-byte-aligned start of each plane row's window at the block's
  // first word, and the row's offset in it (pos rows, then nz rows)
  __shared__ uintptr_t row_a0[2 * 16 * MT];
  __shared__ int row_mis[2 * 16 * MT];
  for (int i = tid; i < 2 * T_; i += MMA_THREADS) {
    const int pl = i >= T_, r = i - pl * T_;
    const uintptr_t a = base[pl] + 4ull * (r * w + w0);
    row_a0[i] = a & ~uintptr_t(15);
    row_mis[i] = static_cast<int>(a & 15);
  }
  __syncthreads();

  // chunk c of the block's range into stage s: the 16-byte segments of
  // each row's window that hold its words (the chunks start 256 bytes
  // apart), 4-byte copies where a segment leaves the tensor
  auto issue = [&](int c, int s) {
    const long long c0 = w0 + static_cast<long long>(c) * CHUNK;
    const int n_bytes =
        4 * static_cast<int>(w1 - c0 < CHUNK ? w1 - c0 : CHUNK);
    unsigned char* stage = reinterpret_cast<unsigned char*>(sm + s * 2 * PLANE);
    for (int i = tid; i < 2 * T_ * SEGS; i += MMA_THREADS) {
      const int pr = i / SEGS, sg = i - pr * SEGS;
      if (16 * sg >= row_mis[pr] + n_bytes) continue;
      const int pl = pr >= T_;
      const uintptr_t y = row_a0[pr] + 4ull * CHUNK * c + 16 * sg;
      unsigned char* dst =
          stage + 4 * ((pr + pl * (R - T_)) * ROW_W) + 16 * sg;
      const uintptr_t lo = base[pl], hi = base[pl] + bytes;
      if (y >= lo && y + 16 <= hi) {
        cp_async16(dst, y);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (y + 4 * q >= lo && y + 4 * q + 4 <= hi)
            cp_async4(dst + 4 * q, y + 4 * q);
      }
    }
  };

  // this thread's rows g + 8h of each task tile: their word offsets in a
  // stage plane (the row's misalignment is the same in every chunk: the
  // chunks start 16-byte steps apart)
  int off[2][2 * MT];
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      const int r = 8 * j + g;
      off[pl][j] = r * ROW_W + (r < T_ ? row_mis[pl * T_ + r] >> 2 : 0);
    }

  int acc[2][TILES][4];                   // bits o even, odd (4x)
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[0][i][q] = acc[1][i][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) issue(s, s);
    cp_async_commit();
  }
  // one group of 4 plane words of every task row: 4 k-steps.  The k
  // order is free (A and B share the registers): thread tig takes word
  // tig of the group, and an mma the bits 8 j + o of that word (register
  // h of rows g + 8h) and 8 j + o + 4 (register h + 2), j = 0..3, o = 0..3
  // in turn.  Shifting the word by 0 or 2 and masking bit 0 or 1 of each
  // byte gives o, so a bit o = q (mod 2) enters as +-2^q: the q = 1 mmas
  // sum into their own accumulators, 4 times the dots
  auto group = [&](const uint32_t* sp, const uint32_t* sn, int k, int n) {
    uint32_t pw[2 * MT], zw[2 * MT];      // this thread's word of each row
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      pw[j] = k + tig < n ? sp[off[0][j] + k] : 0u;
      zw[j] = k + tig < n ? sn[off[1][j] + k] : 0u;
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int sh = o & 2, q = o & 1;
      uint32_t fa[MT][4];
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j) {
        fa[j / 2][j % 2] = signs4(pw[j] >> sh, zw[j] >> sh, q);
        fa[j / 2][j % 2 + 2] = signs4(pw[j] >> (sh + 4), zw[j] >> (sh + 4), q);
      }
      // the B fragment of columns 8 nt .. 8 nt + 7 is registers 0 and 2
      // (nt even) or 1 and 3 (nt odd) of task tile nt / 2
      int tile = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 2 * mt; nt < NT; ++nt, ++tile)
          mma_s8(acc[q][tile], fa[mt], fa[nt / 2][nt % 2],
                 fa[nt / 2][nt % 2 + 2]);
    }
  };
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                      // chunk c landed; c - 1 consumed
    if (c + STAGES - 1 < n_chunks)
      issue(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint32_t* sp = sm + (c % STAGES) * 2 * PLANE + tig;
    const uint32_t* sn = sp + PLANE;
    const long long c0 = w0 + static_cast<long long>(c) * CHUNK;
    const int n = static_cast<int>(w1 - c0 < CHUNK ? w1 - c0 : CHUNK);
    if (n == CHUNK) {                     // unrolled: immediate offsets
#pragma unroll
      for (int i = 0; i < CHUNK / (4 * MMA_WARPS); ++i)
        group(sp, sn, 4 * (warp + MMA_WARPS * i), CHUNK);
    } else {
      for (int k = 4 * warp; k < n; k += 4 * MMA_WARPS) group(sp, sn, k, n);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // every stage read

  // the warps' fragments side by side in shared memory (each fragment
  // entry once: the odd offsets' 4x sums divided out exactly)
  int* red = reinterpret_cast<int*>(sm);
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      red[warp * frag_entries(MT) + (i * 4 + q) * 32 + lane] =
          acc[0][i][q] + (acc[1][i][q] >> 2);   // exact: a multiple of 4
  __syncthreads();
  store_partials<MT>(red, T_, ws);
}

// -- the dense tensor-core route (T <= 64) --------------------------------

// The int8 signs of 4 fp32 values, byte c from the c-th: +1, -1 or 0
// ((v > 0) - (v < 0), as the first design takes them).
__device__ __forceinline__ uint32_t sign_bytes(float4 v) {
  auto sg = [](float x) {
    return static_cast<uint32_t>((x > 0.f) - (x < 0.f)) & 0xffu;
  };
  return sg(v.x) | (sg(v.y) << 8) | (sg(v.z) << 16) | (sg(v.w) << 24);
}

// Shared-memory bytes of the dense mma kernel: the warps' fragments.
constexpr size_t dense_smem(int MT) {
  return static_cast<size_t>(MMA_WARPS) * frag_entries(MT) * 4;
}

// x (T, d) fp32, T <= 16 * MT.  Block blk owns the coordinates
// [blk * W, min((blk + 1) * W, d)), W a multiple of 32 (one k-step of
// mma.sync.m16n8k32.s8), and writes its sum of every pair (a <= b) as
// store_partials does.  VEC: x 16-byte aligned and d a multiple of 4, so
// every row's k-step starts 16-byte aligned (else 4-byte loads).
template <int MT, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, MT == 4 ? 1 : 2)
sign_sim_dense_mma_kernel(const float* __restrict__ x, int T_, long long d,
                          long long W, int* __restrict__ ws) {
  constexpr int NT = 2 * MT;               // 8-column tiles
  constexpr int TILES = MT * (MT + 1);     // upper-triangle 16 x 8 tiles
  constexpr int U = MT == 4 ? 1 : 2;       // k-steps a warp loads at once
  extern __shared__ __align__(16) int red[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long j0 = blockIdx.x * W;
  const long long j1 = j0 + W < d ? j0 + W : d;
  const long long steps = (j1 - j0 + 31) / 32;
  // this thread's rows g + 8 j (j < 2 MT) at column j0 + 4 tig; null
  // past T (their operands stay zero)
  const float* row[2 * MT];
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j) {
    const int r = 8 * j + g;
    row[j] = r < T_ ? x + static_cast<long long>(r) * d + j0 + 4 * tig
                    : nullptr;
  }
  int acc[TILES][4];
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0;

  // k-step s of the block: register h of task tile mt's A fragment holds
  // row 16 mt + g + 8 (h & 1) at k columns 4 tig + 16 (h >> 1) .. + 3 --
  // 4 consecutive fp32 values, one 16-byte load (v[row group][h >> 1])
  auto load = [&](long long s, float4 (&v)[2 * MT][2]) {
    const long long k = 32 * s;
    const bool whole = j0 + k + 32 <= j1;
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row[j] != nullptr) {
          const float* p = row[j] + k + 16 * h;
          if (VEC && whole) {
            f = __ldcs(reinterpret_cast<const float4*>(p));
          } else {
            const long long c = j0 + k + 16 * h + 4 * tig;
            f.x = c < j1 ? p[0] : 0.f;
            f.y = c + 1 < j1 ? p[1] : 0.f;
            f.z = c + 2 < j1 ? p[2] : 0.f;
            f.w = c + 3 < j1 ? p[3] : 0.f;
          }
        }
        v[j][h] = f;
      }
  };
  // the signs as int8 A fragments, and the Gram product of the
  // upper-triangle tiles: the B fragment of columns 8 nt .. 8 nt + 7 is
  // registers 0 and 2 (nt even) or 1 and 3 (nt odd) of task tile nt / 2
  auto product = [&](const float4 (&v)[2 * MT][2]) {
    uint32_t fa[MT][4];
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) fa[j / 2][j % 2 + 2 * h] = sign_bytes(v[j][h]);
    int tile = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 2 * mt; nt < NT; ++nt, ++tile)
        mma_s8(acc[tile], fa[mt], fa[nt / 2][nt % 2], fa[nt / 2][nt % 2 + 2]);
  };
  // the warps take k-steps in turn, U at a time: their loads are all in
  // flight before the first product
  for (long long s = warp; s < steps; s += MMA_WARPS * U) {
    float4 v[U][2 * MT][2];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s + u * MMA_WARPS < steps) load(s + u * MMA_WARPS, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s + u * MMA_WARPS < steps) product(v[u]);
  }

#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      red[warp * frag_entries(MT) + (i * 4 + q) * 32 + lane] = acc[i][q];
  __syncthreads();
  store_partials<MT>(red, T_, ws);
}

// Clears the first design's int32 sums (the route for T > 64).
__global__ void __launch_bounds__(BLOCK)
sign_sim_packed_zero_kernel(int* __restrict__ sums, int count) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < count) sums[i] = 0;
}

// One warp a pair (a <= b): the sum of its n_blk partials, ws[i * P + p]
// for i < n_blk (the tensor-core routes: p = pair_index(a, b) in rows of
// P = T(T+1)/2; the first designs' (T, T) sums: p = a * T + b, n_blk = 1),
// in int32 (exact in any order), written as fp32 to out[a, b] and
// out[b, a]: the dots (sim = 0), or S = 0.5 * (dots * inv_d + 1) (sim =
// 1) with one rounding a product and an add, as torch computes
// ref.sim_from_dots on the card (its division by the scalar d is a
// product with the fp32 reciprocal inv_d = 1 / d, rounded once).
__global__ void __launch_bounds__(BLOCK)
sign_sim_packed_sum_kernel(const int* __restrict__ ws, int T_, int n_blk,
                           int square, int sim, float inv_d,
                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (BLOCK / 32) + (threadIdx.x >> 5);
  if (p >= T_ * T_) return;               // uniform over the warp
  const int a = p / T_, b = p % T_;
  if (a > b) return;
  const int* src = ws + (square ? p : pair_index(a, b, T_));
  const long long stride = T_ * (T_ + 1) / 2;
  int s = 0;
#pragma unroll 4
  for (int i = lane; i < n_blk; i += 32) s += src[i * stride];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    float v = static_cast<float>(s);
    if (sim) v = 0.5f * __fadd_rn(__fmul_rn(v, inv_d), 1.f);   // exact halving
    out[a * T_ + b] = v;
    out[b * T_ + a] = v;
  }
}

// The sum kernel over n_blk partial rows (or the (T, T) sums, square).
cudaError_t launch_sum(const int* ws, int T_, int n_blk, int square, int sim,
                       float inv_d, float* out, cudaStream_t s) {
  sign_sim_packed_sum_kernel<<<(T_ * T_ + BLOCK / 32 - 1) / (BLOCK / 32),
                               BLOCK, 0, s>>>(ws, T_, n_blk, square, sim,
                                              inv_d, out);
  return cudaGetLastError();
}

// Clears a first design's int32 (T, T) sums.
cudaError_t launch_zero(int* sums, int count, cudaStream_t s) {
  sign_sim_packed_zero_kernel<<<(count + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(
      sums, count);
  return cudaGetLastError();
}

// Opts kern in to ``bytes`` of dynamic shared memory once, then launches
// it on ``blocks`` blocks.
template <typename Kern, typename... Args>
cudaError_t launch_opted(Kern kern, bool& opted_in, size_t bytes, int blocks,
                         cudaStream_t s, Args... args) {
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kern<<<static_cast<unsigned>(blocks), MMA_THREADS, bytes, s>>>(args...);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mma(const uint32_t* pos, const uint32_t* nz, int T_,
                       long long w, int blocks, long long W, int* ws,
                       cudaStream_t s) {
  static bool opted_in = false;
  return launch_opted(sign_sim_packed_mma_kernel<MT>, opted_in, mma_smem(MT),
                      blocks, s, pos, nz, T_, w, W, ws);
}

template <int MT, bool VEC>
cudaError_t launch_dense_mma(const float* x, int T_, long long d, int blocks,
                             long long W, int* ws, cudaStream_t s) {
  static bool opted_in = false;
  return launch_opted(sign_sim_dense_mma_kernel<MT, VEC>, opted_in,
                      dense_smem(MT), blocks, s, x, T_, d, W, ws);
}

template <bool VEC>
cudaError_t launch_dense_mma(const float* x, int T_, long long d, int blocks,
                             long long W, int* ws, cudaStream_t s) {
  return T_ <= 16   ? launch_dense_mma<1, VEC>(x, T_, d, blocks, W, ws, s)
         : T_ <= 32 ? launch_dense_mma<2, VEC>(x, T_, d, blocks, W, ws, s)
                    : launch_dense_mma<4, VEC>(x, T_, d, blocks, W, ws, s);
}

// Whether ``blocks`` blocks of W each cover [0, n) once.
bool covers(int blocks, long long W, long long n) {
  return W >= 1 && blocks >= 1 && static_cast<long long>(blocks) * W >= n &&
         static_cast<long long>(blocks - 1) * W < n;
}

}  // namespace

// pos, nz (T, w) uint32 planes; dots (T, T) fp32 out.  route 1, the
// tensor cores (T <= 64): ``blocks`` blocks of W words each (W a multiple
// of 4, blocks * W >= w > (blocks - 1) * W), ws of blocks * T(T+1)/2
// int32 partials.  route 0, the first design (any T): W words a block,
// 2 * T * (W + 1) * 4 bytes of shared memory within 48 KB, blocks =
// ceil(w / W), ws of T * T int32 sums.  ws needs no fill.  Returns
// cudaGetLastError().
extern "C" int sign_sim_packed_launch(const void* pos, const void* nz, int T_,
                                      long long w, int route, int blocks,
                                      long long W, void* ws,
                                      long long ws_words, void* dots,
                                      void* stream) {
  if (T_ < 1 || w < 1 || !covers(blocks, W, w) || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const uint32_t*>(pos);
  auto* z = static_cast<const uint32_t*>(nz);
  int* sums = static_cast<int*>(ws);
  const int pairs = T_ * (T_ + 1) / 2;
  cudaError_t e;
  if (route == 1) {
    if (T_ > 64 || W % 4 != 0 ||
        ws_words != static_cast<long long>(blocks) * pairs)
      return static_cast<int>(cudaErrorInvalidValue);
    e = T_ <= 16   ? launch_mma<1>(p, z, T_, w, blocks, W, sums, s)
        : T_ <= 32 ? launch_mma<2>(p, z, T_, w, blocks, W, sums, s)
                   : launch_mma<4>(p, z, T_, w, blocks, W, sums, s);
  } else if (route == 0) {
    const size_t smem = 2ull * T_ * (W + 1) * sizeof(uint32_t);
    if (smem > 48 * 1024 || ws_words != static_cast<long long>(T_) * T_)
      return static_cast<int>(cudaErrorInvalidValue);
    e = launch_zero(sums, T_ * T_, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    sign_sim_packed_kernel<<<static_cast<unsigned>(blocks), BLOCK, smem, s>>>(
        p, z, T_, w, static_cast<int>(W), sums);
    e = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_sum(sums, T_, route == 1 ? blocks : 1,
                                     route == 0, 0, 0.f,
                                     static_cast<float*>(dots), s));
}

// x (T, d) fp32; sim (T, T) fp32 out, S = 0.5 * (dots * inv_d + 1) with
// inv_d the fp32 reciprocal of d.  route 1, the tensor cores (T <= 64):
// ``blocks`` blocks of W coordinates each (W a multiple of 32, blocks * W
// >= d > (blocks - 1) * W), ws of blocks * T(T+1)/2 int32 partials.
// route 0, the first design (any T): W = 4 * WW coordinates a block, T *
// (WW + 1) * 4 bytes of shared memory within 48 KB, blocks = ceil(d / W),
// ws of T * T int32 sums.  ws needs no fill.  Returns cudaGetLastError().
extern "C" int sign_sim_launch(const void* x, int T_, long long d, int route,
                               int blocks, long long W, float inv_d, void* ws,
                               long long ws_words, void* sim, void* stream) {
  if (T_ < 1 || d < 1 || !covers(blocks, W, d) || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xf = static_cast<const float*>(x);
  int* sums = static_cast<int*>(ws);
  const int pairs = T_ * (T_ + 1) / 2;
  cudaError_t e;
  if (route == 1) {
    if (T_ > 64 || W % 32 != 0 ||
        ws_words != static_cast<long long>(blocks) * pairs)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && d % 4 == 0;
    e = vec ? launch_dense_mma<true>(xf, T_, d, blocks, W, sums, s)
            : launch_dense_mma<false>(xf, T_, d, blocks, W, sums, s);
  } else if (route == 0) {
    const long long WW = W / 4;
    const size_t smem = 1ull * T_ * (WW + 1) * sizeof(int);
    if (W % 4 != 0 || smem > 48 * 1024 ||
        ws_words != static_cast<long long>(T_) * T_)
      return static_cast<int>(cudaErrorInvalidValue);
    e = launch_zero(sums, T_ * T_, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    sign_sim_kernel<<<static_cast<unsigned>(blocks), BLOCK, smem, s>>>(
        xf, T_, d, static_cast<int>(WW), sums);
    e = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_sum(sums, T_, route == 1 ? blocks : 1,
                                     route == 0, 1, inv_d,
                                     static_cast<float*>(sim), s));
}
