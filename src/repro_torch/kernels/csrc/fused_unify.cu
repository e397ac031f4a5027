// Fused unify + task masks + lambda partials (paper Eq. 2 and the §3.2
// modulators), batched over clients, in either output layout; and Eq. 2
// alone for one client.
//
// Replaces three TPU kernels of src/repro/kernels/:
//  * fused_unify.py::fused_unify_packed_pallas (the packed wire layout:
//    bf16 unified, LSB-first mask words) -> fused_unify_packed_launch;
//  * fused_unify.py::fused_unify_pallas (the bool/fp32 A/B layout: fp32
//    unified, one byte per mask bit) -> fused_unify_launch;
//  * unify.py::unify_pallas (Eq. 2 alone, (K, d) -> (d,)) -> unify_launch.
// Per client b, over its valid slots k:
//   sigma = sgn(sum_k x_k), mu = max |x_k| over slots aligned with sigma,
//   tau = sigma * mu (bf16 in the packed layout, rounded after every
//   decision below; fp32 in the bool layout),
//   mask (b, k, j) = valid_k && x_kj * tau_j > 0,
//   lambda num = sum_j |x_kj|, den = sum_j mask * |tau_j|,
// with num/den summed on the lambda grid of repro_torch.kernels.ref: per
// 256-coordinate block a shuffle tree over each warp's 32 lanes, then a
// halving tree over the block's 8 warps; the blocks by the binary tree of
// ref._tree_total.  Both layouts give the same bits, so masks and lambda
// are bitwise equal across them.
//
// What bounds it on the H100: device-memory bytes.  Per (client,
// coordinate) it reads K slot values once and writes one unified value
// and K mask bits — a few operations per byte, far under the card's
// ridge.  So the work per byte must stay small enough for the SM to keep
// up with its share of HBM (about 14 bytes a cycle).
//
// The packed layout (fused_unify_packed_kernel + fused_unify_tree_kernel,
// one C call):
//  * a producer warp stages tiles of (client, TB lambda blocks): each
//    valid slot row by one 1-D bulk copy (stage.cuh: the aligned window
//    of the row, so any d and any row offset work) into a ring of 4
//    stages with full / empty mbarriers; invalid slots issue no copy and
//    read as zero.  A tile row is 4 KB (TB = 4 at K <= 4): the bulk
//    copies keep up with the HBM rate only when they are that large;
//  * two groups of TB consumer warps take the block's tiles in turn, one
//    lambda block a warp, 8 slices of 32 coordinates; no block barrier:
//    a warp frees its stage with one mbarrier arrival;
//  * in a slice, lane i owns coordinate i as in the lambda grid; mask
//    words are one __ballot_sync a slot (lane j <-> bit j), lane k
//    keeping slot k's 8 words for 8 stores;
//  * lambda: each slice's 2K quantities (num and den of each slot,
//    padded to a power of two) go through one xor reduce-scatter
//    butterfly, about 2K shuffles a warp where 2K separate 5-step
//    __shfl_down_sync trees took 10K.  At every step lane i adds the same
//    two values the down tree pairs at its lane i mod offset, and IEEE
//    addition commutes, so each slice sum is bitwise the tree's.  Lane L
//    ends with quantity L / (32 / 2K) of all 8 slices and sums them by
//    the grid's halving tree over warps in registers: one partial a
//    lambda block, written to a workspace;
//  * fused_unify_tree_kernel sums each (num/den, client, slot) row of
//    partials by the (2i, 2i + 1) pairing over its zero-padded
//    power-of-two length: every lambda partial is >= +0, so zero padding
//    past ref's length changes no bit;
//  * unified goes out through a per-warp shared buffer as 16-byte stores,
//    the unaligned ends of a block's row one value a lane;
//  * registers are capped for two blocks a SM (18 warps).
// On the H100 the staged copies alone keep up with the bytes; the
// kernel's time is set by its instruction issue (PERF.md §6, row 1).
// The bool layout (fused_unify_kernel) keeps its first design: one warp a
// 32-coordinate slice per client, each thread loading its K values for 4
// lambda blocks before using any, mask bytes stored by each lane, the
// lambda partials through per-slot shuffle trees into a buffer that the
// wrapper sums by ref._tree_total.
// unify_launch (kernel 7, Eq. 2 for one client).  Bound: the (K, d) stack
// read once and d fp32 values written (26.5 MB at K = 4, d = 1,327,140
// fp32: 7.9 us at 3.35 TB/s), with no reuse, so the design keeps enough
// loads in flight and spends no grid on tails:
//  * "vec" route (K <= 16): a thread loads V values of each slot row at
//    once, V * sizeof(T) <= 8 bytes (2 fp32 or 4 bf16), V the widest
//    width every row start x + k*d allows (unify_vec, mirrored by
//    fused_unify.unify_plan: gcd(8 / sizeof(T), the element offset of x,
//    d); so V divides d and there is no tail).  The K loads are all
//    issued before the election, which is the register elect<KM> of the
//    first design, in the same order; out goes as V-wide stores.  One
//    block a tile of 256 vectors.  Measured no better, so not kept:
//    __ldcs loads (faster only when L2 is full of dirty lines, slower
//    warm), 16-byte loads, a grid sized to the card (one resident wave
//    walking the tiles), more blocks a SM, blocks of 128 or 512, two
//    vectors a thread in flight, streaming stores (PERF.md §6, design
//    steps of kernel 7);
//  * "wide" route (K > 16): the first design, one thread a coordinate, the
//    slot sum and the aligned max in two passes over the rows, the second
//    from cache.
#include "launch.cuh"
#include "stage.cuh"

namespace {

constexpr int KMAX = 16;                 // slots a lane keeps in registers
constexpr int GROUPS = 4;                // lambda blocks a block loads at once
constexpr int BLOCK = 256;               // == ref.LAMBDA_BLOCK
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sgn(float s) {
  return s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
}

// Eq. 2 on one coordinate's slot values (zero for invalid slots): the
// slot sum runs k = 0, 1, ..., then the max |x| over aligned slots.
template <int KM>
__device__ __forceinline__ float elect(const float (&xv)[KM], int K) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) s += xv[k];
  const float sigma = sgn(s);
  float mu = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K && xv[k] * sigma > 0.f) mu = fmaxf(mu, fabsf(xv[k]));
  return sigma * mu;
}

// The bool/fp32 layout: uni fp32 + one byte per mask bit.
template <typename T, int KM>
__global__ void __launch_bounds__(BLOCK)
fused_unify_kernel(const T* __restrict__ x,
                   const uint8_t* __restrict__ valid, int K, long long d,
                   long long n_blk, long long part_ld,
                   float* __restrict__ uni_out, uint8_t* __restrict__ mask_out,
                   float* __restrict__ num_part,
                   float* __restrict__ den_part) {
  __shared__ float red[2][KM][WARPS];
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* xb = x + b * K * d;
  unsigned vbits = 0;                     // bit k: slot k is valid
  for (int k = 0; k < K; ++k) vbits |= (valid[b * K + k] ? 1u : 0u) << k;

  for (long long g0 = (long long)blockIdx.x * GROUPS; g0 < n_blk;
       g0 += (long long)gridDim.x * GROUPS) {
    // the slot values of GROUPS lambda blocks: every load is issued before
    // any use, so they are in flight together; invalid slots are not read
    float xv[GROUPS][KM];
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      const long long j = (g0 + c) * BLOCK + threadIdx.x;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        float v = 0.f;
        if (k < K && j < d && ((vbits >> k) & 1u))
          v = to_f32(xb[(long long)k * d + j]);
        xv[c][k] = v;
      }
    }
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      const long long blk = g0 + c;
      if (blk >= n_blk) break;            // uniform over the block
      const long long j = blk * BLOCK + threadIdx.x;
      const float tau = elect<KM>(xv[c], K);
      if (j < d) uni_out[b * d + j] = tau;

      const float atau = fabsf(tau);
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {                      // uniform over the block
          // zero for invalid slots and tail lanes (their x is 0)
          const bool m = xv[c][k] * tau > 0.f;
          if (j < d) mask_out[(b * K + k) * d + j] = m;
          float pn = fabsf(xv[c][k]);
          float pd = m ? atau : 0.f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            pn += __shfl_down_sync(FULL, pn, off);
            pd += __shfl_down_sync(FULL, pd, off);
          }
          if (lane == 0) {
            red[0][k][warp] = pn;
            red[1][k][warp] = pd;
          }
        }
      }
      __syncthreads();
      if (threadIdx.x < 2 * K) {
        const int which = threadIdx.x / K;
        const int k = threadIdx.x % K;
        const float* r = red[which][k];
        // halving tree over the warps: (w, w + 4), (w, w + 2), then (0, 1)
        const float c0 = (r[0] + r[4]) + (r[2] + r[6]);
        const float c1 = (r[1] + r[5]) + (r[3] + r[7]);
        float* dst = which ? den_part : num_part;
        dst[(b * K + k) * part_ld + blk] = c0 + c1;
      }
      __syncthreads();                    // red is rewritten next block
    }
  }
}

// -- the packed layout -------------------------------------------------

constexpr int STAGES = 4;                // tiles staged a block

// A tile: TB lambda blocks of one client, each taken by one consumer
// warp; two groups of TB consumer warps take the block's tiles in turn,
// and one producer warp stages them.  K padded to KM slots keeps a fp32
// stage at <= 16 KB.
template <int KM>
struct PackedTile {
  static constexpr int TB = KM <= 4 ? 4 : 16 / KM;
  static constexpr int TILE = TB * BLOCK;
  static constexpr int CONSUMERS = 2 * TB;
  static constexpr int THREADS = 32 * (CONSUMERS + 1);
};

// Eq. 2 over all KM slots, the padding ones zero: the same tau as
// elect<KM>(xv, K) (a zero slot changes the sum at most from -0 to +0,
// whose sign is the same 0, and is never aligned).
template <int KM>
__device__ __forceinline__ float elect_padded(const float (&xv)[KM]) {
  float s = xv[0];
#pragma unroll
  for (int k = 1; k < KM; ++k) s += xv[k];
  const float sigma = sgn(s);
  float mu = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (xv[k] * sigma > 0.f) mu = fmaxf(mu, fabsf(xv[k]));
  return sigma * mu;
}

// Sum each of Q values (Q a power of two <= 32) over the warp's 32 lanes:
// a reduce-scatter butterfly on offsets 16, 8, ..., then all-reduce steps
// once one value is left.  Afterwards v[0] of lane L holds quantity
// L / (32 / Q), bitwise the __shfl_down_sync tree's total (see the note).
template <int Q>
__device__ __forceinline__ void warp_sums(float (&v)[Q], int lane) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int off = 16 >> i;
    const int half = (Q >> i) / 2;
    if (half >= 1) {
      const bool up = lane & off;
#pragma unroll
      for (int p = 0; p < half; ++p) {
        const float send = up ? v[p] : v[p + half];
        const float keep = up ? v[p + half] : v[p];
        v[p] = keep + __shfl_xor_sync(FULL, send, off);
      }
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], off);
    }
  }
}

template <int KM, typename T>
constexpr size_t packed_smem() {
  using P = PackedTile<KM>;
  return STAGES * KM * (P::TILE * sizeof(T) + 16)    // staged slot rows
         + P::CONSUMERS * (BLOCK + 8) * 2            // unified, bf16
         + 2 * STAGES * 8;                           // mbarriers
}

// (client, tile) of a sequence of items, advanced by a fixed stride
// without a 64-bit division per item.
struct Cursor {
  long long b, tile;
  __device__ Cursor(long long item, long long n_tiles)
      : b(item / n_tiles), tile(item % n_tiles) {}
  __device__ void advance(long long q, long long r, long long n_tiles) {
    b += q;
    tile += r;
    if (tile >= n_tiles) {
      tile -= n_tiles;
      ++b;
    }
  }
};

template <typename T, int KM>
__global__ void __launch_bounds__(PackedTile<KM>::THREADS, 2)
fused_unify_packed_kernel(const T* __restrict__ x, Span span,
                          const uint8_t* __restrict__ valid, int B, int K,
                          long long d, long long n_words, long long n_blk,
                          __nv_bfloat16* __restrict__ uni,
                          uint32_t* __restrict__ words,
                          float* __restrict__ part) {
  using P = PackedTile<KM>;
  constexpr int TB = P::TB, TILE = P::TILE, Q = 2 * KM;
  constexpr int ROW = TILE * sizeof(T) + 16;   // a staged slot row
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto* ubuf = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * KM * ROW);
  auto* full = reinterpret_cast<uint64_t*>(ubuf + P::CONSUMERS * (BLOCK + 8));
  uint64_t* empty = full + STAGES;
  const long long n_tiles = (d + TILE - 1) / TILE;

  // the row of slot k of (client b, tile); 0 for invalid slots
  auto row_addr = [&](long long b, long long tile, int k) -> uintptr_t {
    return valid[b * K + k] ? reinterpret_cast<uintptr_t>(
                                  x + ((b * K + k) * d + tile * TILE))
                            : 0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TB);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == P::CONSUMERS) {
    // the producer: stage the block's tiles blockIdx.x, + gridDim.x, ...
    const long long q = gridDim.x / n_tiles, r = gridDim.x % n_tiles;
    Cursor in(blockIdx.x, n_tiles);
    for (int t = 0; in.b < B; ++t, in.advance(q, r, n_tiles)) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
      const long long n = d - in.tile * TILE < TILE ? d - in.tile * TILE
                                                    : TILE;
      const Cursor c = in;
      stage_rows(smem + s * KM * ROW, ROW, K,
                 [&](int k) { return row_addr(c.b, c.tile, k); },
                 static_cast<unsigned>(n * sizeof(T)), span, &full[s]);
    }
    return;
  }

  // a consumer: lambda block c of the tiles of group g (t = g, g + 2, ...)
  const int g = warp / TB, c = warp % TB;
  __nv_bfloat16* ub = ubuf + warp * (BLOCK + 8);
  const long long q2 = 2LL * gridDim.x / n_tiles,
                  r2 = 2LL * gridDim.x % n_tiles;
  Cursor at(blockIdx.x + static_cast<long long>(g) * gridDim.x, n_tiles);
  for (int t = g; at.b < B; t += 2, at.advance(q2, r2, n_tiles)) {
    const int s = t % STAGES;
    const long long b = at.b, blk = at.tile * TB + c, j0 = blk * BLOCK;
    const long long n = d - j0 < BLOCK ? d - j0 : BLOCK;  // <= 0: none
    const unsigned char* st = smem + s * KM * ROW;
    uintptr_t ra[KM];                     // row k at this lambda block
    unsigned vmask = 0, clean = 0;        // bit k: slot k valid / whole
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const uintptr_t a = k < K ? row_addr(b, at.tile, k) : 0;
      ra[k] = a ? a + c * BLOCK * sizeof(T) : 0;
      if (a) {
        vmask |= 1u << k;
        if (n > 0 &&
            in_span(ra[k], static_cast<unsigned>(n * sizeof(T)), span))
          clean |= 1u << k;
      }
    }
    const uintptr_t ga = reinterpret_cast<uintptr_t>(uni + (b * d + j0));
    const int uoff = static_cast<int>(ga & 15) / 2;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (n <= 0) {                         // past d: nothing but the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }

    // the 8 slices of 32 coordinates: slot values, tau, mask words and
    // each slice's lambda sums (lane L: quantity L / (32 / Q))
    float sl[WARPS];
    unsigned wv[WARPS];                   // lane k: slot k's words
    auto slice = [&](int i, auto&& load) {
      float xv[KM];
#pragma unroll
      for (int k = 0; k < KM; ++k) xv[k] = load(k, i * 32 + lane);
      const float tau = elect_padded<KM>(xv);
      ub[uoff + i * 32 + lane] = __float2bfloat16_rn(tau);
      const float atau = fabsf(tau);
      float qv[Q];                        // num 0..KM-1, den KM..2KM-1
      wv[i] = 0;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        // zero for invalid and padding slots and tail lanes (x is 0)
        const bool m = xv[k] * tau > 0.f;
        const unsigned bits = __ballot_sync(FULL, m);
        if (lane == k) wv[i] = bits;
        qv[k] = fabsf(xv[k]);
        qv[KM + k] = m ? atau : 0.f;
      }
      warp_sums<Q>(qv, lane);
      sl[i] = qv[0];
    };
    if (n == BLOCK && clean == vmask) {   // plain shared loads
      const T* sp[KM];
#pragma unroll
      for (int k = 0; k < KM; ++k)
        sp[k] = reinterpret_cast<const T*>(st + k * ROW + (ra[k] & 15)) +
                c * BLOCK;
#pragma unroll
      for (int i = 0; i < WARPS; ++i)
        slice(i, [&](int k, int jj) {
          return (vmask >> k) & 1u ? to_f32(sp[k][jj]) : 0.f;
        });
    } else {
      // a short last block or a row cut at the tensor's ends: each value
      // checked, the cut ones read from device memory
#pragma unroll
      for (int i = 0; i < WARPS; ++i)
        slice(i, [&](int k, int jj) {
          float v = 0.f;
          if (ra[k] && jj < n) {
            const uintptr_t y = ra[k] + jj * sizeof(T);
            const uintptr_t a = ra[k] - c * BLOCK * sizeof(T);  // tile row
            v = to_f32(*reinterpret_cast<const T*>(
                in_span(y, sizeof(T), span)
                    ? staged(st + k * ROW, a, y)
                    : reinterpret_cast<const unsigned char*>(y)));
          }
          return v;
        });
    }
    __syncwarp();                         // the stage is read, ub written
    if (lane == 0) mbar_arrive(&empty[s]);

    if (lane < K) {                       // slot lane's 8 mask words
      uint32_t* wr = words + (b * K + lane) * n_words + blk * WARPS;
#pragma unroll
      for (int i = 0; i < WARPS; ++i)
        if (blk * WARPS + i < n_words) wr[i] = wv[i];
    }
    // unified: the block's 16-byte-aligned middle as 16-byte stores, the
    // ends (under 8 values each) one value a lane
    const uintptr_t c_lo = (ga + 15) & ~uintptr_t(15);
    const uintptr_t c_hi = (ga + 2 * n) & ~uintptr_t(15);
    const int n_chunks = c_hi > c_lo ? static_cast<int>(c_hi - c_lo) / 16 : 0;
    if (lane < n_chunks)                  // written once: streaming
      __stcs(reinterpret_cast<uint4*>(c_lo + 16 * lane),
             *reinterpret_cast<const uint4*>(
                 reinterpret_cast<const unsigned char*>(ub) +
                 (c_lo - (ga & ~uintptr_t(15))) + 16 * lane));
    const long long head = (static_cast<long long>(c_lo - ga) / 2) < n
                               ? static_cast<long long>(c_lo - ga) / 2
                               : n;
    long long tail = (static_cast<long long>(c_hi) -
                      static_cast<long long>(ga)) / 2;
    if (tail < head) tail = head;
    if (lane < head)
      uni[b * d + j0 + lane] = ub[uoff + lane];
    else if (lane >= 16 && lane - 16 < n - tail)
      uni[b * d + j0 + tail + (lane - 16)] = ub[uoff + tail + (lane - 16)];

    // the block's lambda partials: the 8 slice sums by the halving tree
    // over the warps of the lambda grid, (w, w + 4), (w, w + 2), (0, 1)
    const float total = ((sl[0] + sl[4]) + (sl[2] + sl[6])) +
                        ((sl[1] + sl[5]) + (sl[3] + sl[7]));
    const int qi = lane / (32 / Q);
    if ((lane & (32 / Q - 1)) == 0 && qi % KM < K)
      part[((qi / KM * B + b) * K + qi % KM) * n_blk + blk] = total;
    __syncwarp();                         // ub is rewritten next block
  }
}

// One block a (num/den, client, slot) row of n lambda block partials: the
// sum by the (2i, 2i + 1) pairing over the row zero-padded to 8 * seg (seg
// a power of two >= 32).  Warp w takes the aligned segment [w seg, (w + 1)
// seg): an xor tree over each 32-value chunk (lane l pairs l ^ 1, then
// l ^ 2, ... — the pairing order), the chunk sums merged in order by a
// binary counter whose level-l entry lives in lane l; then the 8 segment
// sums by the same pairing.
__global__ void __launch_bounds__(BLOCK)
fused_unify_tree_kernel(const float* __restrict__ part, long long n,
                        long long seg, float* __restrict__ out) {
  __shared__ float ws[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = part + static_cast<long long>(blockIdx.x) * n;
  const long long base = warp * seg;
  float stack = 0.f;                      // lane l: the level-l subtree
  unsigned occ = 0;                       // bit l: level l is held
  for (long long c0 = 0; c0 < seg; c0 += 8 * 32) {
    float e[8];                           // 8 chunks' loads in flight
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long i = base + c0 + u * 32 + lane;
      e[u] = (c0 + u * 32 < seg && i < n) ? p[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u * 32 >= seg) break;      // uniform over the warp
      float v = e[u];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        v += __shfl_xor_sync(FULL, v, off);
      int lvl = 0;
      while ((occ >> lvl) & 1u) {         // the earlier subtree first
        v = __shfl_sync(FULL, stack, lvl) + v;
        occ &= ~(1u << lvl);
        ++lvl;
      }
      if (lane == lvl) stack = v;
      occ |= 1u << lvl;
    }
  }
  const float total = __shfl_sync(FULL, stack, 31 - __clz(occ));
  if (lane == 0) ws[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0)
    out[blockIdx.x] = ((ws[0] + ws[1]) + (ws[2] + ws[3])) +
                      ((ws[4] + ws[5]) + (ws[6] + ws[7]));
}

// Kernel 7 (unify_launch, the "vec" route).  Thread-wide loads: V values
// of a row, V * sizeof(T) <= 8 bytes, in 32-bit words (bf16 value c is
// the low half of word c / 2 when c is even).
template <int BYTES>
__device__ __forceinline__ void load_row(const void* p,
                                         uint32_t (&w)[(BYTES + 3) / 4]) {
  if constexpr (BYTES == 8) {
    const uint2 v = *static_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *static_cast<const unsigned int*>(p);
  } else {
    w[0] = *static_cast<const unsigned short*>(p);
  }
}

template <typename T>
__device__ __forceinline__ float word_value(const uint32_t* w, int c) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w[c]);
  else
    return __uint_as_float((c & 1) ? (w[c >> 1] & 0xffff0000u)
                                   : (w[c >> 1] << 16));
}

// V results as one V-wide store
template <int V>
__device__ __forceinline__ void store_out(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

constexpr int UNIFY_VEC_BYTES = 8;

// One vector of V coordinates a thread (one tile of BLOCK vectors a
// block): the K row loads are all issued before the first is used, then
// elect<KM> per coordinate in register order, exactly as the first design.
template <typename T, int KM, int V>
__global__ void __launch_bounds__(BLOCK)
unify_kernel(const T* __restrict__ x, int K, long long d,
             float* __restrict__ out) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  constexpr int W = (BYTES + 3) / 4;
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= d / V) return;
  uint32_t raw[KM][W];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k < K) {
      load_row<BYTES>(x + k * d + i * V, raw[k]);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) raw[k][w] = 0u;
    }
  }
  float r[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    float xv[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) xv[k] = word_value<T>(raw[k], c);
    r[c] = elect<KM>(xv, K);
  }
  store_out<V>(out + i * V, r);
}

// more slots than registers hold: the same order in two passes
template <typename T>
__global__ void __launch_bounds__(BLOCK)
unify_wide_kernel(const T* __restrict__ x, int K, long long d,
                  float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += to_f32(x[k * d + j]);
  const float sigma = sgn(s);
  float mu = 0.f;
  for (int k = 0; k < K; ++k) {
    const float v = to_f32(x[k * d + j]);
    if (v * sigma > 0.f) mu = fmaxf(mu, fabsf(v));
  }
  out[j] = sigma * mu;
}

template <int KM>
void launch_bool_km(const void* x, int x_bf16, const uint8_t* v, int K,
                    long long d, long long n_blk, long long ld, dim3 grid,
                    cudaStream_t s, float* u, uint8_t* m, float* np,
                    float* dp) {
  if (x_bf16)
    fused_unify_kernel<__nv_bfloat16, KM><<<grid, BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, K, d, n_blk, ld, u, m, np,
        dp);
  else
    fused_unify_kernel<float, KM><<<grid, BLOCK, 0, s>>>(
        static_cast<const float*>(x), v, K, d, n_blk, ld, u, m, np, dp);
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

int launch_bool(const void* x, int x_bf16, const void* valid, int B, int K,
                long long d, float* uni, uint8_t* masks, float* np,
                float* dp, long long part_ld, cudaStream_t s) {
  const long long n_blk = (d + BLOCK - 1) / BLOCK;
  if (K < 1 || K > KMAX || B < 1 || B > 65535 || d < 1 || part_ld < n_blk)
    return static_cast<int>(cudaErrorInvalidValue);
  // a few resident waves of blocks; each block walks lambda blocks
  const long long want = (32LL * sm_count() + B - 1) / B;
  const long long n_grp = (n_blk + GROUPS - 1) / GROUPS;
  const dim3 grid(static_cast<unsigned>(want < n_grp ? want : n_grp),
                  static_cast<unsigned>(B));
  auto* v = static_cast<const uint8_t*>(valid);
  // registers for the smallest power of two >= K slots
  if (K <= 1)
    launch_bool_km<1>(x, x_bf16, v, K, d, n_blk, part_ld, grid, s, uni,
                      masks, np, dp);
  else if (K <= 2)
    launch_bool_km<2>(x, x_bf16, v, K, d, n_blk, part_ld, grid, s, uni,
                      masks, np, dp);
  else if (K <= 4)
    launch_bool_km<4>(x, x_bf16, v, K, d, n_blk, part_ld, grid, s, uni,
                      masks, np, dp);
  else if (K <= 8)
    launch_bool_km<8>(x, x_bf16, v, K, d, n_blk, part_ld, grid, s, uni,
                      masks, np, dp);
  else
    launch_bool_km<16>(x, x_bf16, v, K, d, n_blk, part_ld, grid, s, uni,
                       masks, np, dp);
  return static_cast<int>(cudaGetLastError());
}

// The packed C call: the lambda-block kernel, then the tree over its
// partials.
template <typename T, int KM>
int launch_packed_t(const T* x, const uint8_t* v, int B, int K, long long d,
                    __nv_bfloat16* uni, uint32_t* words, float* part,
                    long long n_blk, float* num_den, cudaStream_t s) {
  constexpr int THREADS = PackedTile<KM>::THREADS;
  constexpr size_t smem = packed_smem<KM, T>();
  auto kern = fused_unify_packed_kernel<T, KM>;
  static int per_sm = 0;                 // resident blocks a SM
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long tiles =
      static_cast<long long>(B) *
      ((d + PackedTile<KM>::TILE - 1) / PackedTile<KM>::TILE);
  const long long resident = static_cast<long long>(per_sm) * sm_count();
  const unsigned grid =
      static_cast<unsigned>(tiles < resident ? tiles : resident);
  const Span span = tensor_span(x, static_cast<unsigned long long>(B) * K *
                                       d * sizeof(T));
  kern<<<grid, THREADS, smem, s>>>(x, span, v, B, K, d, (d + 31) / 32,
                                   n_blk, uni, words, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  long long pow2 = 1;
  while (pow2 < n_blk) pow2 <<= 1;
  const long long seg = pow2 / WARPS > 32 ? pow2 / WARPS : 32;
  fused_unify_tree_kernel<<<2 * B * K, BLOCK, 0, s>>>(part, n_blk, seg,
                                                       num_den);
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int launch_packed(const void* x, int x_bf16, const uint8_t* v, int B, int K,
                  long long d, void* uni, void* words, void* part,
                  long long n_blk, void* num_den, cudaStream_t s) {
  auto* u = static_cast<__nv_bfloat16*>(uni);
  auto* w = static_cast<uint32_t*>(words);
  auto* p = static_cast<float*>(part);
  auto* o = static_cast<float*>(num_den);
  if (x_bf16)
    return launch_packed_t<__nv_bfloat16, KM>(
        static_cast<const __nv_bfloat16*>(x), v, B, K, d, u, w, p, n_blk, o,
        s);
  return launch_packed_t<float, KM>(static_cast<const float*>(x), v, B, K, d,
                                    u, w, p, n_blk, o, s);
}

// The load width V of the "vec" route (fused_unify.unify_plan mirrors
// it): the widest of 8 / elt, 4 / elt, ... that x's element offset from
// an 8-byte boundary and d are multiples of; 1 on the "wide" route.
int unify_vec(int K, long long d, int elt, unsigned long long ptr) {
  if (K > KMAX) return 1;
  long long v = UNIFY_VEC_BYTES / elt;
  const long long off = static_cast<long long>(ptr % UNIFY_VEC_BYTES) / elt;
  while (off % v || d % v) v >>= 1;      // gcd with powers of two
  return static_cast<int>(v);
}

// every V that unify_vec returns has a case here; any other is refused
static_assert(UNIFY_VEC_BYTES == 8, "launch_unify_km launches V <= 4");

template <typename T, int KM>
cudaError_t launch_unify_km(const T* x, int K, long long d, int vec,
                            unsigned grid, float* out, cudaStream_t s) {
  switch (vec) {
    case 1:
      unify_kernel<T, KM, 1><<<grid, BLOCK, 0, s>>>(x, K, d, out);
      return cudaSuccess;
    case 2:
      unify_kernel<T, KM, 2><<<grid, BLOCK, 0, s>>>(x, K, d, out);
      return cudaSuccess;
    case 4:
      if constexpr (sizeof(T) == 2) {
        unify_kernel<T, KM, 4><<<grid, BLOCK, 0, s>>>(x, K, d, out);
        return cudaSuccess;
      }
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_unify(const T* x, int K, long long d, int vec,
                         unsigned grid, float* out, cudaStream_t s) {
  if (K <= 1) return launch_unify_km<T, 1>(x, K, d, vec, grid, out, s);
  if (K <= 2) return launch_unify_km<T, 2>(x, K, d, vec, grid, out, s);
  if (K <= 4) return launch_unify_km<T, 4>(x, K, d, vec, grid, out, s);
  if (K <= 8) return launch_unify_km<T, 8>(x, K, d, vec, grid, out, s);
  if (K <= KMAX)
    return launch_unify_km<T, KMAX>(x, K, d, vec, grid, out, s);
  if (vec != 1) return cudaErrorInvalidValue;
  unify_wide_kernel<T><<<grid, BLOCK, 0, s>>>(x, K, d, out);
  return cudaSuccess;
}

}  // namespace

// x (B, K, d) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); valid (B, K) uint8.
// Outputs: uni (B, d) bf16, words (B, K, ceil(d/32)) uint32 and num_den
// (2, B, K) fp32 (lambda num, then den).  part is a (2, B, K, n_blk) fp32
// workspace (no contents needed) of the lambda block partials, n_blk =
// ceil(d/256); any other n_blk is refused.
// Returns cudaGetLastError().
extern "C" int fused_unify_packed_launch(const void* x, int x_bf16,
                                         const void* valid, int B, int K,
                                         long long d, void* uni, void* words,
                                         void* part, long long n_blk,
                                         void* num_den, void* stream) {
  if (K < 1 || K > KMAX || B < 1 || B > 65535 || d < 1 ||
      n_blk != (d + BLOCK - 1) / BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const uint8_t*>(valid);
  // registers for the smallest power of two >= K slots
  if (K <= 1)
    return launch_packed<1>(x, x_bf16, v, B, K, d, uni, words, part, n_blk,
                            num_den, s);
  if (K <= 2)
    return launch_packed<2>(x, x_bf16, v, B, K, d, uni, words, part, n_blk,
                            num_den, s);
  if (K <= 4)
    return launch_packed<4>(x, x_bf16, v, B, K, d, uni, words, part, n_blk,
                            num_den, s);
  if (K <= 8)
    return launch_packed<8>(x, x_bf16, v, B, K, d, uni, words, part, n_blk,
                            num_den, s);
  return launch_packed<16>(x, x_bf16, v, B, K, d, uni, words, part, n_blk,
                           num_den, s);
}

// The bool/fp32 layout: x and valid as above; uni (B, d) fp32, masks
// (B, K, d) uint8 holding 0 or 1 (a torch.bool tensor), num_part and
// den_part (B, K, part_ld) fp32 lambda block partials with part_ld >=
// ceil(d/256); entries past ceil(d/256) are not written.
extern "C" int fused_unify_launch(const void* x, int x_bf16, const void* valid,
                                  int B, int K, long long d, void* uni,
                                  void* masks, void* num_part, void* den_part,
                                  long long part_ld, void* stream) {
  return launch_bool(x, x_bf16, valid, B, K, d, static_cast<float*>(uni),
                     static_cast<uint8_t*>(masks),
                     static_cast<float*>(num_part),
                     static_cast<float*>(den_part), part_ld,
                     static_cast<cudaStream_t>(stream));
}

// Eq. 2 for one client: x (K, d) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1),
// any K >= 1; out (d,) fp32, aligned for V-wide stores.  V is unify_vec's
// width for x's address.  Returns cudaGetLastError().
extern "C" int unify_launch(const void* x, int x_bf16, int K, long long d,
                            void* out, void* stream) {
  if (K < 1 || d < 1 || (d + BLOCK - 1) / BLOCK > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = unify_vec(K, d, x_bf16 ? 2 : 4,
                            reinterpret_cast<unsigned long long>(x));
  if (reinterpret_cast<unsigned long long>(out) % (4 * vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  const auto grid = static_cast<unsigned>((d / vec + BLOCK - 1) / BLOCK);
  const cudaError_t err =
      x_bf16 ? launch_unify(static_cast<const __nv_bfloat16*>(x), K, d, vec,
                            grid, o, s)
             : launch_unify(static_cast<const float*>(x), K, d, vec, grid,
                            o, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// unify_vec for a caller (fused_unify.unify_plan's card test): the load
// width unify_launch takes for a stack of K rows of d elt-byte values at
// address ptr.
extern "C" int unify_vec_width(int K, long long d, int elt,
                               unsigned long long ptr) {
  return unify_vec(K, d, elt, ptr);
}
