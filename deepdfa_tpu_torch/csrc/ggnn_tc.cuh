// The tensor-core variant of the GGNN's kernels: device code shared by the
// forward (fused_ggnn.cu), the training backward (fused_ggnn_bwd.cu) and the
// whole-model forward (megabatch.cu), at width 128.
//
// Products. Every product runs on `wgmma` in 3xTF32: each float32 operand x
// splits into big = tf32(x) and small = tf32(x - big), and a product is
// small.big + big.small + big.big, summed in float32 (hopper.cuh), which
// keeps float32's accuracy. TF32 `wgmma` reads B from shared memory K-major
// only, so the operands are placed to make that free: the node-sized
// operand (h, agg, dxp, ...; rows are nodes, the contracted width is
// contiguous) is B, split by the threads that load or compute it and stored
// into 128-byte-swizzled tiles, and the weight is A, split in registers
// (the gate weights staged by TMA bulk copies through a two-stage ring in
// shared memory, the others loaded from L2). The block computes the
// transposed product C^T = W^T X^T: a warpgroup's 64 rows are output
// features, its columns the block's 64 nodes (wgmma's n). So a block owns
// whole node rows, every output row depends only on its own input row and
// the weights, and nothing is split over K or over the node axis.
//
// Edge sum. The in-order float32 sum over a CSR (or CSC) segment, one warp
// per row, each lane four columns, as the FFMA variant sums it, with
// changes that leave every bit of the result as it was: the next 32
// indices are loaded before the current ones' rows are added, and a run of
// k >= 32 equal indices is added in closed form (repeat_add): the serial
// chain acc + x + ... + x has a constant increment inside each binade of
// the accumulator, so it is walked a binade at a time. A bitmask of the
// chunks of 32 edges in which the index changes (built once per call with
// the row pointer) finds the end of a run in two loads. batch_np points
// every padding edge at the padding sink, so the sink's segment is one run
// of thousands: the forward's round leaves such a segment to the whole
// block (whole_run_sum), one column a thread.
//
// The sink's row itself is ill-conditioned: its aggregate is the run's
// length times its message, its gate pre-activations as large, and which
// of its saturated gates tip decides its state, so any rounding of its
// products other than the plain version's shows. A row whose whole
// segment is a run of self-loops (find_sink_rows: a property of its own
// edges) therefore stays out of the tiles and takes the FFMA variant's
// arithmetic (fmaf over K in order, gru_cell), bit for bit that variant's
// row.

#pragma once

#include <stdint.h>

#include "ggnn_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTcD = 128;        // the width this variant takes
constexpr int kTcRows = 64;      // nodes per block: wgmma's n
constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kSubBytes = kTcRows * 128;       // 64 rows x 32 floats: 8 KB
constexpr int kTileBytes = kTcRows * kTcD * 4;  // 64 rows x 128 floats
constexpr int kKSteps = kTcD / 8;              // k8 steps over the width

// ------------------------------------------------ the edge sum

// acc + x + x + ... + x (k adds, each rounded to float32 as the serial
// chain rounds it), bit for bit. Where acc is 0 or has the sign of x and
// both are finite, the chain is walked in magnitudes a binade of the
// accumulator at a time: with a = A u (u = the binade's spacing, A < 2^24)
// and y = |x|, each add that stays in the binade adds round(y / u) ulps
// (ties to even, so after at most one step from an odd A the increment is
// constant), which gives the number of adds left in the binade at once; an
// add that leaves it, or starts from 0, is made as the chain makes it. A
// few steps a binade, ~45 for k = 2^15. Otherwise (a start of the other
// sign, inf or NaN) the chain itself runs.
__device__ float repeat_add(float acc, float x, int k) {
  if (k <= 0) return acc;
  const uint32_t xb = __float_as_uint(x), ab = __float_as_uint(acc);
  const uint32_t xm = xb & 0x7FFFFFFFu, am = ab & 0x7FFFFFFFu;
  if (xm == 0) return acc + x;  // a zero: one add, then a fixed point
  if (xm >= 0x7F800000u || am >= 0x7F800000u
      || (am != 0 && ((ab ^ xb) >> 31) != 0)) {
    for (int i = 0; i < k; ++i) acc += x;
    return acc;
  }
  const float y = __uint_as_float(xm);
  const int ey = max((int)(xm >> 23), 1);
  const uint32_t yq = xm - ((uint32_t)(ey - 1) << 23);  // y = yq 2^(ey-150)
  float a = __uint_as_float(am);
  while (k > 0) {
    const uint32_t bits = __float_as_uint(a);
    if (bits >= 0x7F800000u) break;  // inf + y = inf
    const int e = max((int)(bits >> 23), 1);
    const uint32_t aq = bits - ((uint32_t)(e - 1) << 23);  // a = aq 2^(e-150)
    const int sh = e - ey;  // y / u = yq 2^-sh
    if (sh >= 25) break;    // y under half an ulp: a no longer moves
    // a = 0, or y / u >= 2^24 (the add leaves the binade): the chain's add
    if (bits == 0 || sh < 0) {
      a += y;
      --k;
      continue;
    }
    uint32_t q, inc;
    if (sh == 0) {
      q = inc = yq;
    } else {
      q = yq >> sh;
      const uint32_t rem = yq & ((1u << sh) - 1u), half = 1u << (sh - 1);
      if (rem < half) {
        inc = q;
      } else if (rem > half) {
        inc = q + 1u;
      } else if (aq & 1u) {  // a tie from an odd aq: one add makes it even
        a += y;
        --k;
        continue;
      } else {
        inc = q + (q & 1u);
      }
    }
    if (inc == 0) break;
    // an add from aq_j stays in the binade while aq_j + y / u < 2^24: take
    // all of them at once, then the add that leaves the binade
    const uint32_t last = 0xFFFFFFu - q;
    if (aq <= last) {
      // floor((last - aq) / inc) + 1 adds, the quotient estimated in float
      // and corrected to the exact integer
      const uint32_t span = last - aq;
      uint32_t quo = (uint32_t)__fdividef((float)span, (float)inc);
      while (quo * inc > span) --quo;
      while ((quo + 1u) * inc <= span) ++quo;
      const uint32_t t = min(quo + 1u, (uint32_t)k);
      a = __uint_as_float(((uint32_t)(e - 1) << 23) + aq + t * inc);
      k -= (int)t;
    }
    if (k > 0) {
      a += y;
      --k;
    }
  }
  return __uint_as_float(__float_as_uint(a) | (xb & 0x80000000u));
}

__device__ __forceinline__ float4 repeat_add4(float4 acc, float4 x, int k) {
  return make_float4(repeat_add(acc.x, x.x, k), repeat_add(acc.y, x.y, k),
                     repeat_add(acc.z, x.z, k), repeat_add(acc.w, x.w, k));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The end of the run of index s0 that fills idx[pos .. pos + 31]: the first
// position after it whose index differs, or `end`. Bit c of heads[c / 32]
// says whether chunk c (positions 32c .. 32c + 31) holds a position whose
// index differs from the one before it; one warp load covers 32 words, 32k
// edges. Called by a whole warp.
__device__ int run_end(const int* __restrict__ idx,
                       const uint32_t* __restrict__ heads, int pos, int end,
                       int s0, int lane) {
  const int c_last = (end - 1) >> 5;
  int c = (pos + 32) >> 5;  // no chunk before it changes inside the run
  while (c <= c_last) {
    const int w0 = c >> 5;
    uint32_t word = w0 + lane <= (c_last >> 5) ? __ldg(heads + w0 + lane) : 0u;
    if (lane == 0) word &= ~0u << (c & 31);
    const uint32_t any = __ballot_sync(0xffffffffu, word != 0);
    if (any == 0) {
      c = (w0 + 32) << 5;
      continue;
    }
    const int src = __ffs(any) - 1;
    const uint32_t hit = __shfl_sync(0xffffffffu, word, src);
    const int cf = ((w0 + src) << 5) + __ffs(hit) - 1;
    if (cf > c_last) return end;
    // every position from the run's start up to the change in chunk cf
    // holds s0, so the change is the first position there that does not
    const int p = (cf << 5) + lane;
    const uint32_t ne = __ballot_sync(0xffffffffu,
                                      p < end && __ldg(idx + p) != s0);
    return ne ? (cf << 5) + __ffs(ne) - 1 : end;
  }
  return end;
}

// Sum of src[idx[e]] (rows of 128 floats) over e in [beg, end), in list
// order, bit for bit the serial float32 sum; lane l keeps columns 4l ..
// 4l + 3. Called by a whole warp. With `whole` given, a segment that is one
// run of a single index (the padding sink's) is not summed: *whole gets
// that index and the sum is left to the caller (whole_run_sum), which
// spreads its 128 closed forms over the block; otherwise *whole is -1.
__device__ float4 segment_sum(const float* __restrict__ src,
                              const int* __restrict__ idx,
                              const uint32_t* __restrict__ heads, int beg,
                              int end, int lane, int* whole = nullptr) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int col = 4 * lane;
  int pos = beg;
  int my = pos + lane < end ? __ldg(idx + pos + lane) : 0;
  if (whole != nullptr) *whole = -1;
  while (pos < end) {
    const int cnt = min(32, end - pos);
    const int s0 = __shfl_sync(0xffffffffu, my, 0);
    if (__all_sync(0xffffffffu, cnt == 32 && my == s0)) {
      const int stop = run_end(idx, heads, pos, end, s0, lane);
      if (whole != nullptr && pos == beg && stop == end) {
        *whole = s0;
        return acc;
      }
      acc = repeat_add4(acc, ld4(src + (size_t)s0 * kTcD + col), stop - pos);
      __syncwarp();
      pos = stop;
      my = pos + lane < end ? __ldg(idx + pos + lane) : 0;
      continue;
    }
    // the next 32 indices, in flight while these rows are added
    const int nxt = pos + cnt;
    const int my_next = nxt + lane < end ? __ldg(idx + nxt + lane) : 0;
    for (int j0 = 0; j0 < cnt; j0 += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = __shfl_sync(0xffffffffu, my, (j0 + j) & 31);
        v[j] = j0 + j < cnt ? ld4(src + (size_t)s * kTcD + col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + j < cnt) {
          acc.x += v[j].x;
          acc.y += v[j].y;
          acc.z += v[j].z;
          acc.w += v[j].w;
        }
      }
    }
    pos = nxt;
    my = my_next;
  }
  return acc;
}

// Once per call: row_ptr[v] = first position whose key is >= v (keys sorted
// ascending), and the change bitmask of idx that run_end reads
// (ceil(n_edges / 1024) words, one warp a word).
__global__ void tc_prep_kernel(const int* __restrict__ keys,
                               const int* __restrict__ idx, int n_edges,
                               int n_nodes, int* __restrict__ row_ptr,
                               uint32_t* __restrict__ heads, int n_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= n_nodes) {
    int lo = 0, hi = n_edges;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < i) lo = mid + 1; else hi = mid;
    }
    row_ptr[i] = lo;
  }
  const int w = i >> 5, lane = threadIdx.x & 31;
  if (w < n_words) {  // whole warps
    uint32_t word = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int p = (w << 10) + (j << 5) + lane;
      const bool change = p >= 1 && p < n_edges
                          && __ldg(idx + p) != __ldg(idx + p - 1);
      if (__ballot_sync(0xffffffffu, change)) word |= 1u << j;
    }
    if (lane == 0) heads[w] = word;
  }
}

// The `heads` words for n_edges edges (at least one, so the buffer exists).
int heads_words(int n_edges) { return n_edges > 0 ? (n_edges + 1023) / 1024 : 1; }

// Per row of a block: the warp's eight rows w, w + 8, ..., w + 56 have their
// segment bounds loaded at once (lanes 0-7 the starts, 8-15 the ends).
__device__ __forceinline__ int bounds(const int* __restrict__ row_ptr,
                                      int row0, int n, int warp, int lane) {
  const int r = row0 + warp + 8 * (lane & 7) + (lane >> 3);
  return lane < 16 ? __ldg(row_ptr + min(r, n)) : 0;
}

// The list of the block's flagged rows (row_flag[r] set) in row order,
// by warp 0; ends with a barrier.
__device__ __forceinline__ void list_flags(const int* row_flag, int* list,
                                           int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool f0 = row_flag[lane] != 0, f1 = row_flag[32 + lane] != 0;
    const uint32_t b0 = __ballot_sync(0xffffffffu, f0);
    const uint32_t b1 = __ballot_sync(0xffffffffu, f1);
    if (f0) list[__popc(b0 & ((1u << lane) - 1u))] = lane;
    if (f1) list[__popc(b0) + __popc(b1 & ((1u << lane) - 1u))] = 32 + lane;
    if (lane == 0) *count = __popc(b0) + __popc(b1);
  }
  __syncthreads();
}

// The rows that take the FFMA arithmetic, as this call's edge linear
// found them (flags [n]). Called by the whole block; ends with a barrier.
__device__ __forceinline__ void read_flags(const int* __restrict__ flags,
                                           int row0, int n, int* row_flag,
                                           int* list, int* count) {
  if (threadIdx.x < kTcRows) {
    const int row = row0 + threadIdx.x;
    row_flag[threadIdx.x] = row < n && __ldg(flags + row) != 0;
  }
  __syncthreads();
  list_flags(row_flag, list, count);
}

// The block's padding-sink rows: a row whose whole segment is a run of at
// least 32 self-loops (batch_np points every padding edge sink -> sink).
// Its aggregate is the run's length times its own message, so both its
// messages and its gates take the FFMA arithmetic (see
// gru_round_tc_kernel). A property of the row's own edges alone, found one
// warp a row with the edge sum's run search; written to row_flag and to
// flags[row] for the rounds. Called by the whole block; ends with a
// barrier.
__device__ __forceinline__ void find_sink_rows(
    const int* __restrict__ row_ptr, const int* __restrict__ idx,
    const uint32_t* __restrict__ heads, int row0, int n, int* row_flag,
    int* __restrict__ flags, int* list, int* count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bnd = bounds(row_ptr, row0, n, warp, lane);
  for (int i = 0; i < 8; ++i) {
    const int rr = warp + 8 * i, row = row0 + rr;
    const int beg = __shfl_sync(0xffffffffu, bnd, i);
    const int end = __shfl_sync(0xffffffffu, bnd, 8 + i);
    bool sink = false;
    if (end - beg >= 32) {  // the warp's row: uniform
      const int my = __ldg(idx + beg + lane);
      if (__all_sync(0xffffffffu, my == row))
        sink = run_end(idx, heads, beg, end, row, lane) == end;
    }
    if (lane == 0) {
      row_flag[rr] = sink;
      if (row < n) flags[row] = sink;
    }
  }
  __syncthreads();
  list_flags(row_flag, list, count);
}

// ------------------------------------------------ operand tiles

// Byte offset of (row r, columns k .. k + 3) in a B operand tile of 64 rows
// (nodes) by K floats, K-major: K/32 slices of 64 rows x 128 bytes, each
// 128-byte swizzled (16-byte chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ int xt_off(int r, int k) {
  return (k >> 5) * kSubBytes + ((r >> 3) << 10) + ((r & 7) << 7)
         + ((((k & 31) >> 2) ^ (r & 7)) << 4);
}

// Split four floats and store them into the big and small tiles.
__device__ __forceinline__ void put4(uint8_t* big, uint8_t* small, int off,
                                     float4 v) {
  uint4 b, s;
  split_tf32(v.x, b.x, s.x);
  split_tf32(v.y, b.y, s.y);
  split_tf32(v.z, b.z, s.z);
  split_tf32(v.w, b.w, s.w);
  *reinterpret_cast<uint4*>(big + off) = b;
  *reinterpret_cast<uint4*>(small + off) = s;
}

// Rows row0 .. row0 + 63 of x [n, 128] (zero past n, and for the rows
// `skip` flags, when given), split, into the tiles: a warp stores one row's
// 32 float4s, eight distinct chunks per 128 bytes, so no bank conflict.
__device__ __forceinline__ void load_split_rows(const float* __restrict__ x,
                                                int row0, int n, uint8_t* big,
                                                uint8_t* small,
                                                const int* skip = nullptr) {
  for (int i = threadIdx.x; i < kTcRows * kTcD / 4; i += kTcThreads) {
    const int r = i >> 5, k = (i & 31) << 2;
    const int row = row0 + r;
    const bool live = row < n && (skip == nullptr || !skip[r]);
    const float4 v = live ? ld4(x + (size_t)row * kTcD + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    put4(big, small, xt_off(r, k), v);
  }
}

// The rows whose segment segment_sum reported as one run (list of `count`
// entries: row in the block, source row, run length), their 128 closed
// forms spread over the block's threads: each row's sum goes to agg_x (the
// exact aggregates), to the big and small tiles unless the row is flagged,
// and to agg_bank when given. Called by the whole block; ends with a
// barrier.
__device__ __forceinline__ void whole_run_sum(
    const float* __restrict__ src, const int* list, int count, int row0,
    int n, const int* row_flag, float* agg_x, uint8_t* big, uint8_t* small,
    float* __restrict__ agg_bank) {
  for (int i = threadIdx.x; i < count * kTcD; i += kTcThreads) {
    const int which = i / kTcD, c = i - which * kTcD;
    const int rr = list[3 * which], s0 = list[3 * which + 1];
    const float v = repeat_add(0.f, __ldg(src + (size_t)s0 * kTcD + c),
                               list[3 * which + 2]);
    agg_x[rr * kTcD + c] = v;
    uint32_t b = 0, sm = 0;
    if (!row_flag[rr]) split_tf32(v, b, sm);
    const int off = xt_off(rr, c & ~3) + 4 * (c & 3);
    *reinterpret_cast<uint32_t*>(big + off) = b;
    *reinterpret_cast<uint32_t*>(small + off) = sm;
    if (agg_bank != nullptr && row0 + rr < n)
      agg_bank[(size_t)(row0 + rr) * kTcD + c] = v;
  }
  __syncthreads();
}

// ------------------------------------------------ products

// This thread's A fragment of a weight at (output row m, K column k), its
// first: rows m and m + 8, columns k and k + 4 (wgmma's TF32 register
// layout, m = 16 (warp % 4) + lane / 4, k = lane % 4 within the step). With
// kMRow the element (m, k) is w[m * ld + k], otherwise w[k * ld + m].
template <bool kMRow>
__device__ __forceinline__ void load_a(float (&raw)[4],
                                       const float* __restrict__ w, int ld,
                                       int m, int k) {
  if (kMRow) {
    raw[0] = __ldg(w + (size_t)m * ld + k);
    raw[1] = __ldg(w + (size_t)(m + 8) * ld + k);
    raw[2] = __ldg(w + (size_t)m * ld + k + 4);
    raw[3] = __ldg(w + (size_t)(m + 8) * ld + k + 4);
  } else {
    raw[0] = __ldg(w + (size_t)k * ld + m);
    raw[1] = __ldg(w + (size_t)k * ld + m + 8);
    raw[2] = __ldg(w + (size_t)(k + 4) * ld + m);
    raw[3] = __ldg(w + (size_t)(k + 4) * ld + m + 8);
  }
}

__device__ __forceinline__ void split_a(const float (&raw)[4],
                                        uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(raw[i], big[i], small[i]);
}

// acc (+)= A . B in 3xTF32, B's k8 slice given by its big and small tiles'
// descriptors
__device__ __forceinline__ void mma3(float (&acc)[32], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint64_t bb,
                                     uint64_t bs) {
  wgmma_tf32_n64(acc, as, bb);
  wgmma_tf32_n64(acc, ab, bs);
  wgmma_tf32_n64(acc, ab, bb);
}
__device__ __forceinline__ void mma3(float (&acc)[64], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint64_t bb,
                                     uint64_t bs) {
  wgmma_tf32_n128(acc, as, bb);
  wgmma_tf32_n128(acc, ab, bs);
  wgmma_tf32_n128(acc, ab, bb);
}

// The descriptor of k8 step ks of a B tile of 64 rows by 128 floats.
__device__ __forceinline__ uint64_t step_desc(const uint8_t* tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * kSubBytes) + 2 * (ks & 3);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// The gate weights reach the products through a two-stage ring in shared
// memory: stage ks % 2 holds rows 8 ks .. 8 ks + 7 of xw and of hw ([128,
// 384] each, the rows contiguous in memory), brought by 16 bulk copies
// (TMA) that complete on the stage's mbarrier; rows are padded to 392
// floats, so the fragment loads of a warp hit 32 distinct banks.
constexpr int kWRow = 3 * kTcD + 8;
constexpr int kWStage = 2 * 8 * kWRow * 4;
constexpr int kWStageTx = 2 * 8 * 3 * kTcD * 4;

// thread 0 only: bring step ks's weight rows into `stage`
__device__ __forceinline__ void stage_weights(uint8_t* stage, uint64_t* bar,
                                              const float* xw,
                                              const float* hw, int ks) {
  fence_proxy_async();
  mbar_expect_tx(bar, kWStageTx);
#pragma unroll 1
  for (int r = 0; r < 8; ++r) {
    const size_t src = (size_t)(8 * ks + r) * 3 * kTcD;
    bulk_load(stage + r * kWRow * 4, xw + src, 3 * kTcD * 4, bar);
    bulk_load(stage + (8 + r) * kWRow * 4, hw + src, 3 * kTcD * 4, bar);
  }
}

// thread 0 only, first in the kernel: the ring's barriers, and steps 0 and
// 1 on their way while the block loads and sums its rows.
__device__ __forceinline__ void ring_start(uint8_t* ring, uint64_t* full,
                                           const float* xw, const float* hw) {
  mbar_init(&full[0], 1);
  mbar_init(&full[1], 1);
  fence_proxy_async();
  stage_weights(ring, &full[0], xw, hw, 0);
  stage_weights(ring + kWStage, &full[1], xw, hw, 1);
}

// Both 3-gate GRU products of the block's 64 nodes for warpgroup wg's 64
// columns c = 64 wg + .. of each gate, transposed: r = xw_r^T agg^T +
// hw_r^T h^T and z likewise in one sum each, xn = xw_n^T agg^T and hn =
// hw_n^T h^T apart (n = tanh(xn + r hn)), without the biases. The weights
// are [128, 384] as the caller stores them, staged through the ring
// (ring_start ran); the tiles hold agg and h split. Each k8 step issues 18
// m64n64k8 wgmmas; the next step's fragments load from the ring while they
// run.
struct GateSums {
  float r[32], z[32], xn[32], hn[32];
};

__device__ __forceinline__ void load_gate_frags(float (&raw)[6][4],
                                                const uint8_t* stage, int m,
                                                int t) {
  const float* ws = reinterpret_cast<const float*>(stage);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float* w = ws + (q < 3 ? 0 : 8 * kWRow) + (q % 3) * kTcD + m;
    raw[q][0] = w[t * kWRow];
    raw[q][1] = w[t * kWRow + 8];
    raw[q][2] = w[(t + 4) * kWRow];
    raw[q][3] = w[(t + 4) * kWRow + 8];
  }
}

__device__ __forceinline__ void gate_products_tc(
    const uint8_t* agg_big, const uint8_t* agg_small, const uint8_t* h_big,
    const uint8_t* h_small, uint8_t* ring, uint64_t* full,
    const float* __restrict__ xw, const float* __restrict__ hw, GateSums& s) {
  const int lane = threadIdx.x & 31;
  const int m = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2)
                + 64 * (threadIdx.x >> 7);
  const int t = lane & 3;
  zero(s.r);
  zero(s.z);
  zero(s.xn);
  zero(s.hn);
  float raw[6][4];
  mbar_wait(&full[0], 0);
  load_gate_frags(raw, ring, m, t);
#pragma unroll 1
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t fb[6][4], fs[6][4];
#pragma unroll
    for (int q = 0; q < 6; ++q) split_a(raw[q], fb[q], fs[q]);
    const uint64_t gb = step_desc(agg_big, ks), gs = step_desc(agg_small, ks);
    const uint64_t hb = step_desc(h_big, ks), hs = step_desc(h_small, ks);
    wgmma_fence();
    mma3(s.r, fb[0], fs[0], gb, gs);
    mma3(s.r, fb[3], fs[3], hb, hs);
    mma3(s.z, fb[1], fs[1], gb, gs);
    mma3(s.z, fb[4], fs[4], hb, hs);
    mma3(s.xn, fb[2], fs[2], gb, gs);
    mma3(s.hn, fb[5], fs[5], hb, hs);
    wgmma_commit();
    if (ks + 1 < kKSteps) {
      const int nx = (ks + 1) & 1;
      mbar_wait(&full[nx], ((ks + 1) >> 1) & 1);
      load_gate_frags(raw, ring + nx * kWStage, m, t);
    }
    wgmma_wait_all();
    fence_regs(s.r);
    fence_regs(s.z);
    fence_regs(s.xn);
    fence_regs(s.hn);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      fence_regs(fb[q]);
      fence_regs(fs[q]);
    }
    // every thread has read step ks's stage (its fragments loaded in the
    // last step): refill it with step ks + 2
    __syncthreads();
    if (threadIdx.x == 0 && ks + 2 < kKSteps)
      stage_weights(ring + (ks & 1) * kWStage, &full[ks & 1], xw, hw, ks + 2);
  }
}

// Sum i of a warpgroup's m64 x n64 tile: d[4j + 2h + e] is output feature
// 16 (warp % 4) + lane / 4 + 8h (plus 64 wg) of node 8j + 2 (lane % 4) + e.
__device__ __forceinline__ int tile_col(int h) {
  return 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3)
         + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int tile_row(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + e;
}

// The tensor-core epilogue's activations, on the special-function unit:
// __expf and the approximate division, within a few ulps of the float32
// functions (1/(1 + e^-x) and 1 - 2/(e^2x + 1); both reach their limits
// exactly where the exponential overflows).
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// ------------------------------------------------ kernels

// batch_np's padding sink (find_sink_rows) has an aggregate thousands of
// times its message, and gate pre-activations as large, whose rounding
// decides which of its saturated gates tip: a product rounded otherwise
// than the plain version's moves the row past float32-level agreement
// after five rounds. The tensor-core kernels therefore leave those rows
// out of the tiles and compute them in the FFMA variant's arithmetic, in
// its order (fmaf over K from 0, gru_cell), which the checks hold to the
// plain version; the sink is one row a batch.

constexpr int kLinearSmem = 2 * kTileBytes + 1024;
// agg and h tiles, the weight ring, the exact aggregates, the FFMA lane's
// 768 sums and h row, the ring's barriers
constexpr int kRoundSmem = 4 * kTileBytes + 2 * kWStage
                           + 4 * (kTcRows * kTcD + 6 * kTcD + kTcD) + 16
                           + 1024;

// out[n, 128] = a[n, 128] @ w[128, 128] + b: the edge linear. It also
// finds the padding-sink rows (find_sink_rows, into flags for the round)
// and computes theirs in the FFMA arithmetic.
__global__ void __launch_bounds__(kTcThreads, 1)
linear_tc_kernel(const float* __restrict__ a, const float* __restrict__ w,
                 const float* __restrict__ b, const int* __restrict__ row_ptr,
                 const int* __restrict__ senders,
                 const uint32_t* __restrict__ heads, int* __restrict__ flags,
                 float* __restrict__ out, int n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int row_flag[kTcRows], flagged[kTcRows], n_flagged;
  uint8_t* big = align1024(smem_raw);
  uint8_t* small = big + kTileBytes;
  const int row0 = blockIdx.x * kTcRows;
  find_sink_rows(row_ptr, senders, heads, row0, n, row_flag, flags, flagged,
                 &n_flagged);
  load_split_rows(a, row0, n, big, small);
  fence_proxy_async();
  __syncthreads();

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int m = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3)
                + (lane >> 2);
  float acc[32];
  zero(acc);
  float raw[4];
  load_a<false>(raw, w, kTcD, m, t);
#pragma unroll 1
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t fb[4], fs[4];
    split_a(raw, fb, fs);
    wgmma_fence();
    mma3(acc, fb, fs, step_desc(big, ks), step_desc(small, ks));
    wgmma_commit();
    if (ks + 1 < kKSteps) load_a<false>(raw, w, kTcD, m, 8 * (ks + 1) + t);
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(fb);
    fence_regs(fs);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = tile_col(h);
    const float bias = b[col];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = tile_row(j, e), row = row0 + r;
        if (row < n && !row_flag[r])
          out[(size_t)row * kTcD + col] = acc[4 * j + 2 * h + e] + bias;
      }
  }
  // flagged rows: the FFMA variant's linear (fmaf over K in order, + b)
  for (int f = 0; f < n_flagged; ++f) {
    const int row = row0 + flagged[f];
    if (threadIdx.x < kTcD) {
      const float* x = a + (size_t)row * kTcD;
      float v = 0.f;
#pragma unroll 16
      for (int k = 0; k < kTcD; ++k)
        v = fmaf(__ldg(x + k), __ldg(w + (size_t)k * kTcD + threadIdx.x), v);
      out[(size_t)row * kTcD + threadIdx.x] = v + b[threadIdx.x];
    }
  }
}

// One GRU round for 64 nodes: the in-order edge sum of their segments (one
// warp a row, eight rows a warp) into the agg tiles (and agg_bank, when
// given), h into the h tiles, both 3-gate products, and the GRU epilogue
// into h_out; flagged rows in the FFMA arithmetic.
__global__ void __launch_bounds__(kTcThreads, 1)
gru_round_tc_kernel(const float* __restrict__ h, const float* __restrict__ msg,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ senders,
                    const uint32_t* __restrict__ heads,
                    const int* __restrict__ flags,
                    const float* __restrict__ xw, const float* __restrict__ xb,
                    const float* __restrict__ hw, const float* __restrict__ hb,
                    float* __restrict__ h_out, float* __restrict__ agg_bank,
                    int n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int row_flag[kTcRows], flagged[kTcRows], n_flagged;
  __shared__ int whole[3 * kTcRows], n_whole;
  uint8_t* agg_big = align1024(smem_raw);
  uint8_t* agg_small = agg_big + kTileBytes;
  uint8_t* h_big = agg_small + kTileBytes;
  uint8_t* h_small = h_big + kTileBytes;
  uint8_t* ring = h_small + kTileBytes;
  float* agg_x = reinterpret_cast<float*>(ring + 2 * kWStage);  // [64][128]
  float* sums = agg_x + kTcRows * kTcD;                          // [768]
  float* h_row = sums + 6 * kTcD;                                // [128]
  uint64_t* full = reinterpret_cast<uint64_t*>(h_row + kTcD);
  const int row0 = blockIdx.x * kTcRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) ring_start(ring, full, xw, hw);
  read_flags(flags, row0, n, row_flag, flagged, &n_flagged);
  load_split_rows(h, row0, n, h_big, h_small, row_flag);
  if (tid == 0) n_whole = 0;
  __syncthreads();
  const int bnd = bounds(row_ptr, row0, n, warp, lane);
  for (int i = 0; i < 8; ++i) {
    const int rr = warp + 8 * i, row = row0 + rr;
    const int beg = __shfl_sync(0xffffffffu, bnd, i);
    const int end = __shfl_sync(0xffffffffu, bnd, 8 + i);
    int src;
    const float4 v = segment_sum(msg, senders, heads, beg, end, lane, &src);
    if (src >= 0) {  // one long run: summed below by the whole block
      if (lane == 0) {
        const int at = atomicAdd(&n_whole, 1);
        whole[3 * at] = rr;
        whole[3 * at + 1] = src;
        whole[3 * at + 2] = end - beg;
      }
      continue;
    }
    *reinterpret_cast<float4*>(agg_x + rr * kTcD + 4 * lane) = v;
    put4(agg_big, agg_small, xt_off(rr, 4 * lane),
         row_flag[rr] ? make_float4(0.f, 0.f, 0.f, 0.f) : v);
    if (agg_bank != nullptr && row < n)
      *reinterpret_cast<float4*>(agg_bank + (size_t)row * kTcD + 4 * lane) = v;
  }
  __syncthreads();
  whole_run_sum(msg, whole, n_whole, row0, n, row_flag, agg_x, agg_big,
                agg_small, agg_bank);
  fence_proxy_async();
  __syncthreads();

  GateSums s;
  gate_products_tc(agg_big, agg_small, h_big, h_small, ring, full, xw, hw, s);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = tile_col(hh);
    float hv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_row(j, e);
        hv[2 * j + e] = row < n ? __ldg(h + (size_t)row * kTcD + col) : 0.f;
      }
    const float br = xb[col] + hb[col], bz = xb[kTcD + col] + hb[kTcD + col];
    const float bxn = xb[2 * kTcD + col], chn = hb[2 * kTcD + col];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = tile_row(j, e), row = row0 + r;
        if (row >= n || row_flag[r]) continue;
        const int i = 4 * j + 2 * hh + e;
        const float rg = sigmoid_fast(s.r[i] + br);
        const float zg = sigmoid_fast(s.z[i] + bz);
        const float ng = tanh_fast(s.xn[i] + bxn + rg * (s.hn[i] + chn));
        h_out[(size_t)row * kTcD + col] = (1.f - zg) * ng + zg * hv[2 * j + e];
      }
  }

  // flagged rows: the FFMA variant's gate products (fmaf over K in order)
  // and gru_cell
  for (int f = 0; f < n_flagged; ++f) {
    const int rr = flagged[f], row = row0 + rr;
    __syncthreads();
    if (tid < kTcD) h_row[tid] = h[(size_t)row * kTcD + tid];
    __syncthreads();
    // thread t sums outputs t, t + 256, t + 512 of [ax | ah], the three
    // chains side by side and K unrolled, so the weight loads overlap
    const float* v[3];
    const float* wt[3];
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int o = tid + kTcThreads * c;
      const bool x_side = o < 3 * kTcD;
      v[c] = x_side ? agg_x + rr * kTcD : h_row;
      wt[c] = (x_side ? xw + o : hw + (o - 3 * kTcD));
    }
#pragma unroll 16
    for (int k = 0; k < kTcD; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = fmaf(v[c][k], __ldg(wt[c] + (size_t)k * 3 * kTcD), acc[c]);
#pragma unroll
    for (int c = 0; c < 3; ++c) sums[tid + kTcThreads * c] = acc[c];
    __syncthreads();
    if (tid < kTcD) {
      const float* ax = sums;
      const float* ah = sums + 3 * kTcD;
      h_out[(size_t)row * kTcD + tid] =
          gru_cell(ax[tid], ax[kTcD + tid], ax[2 * kTcD + tid], ah[tid],
                   ah[kTcD + tid], ah[2 * kTcD + tid], xb, hb, tid, kTcD,
                   h_row[tid]);
    }
  }
}

// ------------------------------------------------ host side

template <typename K>
cudaError_t allow_smem_once(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

int launch_tc_prep(const int* keys, const int* idx, int n_edges, int n_nodes,
                   int* row_ptr, uint32_t* heads, cudaStream_t stream) {
  const int words = n_edges > 0 ? heads_words(n_edges) : 0;
  const int threads = max(n_nodes + 1, 32 * words);
  tc_prep_kernel<<<(threads + 255) / 256, 256, 0, stream>>>(
      keys, idx, n_edges, n_nodes, row_ptr, heads, words);
  return (int)cudaGetLastError();
}

int launch_tc_linear(const float* a, const float* w, const float* b,
                     const int* row_ptr, const int* senders,
                     const uint32_t* heads, int* flags, float* out, int n,
                     cudaStream_t stream) {
  static bool sized = false;
  const cudaError_t err = allow_smem_once(linear_tc_kernel, kLinearSmem, sized);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  linear_tc_kernel<<<(n + kTcRows - 1) / kTcRows, kTcThreads, kLinearSmem,
                     stream>>>(a, w, b, row_ptr, senders, heads, flags, out,
                               n);
  return (int)cudaGetLastError();
}

int launch_tc_round(const float* h, const float* msg, const int* row_ptr,
                    const int* senders, const uint32_t* heads,
                    const int* flags, const float* xw, const float* xb,
                    const float* hw, const float* hb, float* h_out,
                    float* agg_bank, int n, cudaStream_t stream) {
  static bool sized = false;
  const cudaError_t err = allow_smem_once(gru_round_tc_kernel, kRoundSmem,
                                          sized);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  gru_round_tc_kernel<<<(n + kTcRows - 1) / kTcRows, kTcThreads, kRoundSmem,
                        stream>>>(h, msg, row_ptr, senders, heads, flags, xw,
                                  xb, hw, hb, h_out, agg_bank, n);
  return (int)cudaGetLastError();
}

}  // namespace
