// The tensor-core variant of the GGNN's kernels: device code shared by the
// forward (fused_ggnn.cu), the training backward (fused_ggnn_bwd.cu) and the
// whole-model forward (megabatch.cu), instantiated at the widths D = 128
// (the golden model's) and 192, 224, 288 (the analysis families': 32-wide
// tables of the four subkeys plus the two interprocedural, the three
// dataflow, or all five families).
//
// Products. Every product runs on `wgmma` in 3xTF32: each float32 operand x
// splits into big = tf32(x) and small = tf32(x - big), and a product is
// small.big + big.small + big.big, summed in float32 (hopper.cuh), which
// keeps float32's accuracy. TF32 `wgmma` reads B from shared memory K-major
// only, so the operands are placed to make that free: the node-sized
// operand (h, agg, dxp, ...; rows are nodes, the contracted width is
// contiguous) is B, split by the threads that load or compute it and stored
// into 128-byte-swizzled tiles, and the weight is A, split in registers
// (at 128 the gate weights staged by TMA bulk copies through a two-stage
// ring in shared memory; every other weight, and the gate weights at the
// family widths, loaded from L2 ahead of the wgmmas that take them). The
// block computes the transposed product C^T = W^T X^T: a warpgroup's 64
// rows are output features, its columns the block's R nodes (wgmma's n).
// So a block owns whole node rows, every output row depends only on its
// own input row and the weights, and nothing is split over K or over the
// node axis.
//
// Widths. An output of width D is T = ceil(D / 64) tiles of 64 features;
// the block's two warpgroups take them in passes, warpgroup w tile 2p + w
// in pass p (at 224 and 288 the last tile is half full: its rows past D
// read zero weights and are not stored; at 192 and 288 the last pass has
// one tile, and the other warpgroup waits). What bounds the wider widths
// is shared memory: a block holds its R rows of agg and h, split, as four
// tiles (16 R D bytes), so R = 64 (the 128 instance's shape, kept as it
// was) would need 196-295 KB at 192-288 before any weight staging,
// against the 227 KB a block may have, and R = 32 is what fills the card
// at N 5,760 (180 blocks of 256 threads on 132 SMs). Per width (R; the
// grid at N 5,760; the round kernel's shared memory as a profiler trace
// of the launch reports it, 656 bytes of it static, and its registers):
// 128: 64, 90, 182,288 + 1,296 B; 192: 32, 180, 106,128 B, 214; 224: 32,
// 180, 123,536 B, 214; 288: 32, 180, 158,352 B, 237. With R = 32 a wgmma
// is m64n32k8, and a k8 step of the gate products is 18 of them a
// warpgroup; what sets the pace there is loading, splitting and issuing
// each step's fragments (the wait on the step's wgmmas is a small part of
// a step), not the tensor cores' rate.
//
// Edge sum. The in-order float32 sum over a CSR (or CSC) segment, one warp
// per row, lane l keeping columns 4 (l + 32 c) .. + 3 for c < ceil(D / 128),
// as the FFMA variant sums it, with changes that leave every bit of the
// result as it was: the next 32 indices are loaded before the current
// ones' rows are added, and a run of k >= 32 equal indices is added in
// closed form (repeat_add): the serial chain acc + x + ... + x has a
// constant increment inside each binade of the accumulator, so it is
// walked a binade at a time. A bitmask of the chunks of 32 edges in which
// the index changes (built once per call with the row pointer) finds the
// end of a run in two loads. batch_np points every padding edge at the
// padding sink, so the sink's segment is one run of thousands: the
// forward's round leaves such a segment to the whole block
// (whole_run_sum), one column a thread.
//
// The sink's row itself is ill-conditioned: its aggregate is the run's
// length times its message, its gate pre-activations as large, and which
// of its saturated gates tip decides its state, so any rounding of its
// products other than the plain version's shows. A row whose whole
// segment is a run of self-loops (find_sink_rows: a property of its own
// edges) therefore stays out of the tiles' products and takes the FFMA
// variant's arithmetic (fmaf over K in order, gru_cell), bit for bit that
// variant's row. Its exact aggregate waits in the big agg tile (unsplit;
// its small tile is zero), where the products' outputs for it are not
// stored.
//
// Tried and dropped at the family widths (each timed beside the design
// above on one H100): the gate weights through a three-stage TMA ring of
// the pass's 128 columns, slower than the FFMA variant at every width (a
// block waits on every stage and one thread issues its 48 copies; issued
// by a whole warp, still slower than L2); two k8 steps of fragments loaded
// at once, and the next step's wgmmas issued before the last one's wait
// (`wgmma` wait_group 1), within a few per cent either way and spilling at
// 288; r and z summed in separate accumulators for agg and h, slower;
// full gate rows (3D columns) in each ring stage with every tile of a pass
// in registers at once (at 288 a stage is 55 KB and five tiles' four sums
// are 320 registers a thread at R = 32).

#pragma once

#include <stdint.h>

#include <type_traits>

#include "ggnn_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTcThreads = 256;  // two warpgroups

// The shape of the tensor-core kernels at width D.
template <int D>
struct Tc {
  static_assert(D % 32 == 0, "the tiles hold 32-float slices of the width");
  static constexpr int R = D == 128 ? 64 : 32;  // nodes per block: wgmma's n
  static constexpr int T = (D + 63) / 64;       // 64-feature output tiles
  static constexpr int P = (T + 1) / 2;         // passes of the two warpgroups
  static constexpr int KS = D / 8;              // k8 steps over the width
  static constexpr int NV = (D / 4 + 31) / 32;  // float4 of a row a lane sums
  static constexpr int TileBytes = R * D * 4;   // R rows x D floats
};

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

// Sum of src[idx[e]] (rows of D floats) over e in [beg, end), in list
// order, bit for bit the serial float32 sum, into acc: lane l keeps
// columns 4q .. 4q + 3 for q = l + 32 c < D / 4. Called by a whole warp.
// With `whole` given, a segment that is one run of a single index (the
// padding sink's) is not summed: *whole gets that index and the sum is
// left to the caller (whole_run_sum), which spreads its D closed forms
// over the block; otherwise *whole is -1.
template <int D>
__device__ void segment_sum(const float* __restrict__ src,
                            const int* __restrict__ idx,
                            const uint32_t* __restrict__ heads, int beg,
                            int end, int lane, float4 (&acc)[Tc<D>::NV],
                            int* whole = nullptr) {
  constexpr int NV = Tc<D>::NV, Q = D / 4;
#pragma unroll
  for (int c = 0; c < NV; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
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
        return;
      }
#pragma unroll
      for (int c = 0; c < NV; ++c)
        if (lane + 32 * c < Q)
          acc[c] = repeat_add4(
              acc[c], ld4(src + (size_t)s0 * D + 4 * (lane + 32 * c)),
              stop - pos);
      __syncwarp();
      pos = stop;
      my = pos + lane < end ? __ldg(idx + pos + lane) : 0;
      continue;
    }
    // the next 32 indices, in flight while these rows are added
    const int nxt = pos + cnt;
    const int my_next = nxt + lane < end ? __ldg(idx + nxt + lane) : 0;
    for (int j0 = 0; j0 < cnt; j0 += 8) {
      float4 v[8][NV];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = __shfl_sync(0xffffffffu, my, (j0 + j) & 31);
#pragma unroll
        for (int c = 0; c < NV; ++c)
          v[j][c] = j0 + j < cnt && lane + 32 * c < Q
                        ? ld4(src + (size_t)s * D + 4 * (lane + 32 * c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + j < cnt) {
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            acc[c].x += v[j][c].x;
            acc[c].y += v[j][c].y;
            acc[c].z += v[j][c].z;
            acc[c].w += v[j][c].w;
          }
        }
      }
    }
    pos = nxt;
    my = my_next;
  }
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

// Per row of a block: warp w's rows w, w + 8, ..., w + 56 have their
// segment bounds loaded at once (lanes 0-7 the starts, 8-15 the ends); a
// block of R rows reads the first R / 8 of them.
__device__ __forceinline__ int bounds(const int* __restrict__ row_ptr,
                                      int row0, int n, int warp, int lane) {
  const int r = row0 + warp + 8 * (lane & 7) + (lane >> 3);
  return lane < 16 ? __ldg(row_ptr + min(r, n)) : 0;
}

// The list of the block's flagged rows (row_flag[r] set) in row order,
// by warp 0; ends with a barrier.
template <int R>
__device__ __forceinline__ void list_flags(const int* row_flag, int* list,
                                           int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
#pragma unroll
    for (int w = 0; w < R / 32; ++w) {
      const bool f = row_flag[32 * w + lane] != 0;
      const uint32_t b = __ballot_sync(0xffffffffu, f);
      if (f) list[base + __popc(b & ((1u << lane) - 1u))] = 32 * w + lane;
      base += __popc(b);
    }
    if (lane == 0) *count = base;
  }
  __syncthreads();
}

// The rows that take the FFMA arithmetic, as this call's edge linear
// found them (flags [n]). Called by the whole block; ends with a barrier.
template <int R>
__device__ __forceinline__ void read_flags(const int* __restrict__ flags,
                                           int row0, int n, int* row_flag,
                                           int* list, int* count) {
  if (threadIdx.x < R) {
    const int row = row0 + threadIdx.x;
    row_flag[threadIdx.x] = row < n && __ldg(flags + row) != 0;
  }
  __syncthreads();
  list_flags<R>(row_flag, list, count);
}

// The block's padding-sink rows: a row whose whole segment is a run of at
// least 32 self-loops (batch_np points every padding edge sink -> sink).
// Its aggregate is the run's length times its own message, so both its
// messages and its gates take the FFMA arithmetic (see
// gru_round_tc_kernel). A property of the row's own edges alone, found one
// warp a row with the edge sum's run search; written to row_flag and to
// flags[row] for the rounds. Called by the whole block; ends with a
// barrier.
template <int R>
__device__ __forceinline__ void find_sink_rows(
    const int* __restrict__ row_ptr, const int* __restrict__ idx,
    const uint32_t* __restrict__ heads, int row0, int n, int* row_flag,
    int* __restrict__ flags, int* list, int* count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bnd = bounds(row_ptr, row0, n, warp, lane);
  for (int i = 0; i < R / 8; ++i) {
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
  list_flags<R>(row_flag, list, count);
}

// ------------------------------------------------ operand tiles

// Byte offset of (row r, columns k .. k + 3) in a B operand tile of R rows
// (nodes) by K floats, K-major: K/32 slices of R rows x 128 bytes, each
// 128-byte swizzled (16-byte chunk c of row r at c ^ (r % 8)).
template <int R>
__device__ __forceinline__ int xt_off(int r, int k) {
  return (k >> 5) * (R * 128) + ((r >> 3) << 10) + ((r & 7) << 7)
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

// An aggregate's four floats into the agg tiles: split, or for a row in
// the FFMA lane (`exact`) unsplit into the big tile, its small tile zero.
__device__ __forceinline__ void put_agg4(uint8_t* big, uint8_t* small,
                                         int off, float4 v, bool exact) {
  if (exact) {
    *reinterpret_cast<float4*>(big + off) = v;
    *reinterpret_cast<uint4*>(small + off) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    put4(big, small, off, v);
  }
}

// The aggregate an FFMA-lane row left in the big agg tile (put_agg4).
template <int R>
__device__ __forceinline__ float agg_exact(const uint8_t* big, int r, int k) {
  return *reinterpret_cast<const float*>(big + xt_off<R>(r, k & ~3)
                                         + 4 * (k & 3));
}

// Rows row0 .. row0 + R - 1 of src [n, ld], columns c0 .. c0 + K - 1 (zero
// past n, and for the rows `skip` flags, when given), split, into the
// tiles (K-major, column c - c0): eight lanes store one row's 32-float
// slice, eight distinct chunks per 128 bytes, so no bank conflict. With
// kFresh the rows are data this kernel wrote, read through L2 (__ldcg)
// instead of the read-only path.
template <int R, int K, bool kFresh = false>
__device__ __forceinline__ void load_split(const float* src, int ld, int c0,
                                           int row0, int n, uint8_t* big,
                                           uint8_t* small,
                                           const int* skip = nullptr) {
  constexpr int Q = K / 4;
  for (int i = threadIdx.x; i < R * Q; i += kTcThreads) {
    const int r = i / Q, k = (i - r * Q) << 2;
    const int row = row0 + r;
    const bool live = row < n && (skip == nullptr || !skip[r]);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      const float* p = src + (size_t)row * ld + c0 + k;
      v = kFresh ? __ldcg(reinterpret_cast<const float4*>(p)) : ld4(p);
    }
    put4(big, small, xt_off<R>(r, k), v);
  }
}

// The rows whose segment segment_sum reported as one run (list of `count`
// entries: row in the block, source row, run length), their D closed
// forms spread over the block's threads: each row's sum goes to the agg
// tiles (put_agg4's way) and to agg_bank when given. Called by the whole
// block; ends with a barrier.
template <int D>
__device__ __forceinline__ void whole_run_sum(
    const float* __restrict__ src, const int* list, int count, int row0,
    int n, const int* row_flag, uint8_t* big, uint8_t* small,
    float* __restrict__ agg_bank) {
  constexpr int R = Tc<D>::R;
  for (int i = threadIdx.x; i < count * D; i += kTcThreads) {
    const int which = i / D, c = i - which * D;
    const int rr = list[3 * which], s0 = list[3 * which + 1];
    const float v = repeat_add(0.f, __ldg(src + (size_t)s0 * D + c),
                               list[3 * which + 2]);
    uint32_t b = __float_as_uint(v), sm = 0;
    if (!row_flag[rr]) split_tf32(v, b, sm);
    const int off = xt_off<R>(rr, c & ~3) + 4 * (c & 3);
    *reinterpret_cast<uint32_t*>(big + off) = b;
    *reinterpret_cast<uint32_t*>(small + off) = sm;
    if (agg_bank != nullptr && row0 + rr < n)
      agg_bank[(size_t)(row0 + rr) * D + c] = v;
  }
  __syncthreads();
}

// ------------------------------------------------ products

// d[0..15] (+)= A (64 x 8 tf32, registers) . B (8 x 32, shared memory,
// K-major, 128-byte swizzled); always accumulates
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
// descriptors; n = 32, 64 or 128 by the accumulator's size
__device__ __forceinline__ void mma3(float (&acc)[16], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint64_t bb,
                                     uint64_t bs) {
  wgmma_tf32_n32(acc, as, bb);
  wgmma_tf32_n32(acc, ab, bs);
  wgmma_tf32_n32(acc, ab, bb);
}
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

// The descriptor of k8 step ks of a B tile of R rows.
template <int R>
__device__ __forceinline__ uint64_t step_desc(const uint8_t* tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * (R * 128)) + 2 * (ks & 3);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// A warpgroup's row of its 64-feature tile: 16 (warp % 4) + lane / 4 (the
// fragment's rows are it and it + 8).
__device__ __forceinline__ int tile_m() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}

// acc (+)= A . B over k8 steps ks0 .. ks0 + steps - 1 of B's tiles of R
// rows, A's fragments (output row m, K column k0 + 8 s + lane % 4 at the
// s-th step) read from the weight w in memory (load_a's layout kMRow), or
// zero where !live (rows past the output's width). Four steps (one
// 32-float slice of B) a group: the next group's fragments load while a
// group's 12 wgmmas run. `steps` is a multiple of 4.
template <bool kMRow, int R>
__device__ __forceinline__ void product_l2(float (&acc)[R / 2],
                                           const float* __restrict__ w,
                                           int ld, int m, int k0, bool live,
                                           const uint8_t* big,
                                           const uint8_t* small, int ks0,
                                           int steps) {
  const int t = threadIdx.x & 3;
  float raw[4][4];
  auto load = [&](int grp) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (live) load_a<kMRow>(raw[s], w, ld, m, k0 + 8 * (4 * grp + s) + t);
      else zero(raw[s]);
    }
  };
  load(0);
#pragma unroll 1
  for (int grp = 0; grp < steps / 4; ++grp) {
    uint32_t fb[4][4], fs[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) split_a(raw[s], fb[s], fs[s]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      mma3(acc, fb[s], fs[s], step_desc<R>(big, ks0 + 4 * grp + s),
           step_desc<R>(small, ks0 + 4 * grp + s));
    wgmma_commit();
    if (grp + 1 < steps / 4) load(grp + 1);
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fence_regs(fb[s]);
      fence_regs(fs[s]);
    }
  }
}

// Both 3-gate GRU products of the block's R nodes for warpgroup wg's 64
// columns c of each gate, transposed: r = xw_r^T agg^T + hw_r^T h^T and z
// likewise in one sum each, xn = xw_n^T agg^T and hn = hw_n^T h^T apart
// (n = tanh(xn + r hn)), without the biases. The weights are [D, 3D] as
// the caller stores them; the tiles hold agg and h split. Each k8 step
// issues 18 m64nRk8 wgmmas, and the next step's fragments load while they
// run.
template <int N>
struct GateSums {
  float r[N], z[N], xn[N], hn[N];
};

// At width 128 the gate weights come through a two-stage ring in shared
// memory: stage ks % 2 holds rows 8 ks .. 8 ks + 7 of xw and of hw
// ([128, 384] each, the rows contiguous in memory), brought by 16 bulk
// copies (TMA) that complete on the stage's mbarrier; rows are padded to
// 392 floats, so the fragment loads of a warp hit 32 distinct banks.
constexpr int kWRow = 3 * 128 + 8;
constexpr int kWStage = 2 * 8 * kWRow * 4;
constexpr int kWStageTx = 2 * 8 * 3 * 128 * 4;

// thread 0 only: bring step ks's weight rows into `stage`
__device__ __forceinline__ void stage_weights(uint8_t* stage, uint64_t* bar,
                                              const float* xw,
                                              const float* hw, int ks) {
  fence_proxy_async();
  mbar_expect_tx(bar, kWStageTx);
#pragma unroll 1
  for (int r = 0; r < 8; ++r) {
    const size_t src = (size_t)(8 * ks + r) * 3 * 128;
    bulk_load(stage + r * kWRow * 4, xw + src, 3 * 128 * 4, bar);
    bulk_load(stage + (8 + r) * kWRow * 4, hw + src, 3 * 128 * 4, bar);
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

__device__ __forceinline__ void load_gate_frags(float (&raw)[6][4],
                                                const uint8_t* stage, int m,
                                                int t) {
  const float* ws = reinterpret_cast<const float*>(stage);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float* w = ws + (q < 3 ? 0 : 8 * kWRow) + (q % 3) * 128 + m;
    raw[q][0] = w[t * kWRow];
    raw[q][1] = w[t * kWRow + 8];
    raw[q][2] = w[(t + 4) * kWRow];
    raw[q][3] = w[(t + 4) * kWRow + 8];
  }
}

// Width 128, one pass: the fragments from the ring (ring_start ran).
__device__ __forceinline__ void gate_products_ring(
    const uint8_t* agg_big, const uint8_t* agg_small, const uint8_t* h_big,
    const uint8_t* h_small, uint8_t* ring, uint64_t* full,
    const float* __restrict__ xw, const float* __restrict__ hw,
    GateSums<32>& s) {
  const int t = threadIdx.x & 3;
  const int m = 64 * (threadIdx.x >> 7) + tile_m();
  zero(s.r);
  zero(s.z);
  zero(s.xn);
  zero(s.hn);
  float raw[6][4];
  mbar_wait(&full[0], 0);
  load_gate_frags(raw, ring, m, t);
#pragma unroll 1
  for (int ks = 0; ks < 16; ++ks) {
    uint32_t fb[6][4], fs[6][4];
#pragma unroll
    for (int q = 0; q < 6; ++q) split_a(raw[q], fb[q], fs[q]);
    const uint64_t gb = step_desc<64>(agg_big, ks);
    const uint64_t gs = step_desc<64>(agg_small, ks);
    const uint64_t hb = step_desc<64>(h_big, ks);
    const uint64_t hs = step_desc<64>(h_small, ks);
    wgmma_fence();
    mma3(s.r, fb[0], fs[0], gb, gs);
    mma3(s.r, fb[3], fs[3], hb, hs);
    mma3(s.z, fb[1], fs[1], gb, gs);
    mma3(s.z, fb[4], fs[4], hb, hs);
    mma3(s.xn, fb[2], fs[2], gb, gs);
    mma3(s.hn, fb[5], fs[5], hb, hs);
    wgmma_commit();
    if (ks + 1 < 16) {
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
    if (threadIdx.x == 0 && ks + 2 < 16)
      stage_weights(ring + (ks & 1) * kWStage, &full[ks & 1], xw, hw, ks + 2);
  }
}

// acc (+)= A . B in 3xTF32 for one of several independent sums: the same
// three wgmmas as mma3, issued one at a time (`part` 0-2) so that a step
// can interleave its sums (each sum's own order stays mma3's)
__device__ __forceinline__ void mma3_part(float (&acc)[16], int part,
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          uint64_t bb, uint64_t bs) {
  if (part == 0) wgmma_tf32_n32(acc, as, bb);
  else if (part == 1) wgmma_tf32_n32(acc, ab, bs);
  else wgmma_tf32_n32(acc, ab, bb);
}

// The family widths, pass p: warpgroup wg's tile 2p + wg (its columns 64
// (2p + wg) + .. of each gate; the rows past D read zero weights), each
// thread's fragments loaded from L2 a k8 step ahead, the step's wgmmas
// issued sum by sum in turn. A warpgroup with no tile in this pass (the
// last one at an odd tile count) returns at once: nothing here waits on
// the other.
template <int D>
__device__ __forceinline__ void gate_pass_l2(
    const uint8_t* agg_big, const uint8_t* agg_small, const uint8_t* h_big,
    const uint8_t* h_small, const float* __restrict__ xw,
    const float* __restrict__ hw, int p, GateSums<16>& s) {
  using S = Tc<D>;
  constexpr int d3 = 3 * D;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 3;
  const int m = 64 * (2 * p + wg) + tile_m();  // the row's column in a gate
  const bool live = m < D;
  zero(s.r);
  zero(s.z);
  zero(s.xn);
  zero(s.hn);
  if (2 * p + wg >= S::T) return;
  float raw[6][4];
  auto load = [&](int k) {  // rows k, k + 4 of each gate's columns m, m + 8
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float* w = (q < 3 ? xw : hw) + (q % 3) * D + m;
      raw[q][0] = live ? __ldg(w + (size_t)k * d3) : 0.f;
      raw[q][1] = live ? __ldg(w + (size_t)k * d3 + 8) : 0.f;
      raw[q][2] = live ? __ldg(w + (size_t)(k + 4) * d3) : 0.f;
      raw[q][3] = live ? __ldg(w + (size_t)(k + 4) * d3 + 8) : 0.f;
    }
  };
  load(t);
#pragma unroll 1
  for (int ks = 0; ks < S::KS; ++ks) {
    uint32_t fb[6][4], fs[6][4];
#pragma unroll
    for (int q = 0; q < 6; ++q) split_a(raw[q], fb[q], fs[q]);
    const uint64_t gb = step_desc<32>(agg_big, ks);
    const uint64_t gs = step_desc<32>(agg_small, ks);
    const uint64_t hb = step_desc<32>(h_big, ks);
    const uint64_t hs = step_desc<32>(h_small, ks);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part) {  // agg's products, then h's
      mma3_part(s.r, part, fb[0], fs[0], gb, gs);
      mma3_part(s.z, part, fb[1], fs[1], gb, gs);
      mma3_part(s.xn, part, fb[2], fs[2], gb, gs);
      mma3_part(s.hn, part, fb[5], fs[5], hb, hs);
    }
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      mma3_part(s.r, part, fb[3], fs[3], hb, hs);
      mma3_part(s.z, part, fb[4], fs[4], hb, hs);
    }
    wgmma_commit();
    if (ks + 1 < S::KS) load(8 * (ks + 1) + t);
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
  }
}

// Pass p of the gate products at width D (one pass at 128).
template <int D>
__device__ __forceinline__ void gate_pass_tc(
    const uint8_t* agg_big, const uint8_t* agg_small, const uint8_t* h_big,
    const uint8_t* h_small, uint8_t* ring, uint64_t* full,
    const float* __restrict__ xw, const float* __restrict__ hw, int p,
    GateSums<Tc<D>::R / 2>& s) {
  if constexpr (D == 128)
    gate_products_ring(agg_big, agg_small, h_big, h_small, ring, full, xw,
                       hw, s);
  else
    gate_pass_l2<D>(agg_big, agg_small, h_big, h_small, xw, hw, p, s);
}

// Sum i of a warpgroup's m64 x nR tile: d[4j + 2h + e] is output feature
// tile_m() + 8h of its tile, node 8j + 2 (lane % 4) + e.
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
// after five rounds. The tensor-core kernels therefore leave those rows'
// products unstored and compute them in the FFMA variant's arithmetic, in
// its order (fmaf over K from 0, gru_cell), which the checks hold to the
// plain version; the sink is one row a batch.

template <int D>
constexpr int linear_tc_smem() { return 2 * Tc<D>::TileBytes + 1024; }
// agg and h tiles, then at 128 the weight ring and its barriers (the FFMA
// lane's sums and rows reuse the ring once the products are done), at the
// other widths room for those sums and rows
template <int D>
constexpr int round_tc_smem() {
  return 4 * Tc<D>::TileBytes + (D == 128 ? 2 * kWStage + 16 : 8 * D * 4)
         + 1024;
}

// out[n, D] = a[n, D] @ w[D, D] + b: the edge linear. It also finds the
// padding-sink rows (find_sink_rows, into flags for the round) and
// computes theirs in the FFMA arithmetic.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
linear_tc_kernel(const float* __restrict__ a, const float* __restrict__ w,
                 const float* __restrict__ b, const int* __restrict__ row_ptr,
                 const int* __restrict__ senders,
                 const uint32_t* __restrict__ heads, int* __restrict__ flags,
                 float* __restrict__ out, int n) {
  using S = Tc<D>;
  constexpr int R = S::R;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int row_flag[R], flagged[R], n_flagged;
  uint8_t* big = align1024(smem_raw);
  uint8_t* small = big + S::TileBytes;
  const int row0 = blockIdx.x * R;
  find_sink_rows<R>(row_ptr, senders, heads, row0, n, row_flag, flags,
                    flagged, &n_flagged);
  load_split<R, D>(a, D, 0, row0, n, big, small);
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x >> 7;
#pragma unroll 1
  for (int p = 0; p < S::P; ++p) {
    const int mt = 2 * p + wg;
    if (mt >= S::T) continue;  // the warpgroup's: uniform
    const int m = 64 * mt + tile_m();
    const bool live = m < D;
    float acc[R / 2];
    zero(acc);
    product_l2<false, R>(acc, w, D, m, 0, live, big, small, 0, S::KS);
    if (!live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = m + 8 * h;
      const float bias = b[col];
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = tile_row(j, e), row = row0 + r;
          if (row < n && !row_flag[r])
            out[(size_t)row * D + col] = acc[4 * j + 2 * h + e] + bias;
        }
    }
  }
  // flagged rows: the FFMA variant's linear (fmaf over K in order, + b)
  for (int f = 0; f < n_flagged; ++f) {
    const int row = row0 + flagged[f];
    const float* x = a + (size_t)row * D;
    for (int c = threadIdx.x; c < D; c += kTcThreads) {
      float v = 0.f;
#pragma unroll 16
      for (int k = 0; k < D; ++k)
        v = fmaf(__ldg(x + k), __ldg(w + (size_t)k * D + c), v);
      out[(size_t)row * D + c] = v + b[c];
    }
  }
}

// One GRU round for R nodes: the in-order edge sum of their segments (one
// warp a row, R / 8 rows a warp) into the agg tiles (and agg_bank, when
// given), h into the h tiles, both 3-gate products pass by pass with the
// GRU epilogue of each pass's tiles into h_out; flagged rows in the FFMA
// arithmetic.
template <int D>
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
  using S = Tc<D>;
  constexpr int R = S::R, NV = S::NV, Q = D / 4;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int row_flag[R], flagged[R], n_flagged;
  __shared__ int whole[3 * R], n_whole;
  uint8_t* agg_big = align1024(smem_raw);
  uint8_t* agg_small = agg_big + S::TileBytes;
  uint8_t* h_big = agg_small + S::TileBytes;
  uint8_t* h_small = h_big + S::TileBytes;
  uint8_t* ring = h_small + S::TileBytes;  // at 128; else the FFMA lane's
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kWStage);
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (D == 128 && tid == 0) ring_start(ring, full, xw, hw);
  read_flags<R>(flags, row0, n, row_flag, flagged, &n_flagged);
  load_split<R, D>(h, D, 0, row0, n, h_big, h_small, row_flag);
  if (tid == 0) n_whole = 0;
  __syncthreads();
  const int bnd = bounds(row_ptr, row0, n, warp, lane);
  for (int i = 0; i < R / 8; ++i) {
    const int rr = warp + 8 * i, row = row0 + rr;
    const int beg = __shfl_sync(0xffffffffu, bnd, i);
    const int end = __shfl_sync(0xffffffffu, bnd, 8 + i);
    int src;
    float4 v[NV];
    segment_sum<D>(msg, senders, heads, beg, end, lane, v, &src);
    if (src >= 0) {  // one long run: summed below by the whole block
      if (lane == 0) {
        const int at = atomicAdd(&n_whole, 1);
        whole[3 * at] = rr;
        whole[3 * at + 1] = src;
        whole[3 * at + 2] = end - beg;
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int q = lane + 32 * c;
      if (q >= Q) continue;
      put_agg4(agg_big, agg_small, xt_off<R>(rr, 4 * q), v[c], row_flag[rr]);
      if (agg_bank != nullptr && row < n)
        *reinterpret_cast<float4*>(agg_bank + (size_t)row * D + 4 * q) = v[c];
    }
  }
  __syncthreads();
  whole_run_sum<D>(msg, whole, n_whole, row0, n, row_flag, agg_big,
                   agg_small, agg_bank);
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7;
#pragma unroll 1
  for (int p = 0; p < S::P; ++p) {
    GateSums<R / 2> s;
    gate_pass_tc<D>(agg_big, agg_small, h_big, h_small, ring, full, xw, hw,
                    p, s);
    const int mt = 2 * p + wg;
    const int m = 64 * mt + tile_m();
    if (mt >= S::T || m >= D) continue;  // uniform per warp
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = m + 8 * hh;
      float hv[R / 4];
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + tile_row(j, e);
          hv[2 * j + e] = row < n ? __ldg(h + (size_t)row * D + col) : 0.f;
        }
      const float br = xb[col] + hb[col], bz = xb[D + col] + hb[D + col];
      const float bxn = xb[2 * D + col], chn = hb[2 * D + col];
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = tile_row(j, e), row = row0 + r;
          if (row >= n || row_flag[r]) continue;
          const int i = 4 * j + 2 * hh + e;
          const float rg = sigmoid_fast(s.r[i] + br);
          const float zg = sigmoid_fast(s.z[i] + bz);
          const float ng = tanh_fast(s.xn[i] + bxn + rg * (s.hn[i] + chn));
          h_out[(size_t)row * D + col] = (1.f - zg) * ng + zg * hv[2 * j + e];
        }
    }
  }

  // flagged rows: the FFMA variant's gate products (fmaf over K in order)
  // and gru_cell, in the ring's space at 128 (every stage has been read)
  float* sums = reinterpret_cast<float*>(ring);  // [6D]: [ax | ah]
  float* h_row = sums + 6 * D;                   // [D]
  float* a_row = h_row + D;                      // [D]
  constexpr int NO = (6 * D + kTcThreads - 1) / kTcThreads;
  for (int f = 0; f < n_flagged; ++f) {
    const int rr = flagged[f], row = row0 + rr;
    __syncthreads();
    for (int c = tid; c < D; c += kTcThreads) {
      h_row[c] = h[(size_t)row * D + c];
      a_row[c] = agg_exact<R>(agg_big, rr, c);
    }
    __syncthreads();
    // thread t sums outputs t + 256 c of [ax | ah], the chains side by
    // side and K unrolled, so the weight loads overlap
    const float* v[NO];
    const float* wt[NO];
    float acc[NO];
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const int o = min(tid + kTcThreads * c, 6 * D - 1);
      const bool x_side = o < 3 * D;
      v[c] = x_side ? a_row : h_row;
      wt[c] = x_side ? xw + o : hw + (o - 3 * D);
      acc[c] = 0.f;
    }
#pragma unroll 16
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int c = 0; c < NO; ++c)
        acc[c] = fmaf(v[c][k], __ldg(wt[c] + (size_t)k * 3 * D), acc[c]);
#pragma unroll
    for (int c = 0; c < NO; ++c)
      if (tid + kTcThreads * c < 6 * D) sums[tid + kTcThreads * c] = acc[c];
    __syncthreads();
    const float* ax = sums;
    const float* ah = sums + 3 * D;
    for (int c = tid; c < D; c += kTcThreads)
      h_out[(size_t)row * D + c] =
          gru_cell(ax[c], ax[D + c], ax[2 * D + c], ah[c], ah[D + c],
                   ah[2 * D + c], xb, hb, c, D, h_row[c]);
  }
}

// ------------------------------------------------ host side

// f(std::integral_constant<int, D>()) for the width d that has an
// instance; cudaErrorInvalidValue for any other.
template <typename F>
int with_width(int d, F&& f) {
  switch (d) {
    case 128: return f(std::integral_constant<int, 128>());
    case 192: return f(std::integral_constant<int, 192>());
    case 224: return f(std::integral_constant<int, 224>());
    case 288: return f(std::integral_constant<int, 288>());
    default: return (int)cudaErrorInvalidValue;
  }
}

static_assert(round_tc_smem<288>() <= 227 * 1024, "round at 288");
static_assert(round_tc_smem<224>() <= 227 * 1024, "round at 224");
static_assert(round_tc_smem<192>() <= 227 * 1024, "round at 192");
static_assert(round_tc_smem<128>() <= 227 * 1024, "round at 128");

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

template <int D>
int launch_tc_linear(const float* a, const float* w, const float* b,
                     const int* row_ptr, const int* senders,
                     const uint32_t* heads, int* flags, float* out, int n,
                     cudaStream_t stream) {
  constexpr int R = Tc<D>::R, smem = linear_tc_smem<D>();
  static bool sized = false;
  const cudaError_t err = allow_smem_once(linear_tc_kernel<D>, smem, sized);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  linear_tc_kernel<D><<<(n + R - 1) / R, kTcThreads, smem, stream>>>(
      a, w, b, row_ptr, senders, heads, flags, out, n);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc_round(const float* h, const float* msg, const int* row_ptr,
                    const int* senders, const uint32_t* heads,
                    const int* flags, const float* xw, const float* xb,
                    const float* hw, const float* hb, float* h_out,
                    float* agg_bank, int n, cudaStream_t stream) {
  constexpr int R = Tc<D>::R, smem = round_tc_smem<D>();
  static bool sized = false;
  const cudaError_t err = allow_smem_once(gru_round_tc_kernel<D>, smem,
                                          sized);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  gru_round_tc_kernel<D><<<(n + R - 1) / R, kTcThreads, smem, stream>>>(
      h, msg, row_ptr, senders, heads, flags, xw, xb, hw, hb, h_out,
      agg_bank, n);
  return (int)cudaGetLastError();
}

// The entries of the widths with an instance (with_width)
int tc_prep(int d, const int* keys, const int* idx, int n_edges, int n_nodes,
            int* row_ptr, uint32_t* heads, cudaStream_t stream) {
  return with_width(d, [&](auto) {
    return launch_tc_prep(keys, idx, n_edges, n_nodes, row_ptr, heads,
                          stream);
  });
}

int tc_linear(int d, const float* a, const float* w, const float* b,
              const int* row_ptr, const int* senders, const uint32_t* heads,
              int* flags, float* out, int n, cudaStream_t stream) {
  return with_width(d, [&](auto width) {
    return launch_tc_linear<decltype(width)::value>(
        a, w, b, row_ptr, senders, heads, flags, out, n, stream);
  });
}

int tc_round(int d, const float* h, const float* msg, const int* row_ptr,
             const int* senders, const uint32_t* heads, const int* flags,
             const float* xw, const float* xb, const float* hw,
             const float* hb, float* h_out, float* agg_bank, int n,
             cudaStream_t stream) {
  return with_width(d, [&](auto width) {
    return launch_tc_round<decltype(width)::value>(
        h, msg, row_ptr, senders, heads, flags, xw, xb, hw, hb, h_out,
        agg_bank, n, stream);
  });
}

}  // namespace
