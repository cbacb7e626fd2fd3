// int8-weight matrix product for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` of deepdfa_tpu/ops/int8_matmul.py
// (launched by `_int8_matmul`, public `int8_matmul`). It computes
//     y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
// with x float32 or bf16, q int8 (symmetric per-output-channel weights),
// scale float32 and y float32 or bf16: the per-column scale distributes out
// of the contraction, so it is applied once per output, in the epilogue, to
// the float32 sum, which is rounded to the output type once.
//
// The arithmetic lets the tensor cores take the product with no loss: every
// int8 weight is exact in bf16, and a bf16 x bf16 product is exact in the
// float32 accumulator. A float32 activation is exactly the sum of three bf16
// terms, x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), for
// 2^-100 <= |x| <= 2^100 (below, bf16 subnormals drop bits; near float32's
// largest, bf16(x) rounds to inf), so x @ q = x0 @ q + x1 @ q + x2 @ q with
// every product exact: only the order of the float32 sums differs from the
// plain version's. (The three-term bf16 split was taken over a two-term TF32
// one: it keeps both kernels on the bf16 instruction and the converted tile.)
//
// What bounds it on this card. The LLM's projections (M = 1024 tokens, K and
// N 4096 to 13824, bf16 activations) do 2*M = 2048 FLOPs per weight byte,
// far above the bf16 tensor-core ridge of 989e12 / 3.35e12 = 295: bound by
// tensor-core operations (0.093 ms at 1024 x 4096 x 11008). The GGNN's conv
// products (K = 128, N = 128 or 384, M = the padded node count, float32)
// move 4*M*(K + N) bytes for 3 * 2*M*K*N tensor-core FLOPs: bound by bytes.
// Decode (M = the batch, a few tokens; the 7B's 225 projections a step) does
// 2*M FLOPs per weight byte, far below the ridge: bound by the int8 weight's
// bytes, 5.0 us at 4096 x 4096 and 39 us at lm_head's 4096 x 32016. Each
// weight is read once a step, so it comes from HBM, not from L2.
//
// What the design does about that.
// - `int8_matmul_wgmma_bf16` (bf16 activations) computes y^T = q^T x^T:
//   the int8 weight is `wgmma`'s A operand, converted to bf16 in registers,
//   and x is its B operand in shared memory (design (b), the swap of
//   operands). A block of three warpgroups owns 128 weight columns by 256
//   tokens and loops over K in 64-deep steps. One producer thread fills a
//   ring of four shared-memory stages by TMA (the x tile and the int8 q
//   tile, both 128-byte swizzled), with a `full` mbarrier per stage for the
//   bytes and an `empty` one for the two consumer warpgroups' release. Each
//   consumer warpgroup owns 64 weight columns and runs one m64n256k16
//   `wgmma` per 16 of K with float32 sums in registers (128 a thread); while
//   it runs, the warpgroup loads the next step's int8 fragment (one 16-bit
//   load per K row) and converts it with integer byte moves and one bf16x2
//   subtraction per two weights, no int-to-float instruction. The scale and
//   the one rounding to bf16 come in the epilogue, which undoes the
//   fragment's column permutation.
//   Design (a), the q tile converted into a bf16 tile in shared memory and
//   read as B, came first. On the card its load-and-convert pipeline alone,
//   with the `wgmma`s taken out, was slower than cuBLAS's whole bf16
//   product at 1024 x 4096 x 11008: the converter set the pace, and its
//   shared-memory round trip per weight went with it. The producer
//   warpgroup drops to 40 registers and the consumers rise to 232
//   (`setmaxnreg`): without it the kernel ran slower. A persistent grid,
//   and wgmmas committed two to a group, each ran slower too.
// - `int8_matmul_wgmma_f32` (float32 activations): one warpgroup owns a
//   64 x 128 tile; each thread loads its float32 A fragment from device
//   memory, splits it into three bf16 fragments and issues three m64n128k16
//   `wgmma`s with A from registers against one q tile, converted to bf16 in
//   shared memory (transposed into the K-major swizzled layout B is read
//   in): at these shapes the bytes bound it, and the conversion is cheap.
// - `int8_matmul_ffma` (the second variant): for operands TMA cannot
//   describe (a global stride that is not a multiple of 16 bytes, an address
//   that is not 16-byte aligned), the earlier kernel: one block of 256
//   threads owns a 64 x 128 tile, dequantizes q in registers on its way into
//   shared memory and sums with FFMA. The wrapper chooses by a rule in
//   Python (deepdfa_tpu_torch/ops/int8_matmul.py `variant`).
// - `int8_matmul_gemv` (the third variant, bf16 activations at decode, M up
//   to GEMV_MAX_M of the wrapper): the `wgmma` kernel gave these shapes one
//   block per 128 weight columns (32 of 132 SMs at N 4096), ~32 KB of
//   weight in flight per busy SM, a 256-row x box that carries 4 real rows,
//   and two tensor maps encoded on the host per call. The gemv kernel
//   splits K as well as N: a block of 8 warps owns 128 weight columns and
//   a K range, and the K splits of a column tile form one cluster, as many
//   as keep every cluster resident, so the grid is one wave (7 at 4096 x
//   4096: 224 blocks, 1.7 an SM; 2 at 4096 x 11008: 172 blocks, 1.3 an
//   SM). That is fewer than the 2 blocks an SM aimed for: more splits
//   than fit at once make a second wave, and 8 splits forced ran slower
//   (below). Each lane loads its weights straight from device memory in
//   16-byte loads that allocate no L1 line, two k16 steps (128 bytes)
//   issued before either is used, converts them in registers
//   as the `wgmma` kernel does (with the masks in registers, four
//   instructions a pair: from immediates the compiler split each mask-or
//   into two), and runs `mma.sync.m16n8k16` with the weight as A and the
//   tokens as B (n = 8; two or four tiles past 8 tokens, groups of 32 past
//   32); x comes in plain 8-byte loads, so nothing is encoded on the host.
//   The K splits are summed in split order through distributed shared
//   memory, each block of the cluster finishing a share of the outputs: no
//   workspace in device memory, no counter and no atomic, so a captured
//   call replays as it ran. On the card the kernel ran in about the time
//   of the same grid doing its loads alone, and slower before the masks
//   went to registers; what is left is how fast these 16-byte loads stream
//   (TMA copies into a ring are the next design to try). Tried and
//   dropped, each slower on the card: a ring of `cp.async` stages in
//   shared memory (no register holding bytes in flight), four and three
//   k16 steps a pass instead of two, double-buffered passes, an L2
//   prefetch hint of 128 or 256 bytes on the loads, and 8 splits forced
//   where fewer clusters are resident (a second wave).
// Every sum runs in a fixed order (the gemv variant's split-K too: warp by
// warp, then split by split), so two calls on the same inputs are bitwise
// equal; there are no atomics. Ragged edges are masked in the kernels or
// zero-filled by TMA; nothing is padded in memory.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

// ------------------------------------------------ the FFMA variant

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 32;        // K depth staged per shared-memory pass
constexpr int kTM = 4;         // rows per thread: ty * 4 + i
// columns per thread: tx * 4 + j and 64 + tx * 4 + j for j < 4, so a
// half-warp's float4 reads of a weight row are contiguous

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
int8_matmul_ffma(const TX* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, TY* __restrict__ y,
                 int m, int k, int n) {
  __shared__ float xs[kBM][kBK + 1];          // x tile, padded rows
  __shared__ __align__(16) float ws[kBK][kBN];  // dequantized q tile
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x tile: a warp reads one row's 32 consecutive K values
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int row = row0 + r, kk = k0 + c;
      xs[r][c] = (row < m && kk < k) ? to_f32(x[(size_t)row * k + kk]) : 0.f;
    }
    // q tile: int8 from global memory, consecutive threads on consecutive
    // columns, converted to float32 in registers
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i - r * kBN;
      const int kk = k0 + r, col = col0 + c;
      ws[r][c] = (kk < k && col < n) ? (float)q[(size_t)kk * n + col] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kBK, k - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[ty * kTM + i][kk];
      const float4 lo = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 hi = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the per-column scale, once per output
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < n) store(&y[(size_t)row * n + col], acc[i][j] * scale[col]);
    }
  }
}


template <typename TX, typename TY>
int launch_ffma(const TX* x, const int8_t* q, const float* scale, TY* y,
                int m, int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int8_matmul_ffma<TX, TY><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, q, scale, y, m, k, n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ tensor-core helpers

// Two int8 weights as a bf16 pair: the byte of word a that `sel` picks into
// byte 0 (the low half) and the byte of word b it picks into byte 2. With
// b the byte of v, 0x4300 | (b & 0x7F) is the bf16 128 + (v mod 128) and
// 0x4300 | (b & 0x80) is 128, or 256 where v < 0: their difference is v,
// exact (integer operations and one bf16x2 subtraction, no int-to-float).
__device__ __forceinline__ uint32_t i8_pair_to_bf16x2(uint32_t a, uint32_t b,
                                                      uint32_t sel) {
  const uint32_t t = __byte_perm(a, b, sel);
  const uint32_t hi = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t lo = (t & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(hi), "r"(lo));
  return r;
}

// Converts a block of int8 weights, 8 K rows by 4 N columns (word kk holds
// q[k0 + kk][n0 .. n0 + 3]), to bf16 and stores it transposed into a
// K-major 128-byte-swizzled B tile (row n: 64 K values, 16-byte chunk kq of
// the 8 values k0 .. k0 + 7 at chunk position kq ^ (n % 8)). Neighbouring
// lanes hold neighbouring column groups; each lane stores its four columns
// in a rotated order, so the eight lanes of a 16-byte store phase hit eight
// distinct chunk positions (no bank conflict).
__device__ __forceinline__ void convert_store(const uint32_t (&w)[8],
                                              uint8_t* tile, int n0, int kq,
                                              int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jj = (j + (lane >> 1)) & 3;
    const uint32_t sel = jj | ((4 + jj) << 8);  // byte jj of two K rows
    uint32_t out[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      out[p] = i8_pair_to_bf16x2(w[2 * p], w[2 * p + 1], sel);
    const int nn = n0 + jj;
    *reinterpret_cast<uint4*>(tile + nn * 128 + ((kq ^ (nn & 7)) << 4)) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogue of a warpgroup's m64 x (8 * G) tile of sums: sum d[4i + 2h
// + e] is row 16 * warp + lane / 4 + 8h, column 8i + 2 * (lane % 4) + e.
// Each pair is scaled per column and rounded to the output type once. n is
// even, so a pair lies wholly inside or outside the output.
template <int G, typename TY>
__device__ __forceinline__ void store_tile(const float (&d)[4 * G],
                                           const float* __restrict__ scale,
                                           TY* __restrict__ y, int row0,
                                           int col0, int m, int n) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int c = col0 + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int col = c + 8 * i;
    if (col >= n) continue;
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < m)
        store2(y + (size_t)row * n + col, d[4 * i + 2 * h] * s0,
               d[4 * i + 2 * h + 1] * s1);
    }
  }
}

// ------------------------------------------------ bf16 activations

constexpr int kTcBN = 128;  // weight columns per block: 64 a warpgroup
constexpr int kTcBM = 256;  // tokens (rows of x) per block: wgmma's n
constexpr int kTcBK = 64;   // K depth per stage: 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kXBytes = kTcBM * kTcBK * 2;  // bf16 x tile, swizzled
constexpr int kQBytes = kTcBK * kTcBN;      // int8 q tile, swizzled
constexpr int kTcThreads = 384;  // two consumer warpgroups, a producer one
constexpr int kTcSmem = kStages * (kXBytes + kQBytes) + 2 * kStages * 8 + 1024;

// A thread's A fragment of one k16 step: wgmma's register layout puts rows
// g and g + 8 of a warp's 16, K columns 2t, 2t + 1 and 2t + 8, 2t + 9, in
// a[0..3]. Fragment row g is weight column 2g of the warp's 16 and row g + 8
// is column 2g + 1 (a permutation the epilogue undoes), so each K row gives
// one 16-bit load of two neighbouring weights. The q tile's rows are 128
// bytes, 128-byte swizzled: chunk c of row r lies at c ^ (r % 8), so the four
// rows a warp reads at once fall in distinct banks.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* qs,
                                       int k16, int chunk, int g, int t) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * k16 + 2 * t + (i & 1) + 8 * (i >> 1);
    h[i] = *reinterpret_cast<const uint16_t*>(
        qs + r * 128 + ((chunk ^ (r & 7)) << 4) + 2 * g);
  }
  a[0] = i8_pair_to_bf16x2(h[0], h[1], 0x0400);  // row g: k 2t, 2t + 1
  a[1] = i8_pair_to_bf16x2(h[0], h[1], 0x0501);  // row g + 8
  a[2] = i8_pair_to_bf16x2(h[2], h[3], 0x0400);  // row g: k 2t + 8, 2t + 9
  a[3] = i8_pair_to_bf16x2(h[2], h[3], 0x0501);  // row g + 8
}

struct TcTiles {
  uint8_t* xs;
  uint8_t* qs;
  uint64_t* full;
  uint64_t* empty;
  int nk, chunk, g, t;
};

// One k16 step j = 4 kt + k16 of a consumer warpgroup: the wgmma of its A
// fragment `cur` against the x tile of stage kt, then, once step j - 1's
// wgmma (which read `nxt`) has finished, step j + 1's fragment into `nxt`
// while this one runs. Four steps a tile keep the buffers' roles fixed.
template <int K16>
__device__ __forceinline__ void tc_step(const TcTiles& tl, int kt,
                                        float (&acc)[128],
                                        uint32_t (&cur)[4],
                                        uint32_t (&nxt)[4]) {
  wgmma_fence();
  wgmma_rs_n256(acc, cur,
                sw128_desc(tl.xs + (kt % kStages) * kXBytes) + 2 * K16);
  wgmma_commit();
  wgmma_wait_one();
  fence_regs(nxt);
  // step j - 1 has finished: at K16 = 0 that was tile kt - 1's last, so
  // that tile is spent in this warpgroup (its x tile read by the wgmmas,
  // its q tile by the fragment loads before them)
  if (K16 == 0 && kt >= 1 && (threadIdx.x & 127) == 0)
    mbar_arrive(&tl.empty[(kt - 1) % kStages]);
  if (K16 < 3) {
    load_a(nxt, tl.qs + (kt % kStages) * kQBytes, K16 + 1, tl.chunk, tl.g,
           tl.t);
  } else if (kt + 1 < tl.nk) {
    const int s1 = (kt + 1) % kStages;
    mbar_wait(&tl.full[s1], ((kt + 1) / kStages) & 1);
    load_a(nxt, tl.qs + s1 * kQBytes, 0, tl.chunk, tl.g, tl.t);
  }
}

template <typename TY>
__global__ void __launch_bounds__(kTcThreads, 1)
int8_matmul_wgmma_bf16(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tq,
                       const float* __restrict__ scale, TY* __restrict__ y,
                       int m, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  TcTiles tl;
  tl.xs = smem;
  tl.qs = tl.xs + kStages * kXBytes;
  tl.full = reinterpret_cast<uint64_t*>(tl.qs + kStages * kQBytes);
  tl.empty = tl.full + kStages;
  tl.nk = (k + kTcBK - 1) / kTcBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tok0 = blockIdx.x * kTcBM;
  const int col0 = blockIdx.y * kTcBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&tl.full[s], 1);
      mbar_init(&tl.empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer warpgroup hands its registers to the consumers (40 + 2 x
    // 232 a thread fill the SM's 64K); one thread keeps the ring full.
    // Stage kt % kStages, K step kt: the x box at (K kt*64, tok0) and the
    // q box at (col0, K kt*64); rows and columns past the tensor's edge
    // arrive as 0
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < tl.nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&tl.empty[s], (kt / kStages - 1) & 1);
        mbar_expect_tx(&tl.full[s], kXBytes + kQBytes);
        tma_load(tl.xs + s * kXBytes, &tx, &tl.full[s], kt * kTcBK, tok0);
        tma_load(tl.qs + s * kQBytes, &tq, &tl.full[s], col0, kt * kTcBK);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns weight columns col0 + 64 wg .. + 63,
  // warp w of it the 16-byte chunk 4 wg + w of each q row
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;
  tl.chunk = 4 * wg + (warp & 3);
  tl.g = lane >> 2;
  tl.t = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a0[4], a1[4];
  mbar_wait(&tl.full[0], 0);
  load_a(a0, tl.qs, 0, tl.chunk, tl.g, tl.t);
  for (int kt = 0; kt < tl.nk; ++kt) {
    tc_step<0>(tl, kt, acc, a0, a1);
    tc_step<1>(tl, kt, acc, a1, a0);
    tc_step<2>(tl, kt, acc, a0, a1);
    tc_step<3>(tl, kt, acc, a1, a0);
  }
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(a0);
  fence_regs(a1);

  // epilogue: sum 4i + e is fragment row g (weight column c) for e = 0, 1
  // and row g + 8 (column c + 1) for e = 2, 3, at token 8i + 2t + (e & 1);
  // n is even, so the pair c, c + 1 lies wholly inside or outside
  const int c = col0 + 64 * wg + 16 * (warp & 3) + 2 * tl.g;
  if (c >= n) return;
  const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int tok = tok0 + 8 * i + 2 * tl.t;
    if (tok < m)
      store2(y + (size_t)tok * n + c, acc[4 * i] * s0, acc[4 * i + 2] * s1);
    if (tok + 1 < m)
      store2(y + (size_t)(tok + 1) * n + c, acc[4 * i + 1] * s0,
             acc[4 * i + 3] * s1);
  }
}

// ------------------------------------------------ float32 activations

constexpr int kF32BM = 64;   // output rows per block: one warpgroup
constexpr int kF32BN = 128;  // output columns per block: one m64n128
constexpr int kF32BK = 64;   // K depth per converted tile

__global__ void __launch_bounds__(128)
int8_matmul_wgmma_f32(const float* __restrict__ x,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ y,
                      int m, int k, int n) {
  __shared__ __align__(1024) uint8_t bs[kF32BN * kF32BK * 2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kF32BM;
  const int col0 = blockIdx.y * kF32BN;
  // this thread's A fragment rows and first K column (wgmma's register
  // layout: register h holds row g + 8 (h & 1), columns 2t + 8 (h >> 1)
  // and the next)
  const int ra = row0 + (tid >> 5) * 16 + (lane >> 2);
  const int t2 = (lane & 3) * 2;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kF32BK) {
    float2 xa[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int row = ra + 8 * (h & 1);
        const int kk = k0 + 16 * s + t2 + 8 * (h >> 1);
        // k is a multiple of 8, so a pair lies wholly inside or outside
        xa[s][h] = (row < m && kk < k)
            ? __ldg(reinterpret_cast<const float2*>(x + (size_t)row * k + kk))
            : make_float2(0.f, 0.f);
      }
    uint32_t w[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + 128 * i;
      const int col = col0 + (u & 31) * 4;
      const int kq = u >> 5;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int kr = k0 + kq * 8 + kk;
        w[i][kk] = (kr < k && col < n)
            ? __ldg(reinterpret_cast<const unsigned int*>(
                  q + (size_t)kr * n + col))
            : 0u;
      }
    }
    __syncthreads();  // every warp's wgmmas of the last tile have finished
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + 128 * i;
      convert_store(w[i], bs, (u & 31) * 4, u >> 5, lane);
    }
    fence_proxy_async();
    __syncthreads();
    // x = x0 + x1 + x2 exactly, each term bf16
    uint32_t a[4][3][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float2 r = xa[s][h];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const __nv_bfloat162 t = __floats2bfloat162_rn(r.x, r.y);
          a[s][p][h] = *reinterpret_cast<const uint32_t*>(&t);
          const float2 tf = __bfloat1622float2(t);
          r = make_float2(r.x - tf.x, r.y - tf.y);
        }
      }
    const uint64_t db = sw128_desc(bs);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int p = 0; p < 3; ++p) wgmma_rs_n128(acc, a[s][p], db + 2 * s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int p = 0; p < 3; ++p) fence_regs(a[s][p]);
  }
  store_tile<16>(acc, scale, y, row0, col0, m, n);
}

// ------------------------------------------------ bf16 at decode: gemv

constexpr int kGvWarps = 8;  // warps a block, each on its own k16 steps
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvBN = 128;   // weight columns a block: 8 m16 tiles
constexpr int kGvMaxSplits = 8;  // blocks a cluster: the portable limit

// 16 int8 weights of one K row, read once: no L1 line is kept for them
__device__ __forceinline__ uint4 ld_weights(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// i8_pair_to_bf16x2 in four instructions: with both masks and the 0x43
// bytes in registers, each (t & mask) | 0x4300.. is one LOP3 (from
// immediates the compiler splits it into two)
__device__ __forceinline__ uint32_t pair_bf16x2(uint32_t a, uint32_t b,
                                                uint32_t sel, uint32_t low7,
                                                uint32_t sign, uint32_t mag) {
  uint32_t r;
  asm("{\n.reg .b32 t, hi, lo;\n"
      "prmt.b32 t, %1, %2, %3;\n"
      "lop3.b32 hi, t, %4, %6, 0xEA;\n"
      "lop3.b32 lo, t, %5, %6, 0xEA;\n"
      "sub.rn.bf16x2 %0, hi, lo;\n}\n"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(sel), "r"(low7), "r"(sign), "r"(mag));
  return r;
}

// d[0..3] += A (16 x 16, row) * B (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// shared memory: each warp's sums, [warp][token][column], then the block's
template <int NT>
__host__ __device__ constexpr int gemv_smem_bytes() {
  return (kGvWarps + 1) * 8 * NT * kGvBN * 4;
}

// y[tok0 .. tok0 + 8 NT) = x @ q * scale over the block's 128 weight
// columns, the K range of one split: blockIdx.x the column tile, blockIdx.y
// the split (the block's rank in its cluster), blockIdx.z the group of 8 NT
// tokens. Warp w of the block takes k16 steps w, w + 8, ... of its split, U
// a pass: it issues every load of a pass, then converts and multiplies.
//
// mma.m16n8k16 with the weight as A (16 weight columns by 16 of K) and x as
// B (16 of K by 8 tokens). Both permutations are free, so each register
// comes from a wide load: lane (g, t) reads K rows 16s + 4t .. + 3 of
// columns 16g .. 16g + 15 (four 16-byte loads), and tile j's A row g is
// column 16g + 2j, row g + 8 column 16g + 2j + 1; A's K columns 2t, 2t + 1,
// 2t + 8, 2t + 9 are K rows 4t .. 4t + 3, the same for B, whose two
// registers are then one 8-byte load of token g's x at 16s + 4t.
template <int NT, int U, typename TY>
__global__ void __launch_bounds__(kGvThreads, NT <= 2 ? 2 : 1)
int8_matmul_gemv(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q,
                 const float* __restrict__ scale, TY* __restrict__ y, int m,
                 int k, int n, int per_split) {
  constexpr int kPart = 8 * NT * kGvBN;  // floats of a warp's sums
  extern __shared__ float4 gv_smem[];
  float* part = reinterpret_cast<float*>(gv_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kGvBN;
  const int tok0 = (int)blockIdx.z * 8 * NT;
  const int col = n0 + 16 * g;
  const bool col_ok = col < n;  // n % 16 == 0: all 16 columns or none
  const int nsteps = (k + 15) >> 4;
  const int split = (int)blockIdx.y;
  const int s_lo = split * per_split;
  const int s_hi = min(nsteps, s_lo + per_split);

  const __nv_bfloat16* xrow[NT];
  bool x_ok[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int r = tok0 + 8 * i + g;
    x_ok[i] = r < m;
    xrow[i] = x + (size_t)(x_ok[i] ? r : 0) * k;
  }
  const int8_t* qcol = q + (col_ok ? col : 0);

  float acc[NT][8][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  uint32_t low7 = 0x007F007Fu, sign = 0x00800080u, mag = 0x43004300u;
  asm volatile("" : "+r"(low7), "+r"(sign), "+r"(mag));

  for (int s0 = s_lo + warp; s0 < s_hi; s0 += U * kGvWarps) {
    uint4 w[U][4];
    uint2 b[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kr = 16 * (s0 + u * kGvWarps) + 4 * t;
      // k % 8 == 0: rows kr .. kr + 3 lie wholly inside or outside
      const bool ok = s0 + u * kGvWarps < s_hi && kr < k;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[u][i] = ok && col_ok ? ld_weights(qcol + (size_t)(kr + i) * n)
                               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < NT; ++i)
        b[u][i] = ok && x_ok[i]
            ? __ldg(reinterpret_cast<const uint2*>(xrow[i] + kr))
            : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u * kGvWarps >= s_hi) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int wi = j >> 1, lo = 2 * (j & 1);
        const uint32_t sel_g = lo | ((4 + lo) << 8);         // column 2j
        const uint32_t sel_g8 = (lo + 1) | ((5 + lo) << 8);  // column 2j + 1
        const uint32_t k01a = word(w[u][0], wi), k01b = word(w[u][1], wi);
        const uint32_t k23a = word(w[u][2], wi), k23b = word(w[u][3], wi);
        const uint32_t a[4] = {
            pair_bf16x2(k01a, k01b, sel_g, low7, sign, mag),
            pair_bf16x2(k01a, k01b, sel_g8, low7, sign, mag),
            pair_bf16x2(k23a, k23b, sel_g, low7, sign, mag),
            pair_bf16x2(k23a, k23b, sel_g8, low7, sign, mag)};
#pragma unroll
        for (int i = 0; i < NT; ++i) mma_bf16(acc[i][j], a, b[u][i]);
      }
    }
  }

  // sum d[2h + e] of tile j, token tile i is token 8i + 2t + e, column 16g
  // + 2j + h: the lane holds 16 whole columns of two tokens, stored as four
  // 16-byte chunks a token; chunk c of row r sits at c ^ ((r >> 1) & 3), so
  // the 8 lanes of a store phase fill 8 distinct bank groups
  float* mine = part + warp * kPart;
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * i + 2 * t + e;
      float4* row = reinterpret_cast<float4*>(mine + r * kGvBN);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        row[(4 * g + p) ^ t] = make_float4(
            acc[i][2 * p][e], acc[i][2 * p][2 + e], acc[i][2 * p + 1][e],
            acc[i][2 * p + 1][2 + e]);
    }
  __syncthreads();

  // the block's sums, warp by warp in order: [token][32 chunks]
  const int rows = min(8 * NT, m - tok0);
  float4* red = reinterpret_cast<float4*>(part + kGvWarps * kPart);
  for (int it = threadIdx.x; it < rows * (kGvBN / 4); it += kGvThreads) {
    const int r = it / (kGvBN / 4), c = it % (kGvBN / 4);
    const float4* src = reinterpret_cast<const float4*>(part + r * kGvBN)
                        + (c ^ ((r >> 1) & 3));
    float4 sum = src[0];
#pragma unroll
    for (int wp = 1; wp < kGvWarps; ++wp) {
      const float4 v = src[wp * (kPart / 4)];
      sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
    }
    red[it] = sum;
  }

  // the cluster's splits, summed in split order through distributed shared
  // memory (one remote load of each split in flight at once); the blocks
  // of the cluster take the outputs in turn
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int it = threadIdx.x * splits + rank; it < rows * (kGvBN / 4);
       it += kGvThreads * splits) {
    const int r = it / (kGvBN / 4), c = n0 + 4 * (it % (kGvBN / 4));
    if (c >= n) continue;  // n % 16 == 0: all 4 columns or none
    float4 v[kGvMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kGvMaxSplits; ++sp)
      if (sp < splits) v[sp] = cluster.map_shared_rank(red, sp)[it];
    float4 sum = v[0];
#pragma unroll
    for (int sp = 1; sp < kGvMaxSplits; ++sp)
      if (sp < splits)
        sum = make_float4(sum.x + v[sp].x, sum.y + v[sp].y, sum.z + v[sp].z,
                          sum.w + v[sp].w);
    TY* out = y + (size_t)(tok0 + r) * n + c;
    store2(out, sum.x * scale[c], sum.y * scale[c + 1]);
    store2(out + 2, sum.z * scale[c + 2], sum.w * scale[c + 3]);
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// ------------------------------------------------ host side

template <typename TY>
int launch_wgmma_bf16(const void* x, const int8_t* q, const float* scale,
                      TY* y, int m, int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8 || n % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kTcBM - 1) / kTcBM, (n + kTcBN - 1) / kTcBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tq;
  int code = encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, kTcBM,
                    kTcBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (code) return code;
  code = encode(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, k, n, kTcBK, kTcBN,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (code) return code;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_wgmma_bf16<TY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  int8_matmul_wgmma_bf16<TY>
      <<<grid, kTcThreads, kTcSmem, (cudaStream_t)stream>>>(tx, tq, scale, y,
                                                             m, k, n);
  return (int)cudaGetLastError();
}

// The gemv variant's grid at 8 NT tokens a block: ceil(n / 128) column
// tiles by `splits` K splits by token groups, the splits of a column tile
// one cluster. It takes the most splits (at most 8) at which every cluster
// is resident at once, so the grid is one wave that fills the card.
template <int NT, int U, typename TY>
int launch_gemv_nt(const __nv_bfloat16* x, const int8_t* q,
                   const float* scale, TY* y, int m, int k, int n,
                   void* stream) {
  const auto kernel = int8_matmul_gemv<NT, U, TY>;
  const int smem = gemv_smem_bytes<NT>();
  // clusters of s blocks the card holds at once (-1: none), found once
  static int fits[kGvMaxSplits + 1] = {};
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kGvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  const int tiles = (n + kGvBN - 1) / kGvBN;
  const int groups = (m + 8 * NT - 1) / (8 * NT);
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const int nsteps = (k + 15) / 16;
  int splits = std::max(1, std::min(kGvMaxSplits, nsteps / kGvWarps));
  for (; splits > 1; --splits) {
    if (fits[splits] == 0) {
      attr[0].val.clusterDim.y = splits;
      cfg.gridDim = dim3(1, splits, 1);
      int got = 0;
      const cudaError_t err =
          cudaOccupancyMaxActiveClusters(&got, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      fits[splits] = got > 0 ? got : -1;
    }
    if ((long)tiles * groups <= fits[splits]) break;
  }
  const int per_split = (nsteps + splits - 1) / splits;
  splits = (nsteps + per_split - 1) / per_split;
  attr[0].val.clusterDim.y = splits;
  cfg.gridDim = dim3(tiles, splits, groups);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, q, scale, y, m,
                                             k, n, per_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// up to 8 tokens on one m16n8 B tile, 16 on two; more in groups of 32
template <typename TY>
int launch_gemv(const void* x, const int8_t* q, const float* scale, TY* y,
                int m, int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8 || n % 16) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (m <= 8) return launch_gemv_nt<1, 2>(xb, q, scale, y, m, k, n, stream);
  if (m <= 16) return launch_gemv_nt<2, 2>(xb, q, scale, y, m, k, n, stream);
  return launch_gemv_nt<4, 2>(xb, q, scale, y, m, k, n, stream);
}

int launch_wgmma_f32(const float* x, const int8_t* q, const float* scale,
                     float* y, int m, int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k % 8 || n % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kF32BM - 1) / kF32BM, (n + kF32BN - 1) / kF32BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int8_matmul_wgmma_f32<<<grid, 128, 0, (cudaStream_t)stream>>>(
      x, q, scale, y, m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` and returns cudaGetLastError() as
// an int (0 when the launch was accepted), or a code of its own that
// i8_error_string names. None launches for an empty output.

// The FFMA variant, float32 activations and output.
int i8_matmul(const float* x, const int8_t* q, const float* scale, float* y,
              int m, int k, int n, void* stream) {
  return launch_ffma(x, q, scale, y, m, k, n, stream);
}

// The FFMA variant with bf16 activations; `y` is bf16 when `out_bf16` is
// non-zero, float32 otherwise.
int i8_matmul_bf16(const void* x, const int8_t* q, const float* scale,
                   void* y, int m, int k, int n, int out_bf16, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (out_bf16)
    return launch_ffma(xb, q, scale, static_cast<__nv_bfloat16*>(y), m, k, n,
                       stream);
  return launch_ffma(xb, q, scale, static_cast<float*>(y), m, k, n, stream);
}

// The tensor-core variant, float32 activations and output: k a multiple of
// 8, n of 16, x 8-byte and q 4-byte aligned.
int i8_matmul_tc(const float* x, const int8_t* q, const float* scale,
                 float* y, int m, int k, int n, void* stream) {
  return launch_wgmma_f32(x, q, scale, y, m, k, n, stream);
}

// The tensor-core variant with bf16 activations (TMA: k a multiple of 8, n
// of 16, x and q 16-byte aligned); `y` as for i8_matmul_bf16.
int i8_matmul_tc_bf16(const void* x, const int8_t* q, const float* scale,
                      void* y, int m, int k, int n, int out_bf16,
                      void* stream) {
  if (out_bf16)
    return launch_wgmma_bf16(x, q, scale, static_cast<__nv_bfloat16*>(y), m,
                             k, n, stream);
  return launch_wgmma_bf16(x, q, scale, static_cast<float*>(y), m, k, n,
                           stream);
}

// The gemv variant, bf16 activations at decode (a few tokens: k a multiple
// of 8, n of 16, x and q 16-byte aligned); `y` as for i8_matmul_bf16.
int i8_matmul_gemv_bf16(const void* x, const int8_t* q, const float* scale,
                        void* y, int m, int k, int n, int out_bf16,
                        void* stream) {
  if (out_bf16)
    return launch_gemv(x, q, scale, static_cast<__nv_bfloat16*>(y), m, k, n,
                       stream);
  return launch_gemv(x, q, scale, static_cast<float*>(y), m, k, n, stream);
}

const char* i8_error_string(int code) { return hopper_error_string(code); }

}  // extern "C"
