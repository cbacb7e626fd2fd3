// Causal, segment-masked softmax attention (forward) for NVIDIA Hopper, sm_90a.
//
// Replaces the stock Pallas TPU flash-attention kernel that
// deepdfa_tpu/llm/llama.py:222 `_flash_attention` calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py:758, body
// `_flash_attention_kernel_single_batch`, :342-481). For q [b, s, h, d] and
// k, v [b, s, h_kv, d] (grouped-query heads: query head i reads kv head
// i / (h / h_kv), nothing is repeated in memory) it computes
//     s_ij = (q_i . k_j) * d^-0.5          summed in float32
//     s_ij masked out unless seg_i == seg_j and (j <= i when causal)
//     o_i  = sum_j P_ij v_j / sum_j p_ij,  p_ij = exp(s_ij - m_i)
// with an online softmax in float32 over key tiles (64 keys, or 128 in
// base-2 units on `wgmma`, the logsumexp converted back to natural log on
// the way out; m_i is then a running maximum over 128 keys), P rounded to v's
// type before the product P.V (the TPU kernel's `p.astype(v.dtype)`), the
// product summed in float32 and o written in q's type. The segment ids are
// 1 for real tokens and 0 for padding, so a padding query row attends to the
// padding keys at or before it, as on the TPU. A masked entry adds exactly 0.
// When asked (a gradient will be taken), it also writes each row's
// logsumexp m + log(l) in float32, the residual that the backward
// (flash_attention_bwd.cu) recomputes P from.
//
// What bounds it on this card. At the LLM's shapes (d = 128, s 256-2048)
// causal attention does 4*b*h*d*s*(s+1)/2 FLOPs against 2*4*b*h*s*d bytes
// of q, k, v and o: at s = 256 that is 64 FLOPs per byte, far below the
// bf16 tensor-core ridge of 989e12 / 3.35e12 = 295, and it grows with s to
// 512 at s = 2048. So short sequences are bound by bytes and long ones by
// tensor-core operations; the scores never leave the chip.
//
// What the design does about that. The TPU kernel walked a sequential grid
// over key blocks with the running max, sum and accumulator in scratch.
// Here a block owns a tile of query rows of one (batch, head) and loops
// over the key tiles itself; tiles wholly above the diagonal are skipped.
// Three variants, chosen in Python (deepdfa_tpu_torch/ops/flash_attention.py
// `variant`) from the shapes, the type and the addresses:
// - `flash_wgmma_kernel` (bf16, d = 128, s a multiple of 128: every shape
//   of the LLM tier): 128 query rows a block, TMA loads of 128-byte-swizzled
//   tiles into a three-stage ring, Hopper's `wgmma` with S = Q K^T read
//   from shared memory and P rounded to bf16 in registers as the A operand
//   of O += P V, V read transposed from the same tile (below);
// - `flash_bf16_kernel` (variant "mma", the other bf16 head widths) and
//   `flash_f32_kernel` (variant "ffma", float32), described next.
// In the "mma" variant one block of 4 warps owns 64 query rows. Each warp
// owns 16 of them: its Q fragments stay in registers,
// Q.K^T and P.V run on `mma.sync.m16n8k16` bf16 tensor-core instructions
// with float32 accumulators, and the score fragments become the A operand
// of P.V in registers (the layouts match), so P never touches shared
// memory. K is staged row-major and V transposed in shared memory, so every
// B fragment is one 32-bit shared load. Float32 inputs (the test-size
// model) take a separate FFMA kernel of the same structure: four threads per
// query row, P through shared memory. Every sum runs in a fixed order, so two
// calls on the same inputs are bitwise equal, in every variant.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per shared-memory tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // [b, s] segment ids, or null: one segment
  void* o;
  float* lse;  // [b, h, s] row logsumexp for the backward, or null
  int b, s, h, h_kv;
  float scale;
  int causal;
};

__device__ __forceinline__ int seg_at(const Params& p, int bi, int t) {
  return p.seg ? p.seg[(size_t)bi * p.s + t] : 1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..3] += A (16 x 16, row) * B (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr int bf16_smem_bytes() {
  // Q and K tiles row-major, V transposed, each row padded by 8 values so
  // the fragment loads of a warp fall in distinct banks; key segment ids
  return (2 * kBQ * (D + 8) + D * (kBK + 8)) * 2 + kBK * 4;
}

// ---------------------------------------------------------------- bf16

template <int D>
__global__ void __launch_bounds__(128) flash_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDQ = D + 8;
  constexpr int LDV = kBK + 8;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBQ * LDQ;
  __nv_bfloat16* vt = ks + kBK * LDQ;
  int* segk = reinterpret_cast<int*>(vt + D * LDV);

  const int q0 = blockIdx.x * kBQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.h_kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)p.h * D;     // between tokens
  const size_t kv_stride = (size_t)p.h_kv * D;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q)
      + (size_t)bi * p.s * q_stride + (size_t)hi * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k)
      + (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v)
      + (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o)
      + (size_t)bi * p.s * q_stride + (size_t)hi * D;

  for (int i = tid; i < kBQ * CH; i += 128) {
    const int r = i / CH, c = i - r * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.s)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_stride + c * 8);
    *reinterpret_cast<uint4*>(qs + r * LDQ + c * 8) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, kept in registers
  const int ra = warp * 16 + g;  // tile rows ra and ra + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t * 2;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(qs + ra * LDQ + c);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(qs + (ra + 8) * LDQ + c);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(qs + ra * LDQ + c + 8);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(qs + (ra + 8) * LDQ + c + 8);
  }
  const int row_a = q0 + ra, row_b = row_a + 8;
  const int seg_a = row_a < p.s ? seg_at(p, bi, row_a) : -2;
  const int seg_b = row_b < p.s ? seg_at(p, bi, row_b) : -2;

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int kv_end = p.causal ? min(p.s, q0 + kBQ) : p.s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * CH; i += 128) {  // K: a row per 16 threads
      const int r = i / CH, c = i - r * CH;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + r < p.s)
        val = *reinterpret_cast<const uint4*>(kb + (size_t)(kv0 + r) * kv_stride + c * 8);
      *reinterpret_cast<uint4*>(ks + r * LDQ + c * 8) = val;
    }
    for (int i = tid; i < kBK * CH; i += 128) {  // V transposed: a column per thread
      const int r = i % kBK, c = i / kBK;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + r < p.s)
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(kv0 + r) * kv_stride + c * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c * 8 + j) * LDV + r] = e[j];
    }
    for (int i = tid; i < kBK; i += 128)
      segk[i] = kv0 + i < p.s ? seg_at(p, bi, kv0 + i) : -1;
    __syncthreads();

    // scores: rows (ra, ra + 8) x columns nb * 8 + t * 2 + {0, 1}
    float sc[kBK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
      const __nv_bfloat16* krow = ks + (nb * 8 + g) * LDQ + t * 2;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_bf16(sc[nb], qf[kc],
                 *reinterpret_cast<const uint32_t*>(krow + kc * 16),
                 *reinterpret_cast<const uint32_t*>(krow + kc * 16 + 8));
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nb * 8 + t * 2 + j;
        const int col = kv0 + c;
        const bool ok_a = segk[c] == seg_a && (!p.causal || col <= row_a);
        const bool ok_b = segk[c] == seg_b && (!p.causal || col <= row_b);
        sc[nb][j] = ok_a ? sc[nb][j] * p.scale : -INFINITY;
        sc[nb][2 + j] = ok_b ? sc[nb][2 + j] * p.scale : -INFINITY;
        mx_a = fmaxf(mx_a, sc[nb][j]);
        mx_b = fmaxf(mx_b, sc[nb][2 + j]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row with no unmasked key yet keeps a base of 0: exp(-inf) = 0
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = expf(m_a - base_a), alpha_b = expf(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;

    // P in float32 for the row sums, rounded to bf16 as the A operand
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
      const float p0 = expf(sc[nb][0] - base_a), p1 = expf(sc[nb][1] - base_a);
      const float p2 = expf(sc[nb][2] - base_b), p3 = expf(sc[nb][3] - base_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      pf[nb / 2][(nb % 2) * 2] = pack_bf16(p0, p1);
      pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * alpha_a + quad_sum(sum_a);
    l_b = l_b * alpha_b + quad_sum(sum_b);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha_a;
      acc[nd][1] *= alpha_a;
      acc[nd][2] *= alpha_b;
      acc[nd][3] *= alpha_b;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vrow = vt + (nd * 8 + g) * LDV + kk * 16 + t * 2;
        mma_bf16(acc[nd], pf[kk], *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t * 2;
    if (row_a < p.s)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * q_stride + c) =
          pack_bf16(l_a > 0.f ? acc[nd][0] / l_a : 0.f,
                    l_a > 0.f ? acc[nd][1] / l_a : 0.f);
    if (row_b < p.s)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * q_stride + c) =
          pack_bf16(l_b > 0.f ? acc[nd][2] / l_b : 0.f,
                    l_b > 0.f ? acc[nd][3] / l_b : 0.f);
  }
  // m + log(l) of the row, from the four threads that share it (t == 0)
  if (p.lse && t == 0) {
    float* lb = p.lse + ((size_t)bi * p.h + hi) * p.s;
    if (row_a < p.s) lb[row_a] = m_a + logf(l_a);
    if (row_b < p.s) lb[row_b] = m_b + logf(l_b);
  }
}

// ------------------------------------------------------------- float32

template <int D>
constexpr int f32_smem_bytes() {
  // Q and K tiles padded to D + 1 (conflict-free column walks), V, P, segs
  return (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1)) * 4 + kBK * 4;
}

template <int D>
__global__ void __launch_bounds__(256) flash_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + 1;
  constexpr int LDP = kBK + 1;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * D;
  int* segk = reinterpret_cast<int*>(ps + kBQ * LDP);

  const int q0 = blockIdx.x * kBQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.h_kv);
  const int tid = threadIdx.x;
  const int row = tid >> 2, part = tid & 3;  // four threads per query row
  const int qrow = q0 + row;
  const size_t q_stride = (size_t)p.h * D;
  const size_t kv_stride = (size_t)p.h_kv * D;
  const float* qb = static_cast<const float*>(p.q) + (size_t)bi * p.s * q_stride + (size_t)hi * D;
  const float* kb = static_cast<const float*>(p.k) + (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  const float* vb = static_cast<const float*>(p.v) + (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  float* ob = static_cast<float*>(p.o) + (size_t)bi * p.s * q_stride + (size_t)hi * D;

  for (int i = tid; i < kBQ * D; i += 256) {
    const int r = i / D, c = i - r * D;
    qs[r * LD + c] = q0 + r < p.s ? qb[(size_t)(q0 + r) * q_stride + c] : 0.f;
  }
  const int seg_q = qrow < p.s ? seg_at(p, bi, qrow) : -2;

  float m = -INFINITY, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int dd = 0; dd < D / 4; ++dd) acc[dd] = 0.f;

  const int kv_end = p.causal ? min(p.s, q0 + kBQ) : p.s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += 256) {
      const int r = i / D, c = i - r * D;
      const bool in = kv0 + r < p.s;
      ks[r * LD + c] = in ? kb[(size_t)(kv0 + r) * kv_stride + c] : 0.f;
      vs[r * D + c] = in ? vb[(size_t)(kv0 + r) * kv_stride + c] : 0.f;
    }
    for (int i = tid; i < kBK; i += 256)
      segk[i] = kv0 + i < p.s ? seg_at(p, bi, kv0 + i) : -1;
    __syncthreads();

    // this thread's keys: c = part + 4 * j
    float sc[kBK / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int c = part + 4 * j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row * LD + d], ks[c * LD + d], dot);
      const bool ok = segk[c] == seg_q && (!p.causal || kv0 + c <= qrow);
      sc[j] = ok ? dot * p.scale : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, quad_max(mx));
    const float base = mn == -INFINITY ? 0.f : mn;
    const float alpha = expf(m - base);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float pj = expf(sc[j] - base);
      ps[row * LDP + part + 4 * j] = pj;
      sum += pj;
    }
    l = l * alpha + quad_sum(sum);
    __syncwarp();  // the row's four threads share its P
    // this thread's output columns: dd * 4 + part
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd) acc[dd] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float pc = ps[row * LDP + c];
#pragma unroll
      for (int dd = 0; dd < D / 4; ++dd) acc[dd] = fmaf(pc, vs[c * D + dd * 4 + part], acc[dd]);
    }
  }
  if (qrow < p.s) {
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd)
      ob[(size_t)qrow * q_stride + dd * 4 + part] = l > 0.f ? acc[dd] / l : 0.f;
    if (p.lse && part == 0)
      p.lse[((size_t)bi * p.h + hi) * p.s + qrow] = m + logf(l);
  }
}

// ------------------------------------------------------ bf16 on wgmma

constexpr int kTcRows = 128;  // query rows per block: 64 a consumer warpgroup
constexpr int kTcKeys = 128;  // keys per K or V tile (kTcRows: see n_tiles)
constexpr int kTcStages = 3;
constexpr int kTcBox = 128 * 128;   // one TMA box: 128 rows of 64 bf16
constexpr int kTcTile = 2 * kTcBox;  // a 128-row tile at d = 128, 32 KB
// Two consumer warpgroups; thread 0 also keeps the ring full. 256 threads
// leave ptxas 255 registers a thread: the dk/dv kernel's consumers need
// 250 (two 64 x 128 float32 sums, two 64 x 64 score tiles). With a
// producer warpgroup (384 threads) ptxas held every thread to 168, which
// `setmaxnreg` did not raise, and that kernel spilled.
constexpr int kTcThreads = 256;
// Q, the ring of (K, V) stages, each stage's key segment ids, the
// barriers, and the slack to align the tiles to 1024 bytes
constexpr int kTcSmem = kTcTile + kTcStages * 2 * kTcTile
    + kTcStages * kTcKeys * 4 + (2 * kTcStages + 1) * 8 + 1024;
static_assert(kTcSmem <= 232448, "more shared memory than a block has");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct TcParams {
  const int* seg;  // [b, s] segment ids, or null: one segment
  void* o;
  float* lse;      // [b, h, s], or null
  int s, h, h_kv;
  float scale_log2;  // d^-0.5 * log2(e): the scores in base-2 units
  int causal;
};

// One block per (128 query rows, head, batch row). Thread 0 loads Q once
// and streams the 128-key K and V tiles (and their segment ids) through a
// ring of kTcStages stages. Warpgroup wg owns query rows 64 wg .. 64 wg +
// 63 of the block: per tile,
// S = Q K^T (m64n128k16 from shared memory, K read K-major), the mask and
// the online softmax on the accumulator in base-2 units, P rounded to bf16
// in registers as the A operand of O += P V (V read MN-major from the same
// swizzled tile), then the stage is released.
__global__ void __launch_bounds__(kTcThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, TcParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* kvs = qs + kTcTile;  // stage st: K at kvs + 2 st kTcTile, V after
  int* segk = reinterpret_cast<int*>(kvs + kTcStages * 2 * kTcTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(segk + kTcStages * kTcKeys);
  uint64_t* qbar = full + kTcStages;
  int* taken = reinterpret_cast<int*>(qbar + 1);  // releases, per stage

  // the longest causal rows first: the last blocks to start are short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTcRows;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.h_kv);
  // causal: the key tiles up to the diagonal one (kTcKeys == kTcRows)
  const int n_tiles = p.causal ? qt + 1 : p.s / kTcKeys;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(&full[st], 1);
      taken[st] = 0;
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  // thread 0 loads the resident tiles and the first kTcStages tiles; each
  // later tile is loaded by the warpgroup that releases its stage second,
  // so neither waits for the other
  auto load_tile = [&](int t) {
    const int st = t % kTcStages;
    uint8_t* ks = kvs + st * 2 * kTcTile;
    const int kv0 = t * kTcKeys;
    mbar_expect_tx(&full[st], 2 * kTcTile + (p.seg ? kTcKeys * 4 : 0));
    tma_load_4d(ks, &tk, &full[st], 0, hk, kv0, bi);
    tma_load_4d(ks + kTcBox, &tk, &full[st], 64, hk, kv0, bi);
    tma_load_4d(ks + kTcTile, &tv, &full[st], 0, hk, kv0, bi);
    tma_load_4d(ks + kTcTile + kTcBox, &tv, &full[st], 64, hk, kv0, bi);
    if (p.seg)
      bulk_load(segk + st * kTcKeys, p.seg + (size_t)bi * p.s + kv0,
                kTcKeys * 4, &full[st]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, kTcTile);
    tma_load_4d(qs, &tq, qbar, 0, hi, q0, bi);
    tma_load_4d(qs + kTcBox, &tq, qbar, 64, hi, q0, bi);
    for (int t = 0; t < n_tiles && t < kTcStages; ++t) load_tile(t);
  }

  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = q0 + 64 * wg + 16 * (warp & 3) + g, row_b = row_a + 8;
  const int seg_a = p.seg ? p.seg[(size_t)bi * p.s + row_a] : 1;
  const int seg_b = p.seg ? p.seg[(size_t)bi * p.s + row_b] : 1;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  // this warpgroup's 64 rows of Q: box 0 holds d 0-63, box 1 d 64-127
  const uint64_t dq0 = sw128_desc(qs + wg * 64 * 128);
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTcStages;
    uint8_t* ks = kvs + st * 2 * kTcTile;
    const int* sk = segk + st * kTcKeys;
    const int kv0 = t * kTcKeys;
    mbar_wait(&full[st], (t / kTcStages) & 1);

    // S = Q K^T over d = 128: k16 slice kk lies in box kk / 4, 32 bytes
    // per slice along the swizzled rows
    float sc[64];
    const uint64_t dq = opaque(dq0), dk = sw128_desc(ks);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off = (kk >> 2) * (kTcBox >> 4) + (kk & 3) * 2;
      wgmma_ss_n128(sc, dq + off, dk + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sum 4i + 2h + e is row (h ? row_b : row_a), key kv0 + 8i + 2 t4 + e;
    // only the diagonal tile needs the causal test
    const bool diag = p.causal && t == n_tiles - 1;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * i + 2 * t4 + e;
        const int sg = p.seg ? sk[c] : 1;
        const bool ok_a = sg == seg_a && (!diag || kv0 + c <= row_a);
        const bool ok_b = sg == seg_b && (!diag || kv0 + c <= row_b);
        sc[4 * i + e] = ok_a ? sc[4 * i + e] * p.scale_log2 : -INFINITY;
        sc[4 * i + 2 + e] =
            ok_b ? sc[4 * i + 2 + e] * p.scale_log2 : -INFINITY;
        mx_a = fmaxf(mx_a, sc[4 * i + e]);
        mx_b = fmaxf(mx_b, sc[4 * i + 2 + e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row with no unmasked key yet keeps a base of 0: 2^-inf = 0
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = ex2(m_a - base_a), alpha_b = ex2(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;

    // P in float32 for the row sums, rounded to bf16 as the A fragments of
    // the k16 slices of keys 16j .. 16j + 15 (sums 8j .. 8j + 7)
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pf[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        pr[u] = ex2(sc[8 * j + u] - ((u & 2) ? base_b : base_a));
      sum_a += (pr[0] + pr[1]) + (pr[4] + pr[5]);
      sum_b += (pr[2] + pr[3]) + (pr[6] + pr[7]);
      pf[j][0] = pack_bf16(pr[0], pr[1]);  // row a, keys 2 t4, 2 t4 + 1
      pf[j][1] = pack_bf16(pr[2], pr[3]);  // row b
      pf[j][2] = pack_bf16(pr[4], pr[5]);  // row a, keys 8 + 2 t4, ...
      pf[j][3] = pack_bf16(pr[6], pr[7]);  // row b
    }
    l_a = l_a * alpha_a + quad_sum(sum_a);
    l_b = l_b * alpha_b + quad_sum(sum_b);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      o[4 * i] *= alpha_a;
      o[4 * i + 1] *= alpha_a;
      o[4 * i + 2] *= alpha_b;
      o[4 * i + 3] *= alpha_b;
    }

    // O += P V: V's rows are the contracted keys, d runs along them (box 0
    // d 0-63, box 1 d 64-127), read MN-major; 16 keys are 2048 bytes
    const uint64_t dv = sw128_mn_desc(ks + kTcTile, kTcBox);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) wgmma_rs_n128<1>(o, pf[j], dv + j * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_regs(pf[j]);
    // this warpgroup is done with the stage (its wgmmas have finished and
    // every thread read its segment ids before issuing them)
    if ((threadIdx.x & 127) == 0) release<kTcStages>(taken, st, t, n_tiles,
                                                  load_tile);
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o)
      + ((size_t)bi * p.s * p.h + hi) * 128;
  const size_t stride = (size_t)p.h * 128;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * t4;
    *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * stride + c) =
        pack_bf16(l_a > 0.f ? o[4 * i] / l_a : 0.f,
                  l_a > 0.f ? o[4 * i + 1] / l_a : 0.f);
    *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * stride + c) =
        pack_bf16(l_b > 0.f ? o[4 * i + 2] / l_b : 0.f,
                  l_b > 0.f ? o[4 * i + 3] / l_b : 0.f);
  }
  // the natural-log logsumexp (m + log2 l) ln 2, from the four threads
  // that share the row (t4 == 0)
  if (p.lse && t4 == 0) {
    float* lb = p.lse + ((size_t)bi * p.h + hi) * p.s;
    lb[row_a] = (m_a + log2f(l_a)) * kLn2;
    lb[row_b] = (m_b + log2f(l_b)) * kLn2;
  }
}

int launch_tc(const void* q, const void* k, const void* v, const int* seg,
              void* o, float* lse, int b, int s, int h, int h_kv,
              float scale, int causal, cudaStream_t stream) {
  if (s % kTcRows) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int code = encode_bshd(&tq, q, b, s, h, 128, kTcRows);
  if (!code) code = encode_bshd(&tk, k, b, s, h_kv, 128, kTcKeys);
  if (!code) code = encode_bshd(&tv, v, b, s, h_kv, 128, kTcKeys);
  if (code) return code;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const TcParams p{seg, o, lse, s, h, h_kv, scale * kLog2e, causal};
  const dim3 grid(s / kTcRows, h, b);
  flash_wgmma_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.s + kBQ - 1) / kBQ, p.h, p.b);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch(flash_bf16_kernel<D>, 128, bf16_smem_bytes<D>(), p, stream);
  return launch(flash_f32_kernel<D>, 256, f32_smem_bytes<D>(), p, stream);
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() as an int:
// `lse`, when not null, receives each row's logsumexp m + log(l) in float32,
// [b, h, s], the residual the backward (flash_attention_bwd.cu) reads.
// 0 when the launch was accepted, cudaErrorInvalidValue for a head width
// outside {16, 32, 64, 128}, a head count that is not a multiple of the kv
// head count, or a grid the card cannot hold. Launches nothing when s == 0.
int fa_forward(const void* q, const void* k, const void* v, const int* seg,
               void* o, float* lse, int b, int s, int h, int h_kv, int d,
               float scale, int causal, int is_bf16, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (h_kv <= 0 || h % h_kv != 0 || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, seg, o, lse, b, s, h, h_kv, scale, causal};
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_d<16>(p, is_bf16, st);
    case 32: return launch_d<32>(p, is_bf16, st);
    case 64: return launch_d<64>(p, is_bf16, st);
    case 128: return launch_d<128>(p, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The `wgmma` variant: bf16, d = 128, s a multiple of 128, every pointer
// 16-byte aligned (TMA reads q, k, v; the segment ids are copied in bulk).
// Returns the codes of fa_forward, or a descriptor-encoding code that
// fa_error_string names.
int fa_forward_tc(const void* q, const void* k, const void* v, const int* seg,
                  void* o, float* lse, int b, int s, int h, int h_kv, int d,
                  float scale, int causal, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (h_kv <= 0 || h % h_kv != 0 || h > 65535 || b > 65535 || d != 128)
    return (int)cudaErrorInvalidValue;
  return launch_tc(q, k, v, seg, o, lse, b, s, h, h_kv, scale, causal,
                   (cudaStream_t)stream);
}

const char* fa_error_string(int code) { return hopper_error_string(code); }

}  // extern "C"
