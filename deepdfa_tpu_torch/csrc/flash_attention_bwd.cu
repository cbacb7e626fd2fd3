// Backward of causal, segment-masked softmax attention for NVIDIA Hopper,
// sm_90a: the gradients of flash_attention.cu's forward.
//
// Replaces the two Pallas TPU kernels that the stock flash-attention VJP
// `_flash_attention_bwd` (jax/experimental/pallas/ops/tpu/flash_attention.py
// :254) calls under jax.grad of deepdfa_tpu/llm/llama.py:222
// `_flash_attention`: the dk/dv kernel (`pallas_call` at :1121, body
// `_flash_attention_dkv_kernel` :796) and the dq kernel (`pallas_call` at
// :1456, body `_flash_attention_dq_kernel` :1146). For q, do [b, s, h, d],
// k, v [b, s, h_kv, d], the forward's row logsumexp lse [b, h, s] and
// di = rowsum(o * do) [b, h, s] (both float32), with the forward's mask (a
// key counts for a query when their segment ids are equal and, when causal,
// the key is not later) and scale = d^-0.5:
//     p_ij  = exp(s_ij - lse_i),  s_ij = (q_i . k_j) * scale   (0 if masked)
//     dv_j  = sum_i p_ij do_i            p rounded to do's type
//     dp_ij = do_i . v_j
//     ds_ij = (dp_ij - di_i) * p_ij * scale
//     dk_j  = sum_i ds_ij q_i            ds rounded to do's type
//     dq_i  = sum_j ds_ij k_j            ds rounded to k's type
// every product summed in float32, each output rounded once to its input's
// type. Grouped-query heads: kv head j serves query heads j*r .. j*r + r-1
// (r = h / h_kv), and its dk, dv sum over them.
//
// What bounds it on this card. The backward does 2.5x the forward's
// tensor-core work (five products of b*h*s*(s+1)/2*d multiply-adds against
// two) over 2x its bytes (q, k, v, do in; dq, dk, dv out): at the LLM's
// s = 256 it is bound by bytes, from s ~ 1024 by operations.
//
// What the design does about that. The TPU kernels walk a sequential grid
// and keep dk, dv (or dq) in scratch across grid steps. Blocks here run in
// no order, so each block loops over its reduction itself and no sum ever
// crosses blocks: there are no float atomics, and two calls on the same
// inputs are bitwise equal.
//   - dk, dv: one block of 4 warps per (batch, kv head, 64-key tile); each
//     warp owns 16 keys. It walks the query heads of its kv group in order
//     and, for each, the 32-query tiles from the causal diagonal to the end
//     in order, with dk and dv in float32 registers, written once.
//   - dq: one block of 4 warps per (batch, query head, 64-query tile); each
//     warp owns 16 queries. It walks the 32-key tiles up to the diagonal in
//     order, dq in float32 registers.
// bf16 at d = 128 with s a multiple of 128 (every shape of the LLM tier)
// takes the `wgmma` variant (`dkv_wgmma_kernel`, `dq_wgmma_kernel`, below):
// 128 keys (dk, dv) or 128 queries (dq) a block, TMA loads of
// 128-byte-swizzled tiles into a three-stage ring, the score products read
// from shared memory, P and dS rounded to bf16 in registers as the A
// operands of the next products, Q, dO or K read transposed from the same
// tiles. Other bf16 (variant "mma") runs on `mma.sync.m16n8k16` with
// float32 accumulators, as the forward's: the score fragments of one product are laid out as the A operand
// of the next, so P and dS are rounded to bf16 in registers and never
// stored; every B operand is a 32-bit shared load from a tile stored
// row-major or transposed as that product needs it. The inner tile is 32
// wide so that at d = 128 the two 16 x 128 float32 accumulators (128
// registers) and the score fragments fit a thread's 255 registers without
// spilling. Float32 (the test-size model) takes FFMA kernels of the same
// structure: four threads per row, P and dS through shared memory (variant
// "ffma"). Python chooses the variant (ops/flash_attention.py `variant`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;  // keys (dk, dv) or queries (dq) a block owns
constexpr int kStep = 32;  // queries (dk, dv) or keys (dq) per inner tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // [b, h, s]
  const float* di;   // [b, h, s]
  const int* seg;    // [b, s] segment ids, or null: one segment
  void* dq;
  void* dk;
  void* dv;
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* x) {
  return *reinterpret_cast<const uint32_t*>(x);
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

// A fragment of rows r0 .. r0+15, columns c0 .. c0+15 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* x,
                                       int ld, int r0, int c0, int g, int t) {
  const __nv_bfloat16* p0 = x + (r0 + g) * ld + c0 + t * 2;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// rows [r0, r0 + n) of a [s, heads, D] bf16 tensor's head into a row-major
// tile (ld D + 8) and, when xt is not null, its transpose (ld n + 8); rows
// past s read as 0
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* x,
                                           __nv_bfloat16* xt,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0, int n,
                                           int s, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < n * CH; i += 128) {
    const int r = i / CH, c = i - r * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < s)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(x + r * (D + 8) + c * 8) = val;
    if (xt) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) xt[(c * 8 + j) * (n + 8) + r] = e[j];
    }
  }
}

// ------------------------------------------------------- bf16: dk and dv

template <int D>
constexpr int dkv_bf16_smem_bytes() {
  // K, V (kRows rows) and Q, dO (kStep rows) row-major; Q, dO transposed;
  // lse, di and the segment ids of the query tile; the keys' segment ids
  return (2 * kRows * (D + 8) + 2 * kStep * (D + 8) + 2 * D * (kStep + 8)) * 2
      + 3 * kStep * 4 + kRows * 4;
}

template <int D>
__global__ void __launch_bounds__(128) dkv_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + 8;
  constexpr int LDT = kStep + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kRows * LD;
  __nv_bfloat16* qs = vs + kRows * LD;
  __nv_bfloat16* ds_ = qs + kStep * LD;  // dO row-major
  __nv_bfloat16* qt = ds_ + kStep * LD;
  __nv_bfloat16* dt = qt + D * LDT;      // dO transposed
  float* lse_s = reinterpret_cast<float*>(dt + D * LDT);
  float* di_s = lse_s + kStep;
  int* segq = reinterpret_cast<int*>(di_s + kStep);
  int* segk = segq + kStep;

  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int rep = p.h / p.h_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)p.h * D;
  const size_t kv_stride = (size_t)p.h_kv * D;
  const size_t kv_off = (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + kv_off;

  stage_rows<D>(ks, nullptr, kb, kv_stride, k0, kRows, p.s, tid);
  stage_rows<D>(vs, nullptr, vb, kv_stride, k0, kRows, p.s, tid);
  for (int i = tid; i < kRows; i += 128)
    segk[i] = k0 + i < p.s ? seg_at(p, bi, k0 + i) : -1;

  const int ra = warp * 16 + g;  // this thread's key rows ra and ra + 8
  const int key_a = k0 + ra, key_b = key_a + 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nd][j] = dv[nd][j] = 0.f;

  const int q_begin = p.causal ? k0 : 0;
  for (int hq = hk * rep; hq < (hk + 1) * rep; ++hq) {
    const size_t q_off = (size_t)bi * p.s * q_stride + (size_t)hq * D;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + q_off;
    const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(p.dout) + q_off;
    const float* lse_b = p.lse + ((size_t)bi * p.h + hq) * p.s;
    const float* di_b = p.di + ((size_t)bi * p.h + hq) * p.s;
    for (int q0 = q_begin; q0 < p.s; q0 += kStep) {
      __syncthreads();  // the previous tile's readers are done
      stage_rows<D>(qs, qt, qb, q_stride, q0, kStep, p.s, tid);
      stage_rows<D>(ds_, dt, db, q_stride, q0, kStep, p.s, tid);
      for (int i = tid; i < kStep; i += 128) {
        const bool in = q0 + i < p.s;
        lse_s[i] = in ? lse_b[q0 + i] : 0.f;
        di_s[i] = in ? di_b[q0 + i] : 0.f;
        segq[i] = in ? seg_at(p, bi, q0 + i) : -2;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows (ra, ra + 8) x queries
      // nb * 8 + t * 2 + {0, 1}
      float st[kStep / 8][4], dpt[kStep / 8][4];
#pragma unroll
      for (int nb = 0; nb < kStep / 8; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[nb][j] = dpt[nb][j] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ka[4], va[4];
        load_a(ka, ks, LD, warp * 16, kc * 16, g, t);
        load_a(va, vs, LD, warp * 16, kc * 16, g, t);
#pragma unroll
        for (int nb = 0; nb < kStep / 8; ++nb) {
          const __nv_bfloat16* qrow = qs + (nb * 8 + g) * LD + kc * 16 + t * 2;
          const __nv_bfloat16* drow = ds_ + (nb * 8 + g) * LD + kc * 16 + t * 2;
          mma_bf16(st[nb], ka, ld32(qrow), ld32(qrow + 8));
          mma_bf16(dpt[nb], va, ld32(drow), ld32(drow + 8));
        }
      }
      // P^T and dS^T, rounded to bf16 as the A operands of dV and dK
      uint32_t pf[kStep / 16][4], sf[kStep / 16][4];
#pragma unroll
      for (int nb = 0; nb < kStep / 8; ++nb) {
        float pv[4], dsv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = nb * 8 + t * 2 + (j & 1);
          const int key = j < 2 ? key_a : key_b;
          const int kr = j < 2 ? ra : ra + 8;
          const bool ok = segk[kr] == segq[c] && (!p.causal || key <= q0 + c);
          pv[j] = ok ? expf(st[nb][j] * p.scale - lse_s[c]) : 0.f;
          dsv[j] = (dpt[nb][j] - di_s[c]) * pv[j] * p.scale;
        }
        pf[nb / 2][(nb % 2) * 2] = pack_bf16(pv[0], pv[1]);
        pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        sf[nb / 2][(nb % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
        sf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }
      // dV += P^T dO and dK += dS^T Q over this tile's queries
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const __nv_bfloat16* drow = dt + (nd * 8 + g) * LDT + kk * 16 + t * 2;
          const __nv_bfloat16* qrow = qt + (nd * 8 + g) * LDT + kk * 16 + t * 2;
          mma_bf16(dv[nd], pf[kk], ld32(drow), ld32(drow + 8));
          mma_bf16(dk[nd], sf[kk], ld32(qrow), ld32(qrow + 8));
        }
      }
    }
  }

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + kv_off;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + kv_off;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t * 2;
    if (key_a < p.s) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key_a * kv_stride + c) =
          pack_bf16(dk[nd][0], dk[nd][1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key_a * kv_stride + c) =
          pack_bf16(dv[nd][0], dv[nd][1]);
    }
    if (key_b < p.s) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key_b * kv_stride + c) =
          pack_bf16(dk[nd][2], dk[nd][3]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key_b * kv_stride + c) =
          pack_bf16(dv[nd][2], dv[nd][3]);
    }
  }
}

// ------------------------------------------------------------ bf16: dq

template <int D>
constexpr int dq_bf16_smem_bytes() {
  // Q, dO (kRows rows) and K, V (kStep rows) row-major; K transposed; the
  // keys' segment ids
  return (2 * kRows * (D + 8) + 2 * kStep * (D + 8) + D * (kStep + 8)) * 2
      + kStep * 4;
}

template <int D>
__global__ void __launch_bounds__(128) dq_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + 8;
  constexpr int LDT = kStep + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds_ = qs + kRows * LD;  // dO row-major
  __nv_bfloat16* ks = ds_ + kRows * LD;
  __nv_bfloat16* vs = ks + kStep * LD;
  __nv_bfloat16* kt = vs + kStep * LD;
  int* segk = reinterpret_cast<int*>(kt + D * LDT);

  const int q0 = blockIdx.x * kRows;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.h_kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)p.h * D;
  const size_t kv_stride = (size_t)p.h_kv * D;
  const size_t q_off = (size_t)bi * p.s * q_stride + (size_t)hi * D;
  const size_t kv_off = (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + kv_off;

  stage_rows<D>(qs, nullptr, static_cast<const __nv_bfloat16*>(p.q) + q_off,
                q_stride, q0, kRows, p.s, tid);
  stage_rows<D>(ds_, nullptr,
                static_cast<const __nv_bfloat16*>(p.dout) + q_off, q_stride,
                q0, kRows, p.s, tid);
  __syncthreads();

  // this warp's 16 queries of Q and dO as A fragments, kept in registers
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    load_a(qf[kc], qs, LD, warp * 16, kc * 16, g, t);
    load_a(df[kc], ds_, LD, warp * 16, kc * 16, g, t);
  }
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const bool in_a = row_a < p.s, in_b = row_b < p.s;
  const int seg_a = in_a ? seg_at(p, bi, row_a) : -2;
  const int seg_b = in_b ? seg_at(p, bi, row_b) : -2;
  const float* lse_b = p.lse + ((size_t)bi * p.h + hi) * p.s;
  const float* di_b = p.di + ((size_t)bi * p.h + hi) * p.s;
  const float lse_a = in_a ? lse_b[row_a] : 0.f, lse_bb = in_b ? lse_b[row_b] : 0.f;
  const float di_a = in_a ? di_b[row_a] : 0.f, di_bb = in_b ? di_b[row_b] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  const int kv_end = p.causal ? min(p.s, q0 + kRows) : p.s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kStep) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(ks, kt, kb, kv_stride, kv0, kStep, p.s, tid);
    stage_rows<D>(vs, nullptr, vb, kv_stride, kv0, kStep, p.s, tid);
    for (int i = tid; i < kStep; i += 128)
      segk[i] = kv0 + i < p.s ? seg_at(p, bi, kv0 + i) : -1;
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows (row_a, row_b) x keys nb * 8 + t * 2
    float sc[kStep / 8][4], dp[kStep / 8][4];
#pragma unroll
    for (int nb = 0; nb < kStep / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nb][j] = dp[nb][j] = 0.f;
      const __nv_bfloat16* krow = ks + (nb * 8 + g) * LD + t * 2;
      const __nv_bfloat16* vrow = vs + (nb * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        mma_bf16(sc[nb], qf[kc], ld32(krow + kc * 16), ld32(krow + kc * 16 + 8));
        mma_bf16(dp[nb], df[kc], ld32(vrow + kc * 16), ld32(vrow + kc * 16 + 8));
      }
    }
    // dS, rounded to bf16 as the A operand of dQ
    uint32_t sf[kStep / 16][4];
#pragma unroll
    for (int nb = 0; nb < kStep / 8; ++nb) {
      float dsv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb * 8 + t * 2 + (j & 1);
        const int col = kv0 + c;
        const bool ok = j < 2
            ? segk[c] == seg_a && (!p.causal || col <= row_a)
            : segk[c] == seg_b && (!p.causal || col <= row_b);
        const float pv = ok ? expf(sc[nb][j] * p.scale - (j < 2 ? lse_a : lse_bb)) : 0.f;
        dsv[j] = (dp[nb][j] - (j < 2 ? di_a : di_bb)) * pv * p.scale;
      }
      sf[nb / 2][(nb % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
      sf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* krow = kt + (nd * 8 + g) * LDT + kk * 16 + t * 2;
        mma_bf16(dq[nd], sf[kk], ld32(krow), ld32(krow + 8));
      }
    }
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + q_off;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t * 2;
    if (in_a)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_a * q_stride + c) =
          pack_bf16(dq[nd][0], dq[nd][1]);
    if (in_b)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_b * q_stride + c) =
          pack_bf16(dq[nd][2], dq[nd][3]);
  }
}

// ------------------------------------------------------ float32: dk, dv

template <int D>
constexpr int dkv_f32_smem_bytes() {
  // K, V (kRows rows, padded to D + 1), Q, dO (kStep rows), P and dS
  // (kRows x kStep + 1), lse, di, segment ids
  return (2 * kRows * (D + 1) + 2 * kStep * (D + 1) + 2 * kRows * (kStep + 1)
          + 3 * kStep) * 4 + kRows * 4;
}

template <int D>
__global__ void __launch_bounds__(256) dkv_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + 1;
  constexpr int LDP = kStep + 1;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kRows * LD;
  float* qs = vs + kRows * LD;
  float* ds_ = qs + kStep * LD;  // dO
  float* ps = ds_ + kStep * LD;
  float* dss = ps + kRows * LDP;
  float* lse_s = dss + kRows * LDP;
  float* di_s = lse_s + kStep;
  int* segq = reinterpret_cast<int*>(di_s + kStep);
  int* segk = segq + kStep;

  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int rep = p.h / p.h_kv;
  const int tid = threadIdx.x;
  const int row = tid >> 2, part = tid & 3;  // four threads per key row
  const int key = k0 + row;
  const size_t q_stride = (size_t)p.h * D;
  const size_t kv_stride = (size_t)p.h_kv * D;
  const size_t kv_off = (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  const float* kb = static_cast<const float*>(p.k) + kv_off;
  const float* vb = static_cast<const float*>(p.v) + kv_off;

  for (int i = tid; i < kRows * D; i += 256) {
    const int r = i / D, c = i - r * D;
    const bool in = k0 + r < p.s;
    ks[r * LD + c] = in ? kb[(size_t)(k0 + r) * kv_stride + c] : 0.f;
    vs[r * LD + c] = in ? vb[(size_t)(k0 + r) * kv_stride + c] : 0.f;
  }
  for (int i = tid; i < kRows; i += 256)
    segk[i] = k0 + i < p.s ? seg_at(p, bi, k0 + i) : -1;

  // this thread's output columns: dd * 4 + part
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int dd = 0; dd < D / 4; ++dd) dk[dd] = dv[dd] = 0.f;

  const int q_begin = p.causal ? k0 : 0;
  for (int hq = hk * rep; hq < (hk + 1) * rep; ++hq) {
    const size_t q_off = (size_t)bi * p.s * q_stride + (size_t)hq * D;
    const float* qb = static_cast<const float*>(p.q) + q_off;
    const float* db = static_cast<const float*>(p.dout) + q_off;
    const float* lse_b = p.lse + ((size_t)bi * p.h + hq) * p.s;
    const float* di_b = p.di + ((size_t)bi * p.h + hq) * p.s;
    for (int q0 = q_begin; q0 < p.s; q0 += kStep) {
      __syncthreads();
      for (int i = tid; i < kStep * D; i += 256) {
        const int r = i / D, c = i - r * D;
        const bool in = q0 + r < p.s;
        qs[r * LD + c] = in ? qb[(size_t)(q0 + r) * q_stride + c] : 0.f;
        ds_[r * LD + c] = in ? db[(size_t)(q0 + r) * q_stride + c] : 0.f;
      }
      for (int i = tid; i < kStep; i += 256) {
        const bool in = q0 + i < p.s;
        lse_s[i] = in ? lse_b[q0 + i] : 0.f;
        di_s[i] = in ? di_b[q0 + i] : 0.f;
        segq[i] = in ? seg_at(p, bi, q0 + i) : -2;
      }
      __syncthreads();
      // this thread's queries: c = part + 4 * j
#pragma unroll
      for (int j = 0; j < kStep / 4; ++j) {
        const int c = part + 4 * j;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          sdot = fmaf(ks[row * LD + d], qs[c * LD + d], sdot);
          pdot = fmaf(vs[row * LD + d], ds_[c * LD + d], pdot);
        }
        const bool ok = segk[row] == segq[c] && (!p.causal || key <= q0 + c);
        const float pv = ok ? expf(sdot * p.scale - lse_s[c]) : 0.f;
        ps[row * LDP + c] = pv;
        dss[row * LDP + c] = (pdot - di_s[c]) * pv * p.scale;
      }
      __syncwarp();  // the row's four threads share its P and dS
      for (int c = 0; c < kStep; ++c) {
        const float pc = ps[row * LDP + c], sc = dss[row * LDP + c];
#pragma unroll
        for (int dd = 0; dd < D / 4; ++dd) {
          dv[dd] = fmaf(pc, ds_[c * LD + dd * 4 + part], dv[dd]);
          dk[dd] = fmaf(sc, qs[c * LD + dd * 4 + part], dk[dd]);
        }
      }
    }
  }
  if (key < p.s) {
    float* dkb = static_cast<float*>(p.dk) + kv_off + (size_t)key * kv_stride;
    float* dvb = static_cast<float*>(p.dv) + kv_off + (size_t)key * kv_stride;
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd) {
      dkb[dd * 4 + part] = dk[dd];
      dvb[dd * 4 + part] = dv[dd];
    }
  }
}

// ---------------------------------------------------------- float32: dq

template <int D>
constexpr int dq_f32_smem_bytes() {
  // Q, dO (kRows rows, padded to D + 1), K, V (kStep rows), dS, segment ids
  return (2 * kRows * (D + 1) + 2 * kStep * (D + 1) + kRows * (kStep + 1)) * 4
      + kStep * 4;
}

template <int D>
__global__ void __launch_bounds__(256) dq_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + 1;
  constexpr int LDP = kStep + 1;
  float* qs = reinterpret_cast<float*>(smem);
  float* ds_ = qs + kRows * LD;  // dO
  float* ks = ds_ + kRows * LD;
  float* vs = ks + kStep * LD;
  float* dss = vs + kStep * LD;
  int* segk = reinterpret_cast<int*>(dss + kRows * LDP);

  const int q0 = blockIdx.x * kRows;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.h_kv);
  const int tid = threadIdx.x;
  const int row = tid >> 2, part = tid & 3;  // four threads per query row
  const int qrow = q0 + row;
  const size_t q_stride = (size_t)p.h * D;
  const size_t kv_stride = (size_t)p.h_kv * D;
  const size_t q_off = (size_t)bi * p.s * q_stride + (size_t)hi * D;
  const size_t kv_off = (size_t)bi * p.s * kv_stride + (size_t)hk * D;
  const float* qb = static_cast<const float*>(p.q) + q_off;
  const float* db = static_cast<const float*>(p.dout) + q_off;
  const float* kb = static_cast<const float*>(p.k) + kv_off;
  const float* vb = static_cast<const float*>(p.v) + kv_off;

  for (int i = tid; i < kRows * D; i += 256) {
    const int r = i / D, c = i - r * D;
    const bool in = q0 + r < p.s;
    qs[r * LD + c] = in ? qb[(size_t)(q0 + r) * q_stride + c] : 0.f;
    ds_[r * LD + c] = in ? db[(size_t)(q0 + r) * q_stride + c] : 0.f;
  }
  const bool in_q = qrow < p.s;
  const int seg_q = in_q ? seg_at(p, bi, qrow) : -2;
  const float lse_q = in_q ? p.lse[((size_t)bi * p.h + hi) * p.s + qrow] : 0.f;
  const float di_q = in_q ? p.di[((size_t)bi * p.h + hi) * p.s + qrow] : 0.f;

  float dq[D / 4];
#pragma unroll
  for (int dd = 0; dd < D / 4; ++dd) dq[dd] = 0.f;

  const int kv_end = p.causal ? min(p.s, q0 + kRows) : p.s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kStep) {
    __syncthreads();
    for (int i = tid; i < kStep * D; i += 256) {
      const int r = i / D, c = i - r * D;
      const bool in = kv0 + r < p.s;
      ks[r * LD + c] = in ? kb[(size_t)(kv0 + r) * kv_stride + c] : 0.f;
      vs[r * LD + c] = in ? vb[(size_t)(kv0 + r) * kv_stride + c] : 0.f;
    }
    for (int i = tid; i < kStep; i += 256)
      segk[i] = kv0 + i < p.s ? seg_at(p, bi, kv0 + i) : -1;
    __syncthreads();
    // this thread's keys: c = part + 4 * j
#pragma unroll
    for (int j = 0; j < kStep / 4; ++j) {
      const int c = part + 4 * j;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sdot = fmaf(qs[row * LD + d], ks[c * LD + d], sdot);
        pdot = fmaf(ds_[row * LD + d], vs[c * LD + d], pdot);
      }
      const bool ok = segk[c] == seg_q && (!p.causal || kv0 + c <= qrow);
      const float pv = ok ? expf(sdot * p.scale - lse_q) : 0.f;
      dss[row * LDP + c] = (pdot - di_q) * pv * p.scale;
    }
    __syncwarp();  // the row's four threads share its dS
    for (int c = 0; c < kStep; ++c) {
      const float sc = dss[row * LDP + c];
#pragma unroll
      for (int dd = 0; dd < D / 4; ++dd)
        dq[dd] = fmaf(sc, ks[c * LD + dd * 4 + part], dq[dd]);
    }
  }
  if (in_q) {
    float* dqb = static_cast<float*>(p.dq) + q_off + (size_t)qrow * q_stride;
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd) dqb[dd * 4 + part] = dq[dd];
  }
}

// ------------------------------------------------------ bf16 on wgmma

// Two consumer warpgroups; thread 0 also keeps the ring full. 256 threads
// leave ptxas 255 registers a thread: the dk/dv kernel's consumers need
// 250 (two 64 x 128 float32 sums, two 64 x 64 score tiles). With a
// producer warpgroup (384 threads) ptxas held every thread to 168, which
// `setmaxnreg` did not raise, and that kernel spilled.
constexpr int kTcThreads = 256;
constexpr int kTcStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

struct TcParams {
  const float* lse;  // [b, h, s]
  const float* di;   // [b, h, s]
  const int* seg;    // [b, s] segment ids, or null: one segment
  void* out0;        // dq, or dk
  void* out1;        // dv
  int s, h, h_kv;
  float scale;
  int causal;
};

// k16 slice kk of a K-major 128-wide (d) tile whose two 64-wide boxes lie
// `box` bytes apart, as a descriptor offset in 16-byte units
__device__ __forceinline__ int kslice(int kk, int box) {
  return (kk >> 2) * (box >> 4) + (kk & 3) * 2;
}

// Writes a warpgroup's m64 x 128 float32 sums as bf16 rows of a [.., d]
// tensor: sum 4i + 2h + e is row (h ? row_b : row_a), column 8i + 2 t4 + e.
__device__ __forceinline__ void store_rows(const float (&acc)[64],
                                           __nv_bfloat16* base, size_t stride,
                                           int row_a, int t4) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * t4;
    *reinterpret_cast<uint32_t*>(base + (size_t)row_a * stride + c) =
        pack_bf16(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(base + (size_t)(row_a + 8) * stride + c) =
        pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ---- dq: one block per (128 queries, query head, batch row)

constexpr int kDqRows = 128;  // queries per block: 64 a consumer warpgroup
constexpr int kDqKeys = 64;   // keys per K or V tile
constexpr int kDqBox = kDqRows * 128;   // a TMA box of Q or dO: 16 KB
constexpr int kDqKBox = kDqKeys * 128;  // a TMA box of K or V: 8 KB
constexpr int kDqStage = 4 * kDqKBox;   // K then V, two boxes each
constexpr int kDqSmem = 4 * kDqBox + kTcStages * kDqStage
    + kTcStages * kDqKeys * 4 + (2 * kTcStages + 1) * 8 + 1024;
static_assert(kDqSmem <= 232448, "more shared memory than a block has");

// Thread 0 loads Q and dO once and streams the 64-key K and V tiles (and
// their segment ids) through the ring. Warpgroup wg owns queries 64 wg ..
// 64 wg + 63 of the block. Per tile:
// S = Q K^T and dP = dO V^T (m64n64k16 from shared memory, K-major), then
// P = 2^(S scale log2 e - lse log2 e) and dS = (dP - di) P scale in
// registers, dS rounded to bf16 as the A operand of dQ += dS K (K read
// MN-major from the same swizzled tile).
__global__ void __launch_bounds__(kTcThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, TcParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + 2 * kDqBox;
  uint8_t* kvs = dos + 2 * kDqBox;  // stage st: K, then V at + 2 kDqKBox
  int* segk = reinterpret_cast<int*>(kvs + kTcStages * kDqStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(segk + kTcStages * kDqKeys);
  uint64_t* qbar = full + kTcStages;
  int* taken = reinterpret_cast<int*>(qbar + 1);  // releases, per stage

  // the longest causal rows first: the last blocks to start are short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kDqRows;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.h_kv);
  const int n_tiles = (p.causal ? q0 + kDqRows : p.s) / kDqKeys;

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
    uint8_t* ks = kvs + st * kDqStage;
    const int kv0 = t * kDqKeys;
    mbar_expect_tx(&full[st], kDqStage + (p.seg ? kDqKeys * 4 : 0));
    tma_load_4d(ks, &tk, &full[st], 0, hk, kv0, bi);
    tma_load_4d(ks + kDqKBox, &tk, &full[st], 64, hk, kv0, bi);
    tma_load_4d(ks + 2 * kDqKBox, &tv, &full[st], 0, hk, kv0, bi);
    tma_load_4d(ks + 3 * kDqKBox, &tv, &full[st], 64, hk, kv0, bi);
    if (p.seg)
      bulk_load(segk + st * kDqKeys, p.seg + (size_t)bi * p.s + kv0,
                kDqKeys * 4, &full[st]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, 4 * kDqBox);
    tma_load_4d(qs, &tq, qbar, 0, hi, q0, bi);
    tma_load_4d(qs + kDqBox, &tq, qbar, 64, hi, q0, bi);
    tma_load_4d(dos, &tdo, qbar, 0, hi, q0, bi);
    tma_load_4d(dos + kDqBox, &tdo, qbar, 64, hi, q0, bi);
    for (int t = 0; t < n_tiles && t < kTcStages; ++t) load_tile(t);
  }

  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = q0 + 64 * wg + 16 * (warp & 3) + g, row_b = row_a + 8;
  const int seg_a = p.seg ? p.seg[(size_t)bi * p.s + row_a] : 1;
  const int seg_b = p.seg ? p.seg[(size_t)bi * p.s + row_b] : 1;
  const float* lse_h = p.lse + ((size_t)bi * p.h + hi) * p.s;
  const float* di_h = p.di + ((size_t)bi * p.h + hi) * p.s;
  const float lse_a = lse_h[row_a] * kLog2e, lse_b = lse_h[row_b] * kLog2e;
  const float di_a = di_h[row_a], di_b = di_h[row_b];
  const float scale_log2 = p.scale * kLog2e;

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  const uint64_t dqd0 = sw128_desc(qs + wg * 64 * 128);
  const uint64_t ddo0 = sw128_desc(dos + wg * 64 * 128);
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTcStages;
    uint8_t* ks = kvs + st * kDqStage;
    const int* sk = segk + st * kDqKeys;
    const int kv0 = t * kDqKeys;
    mbar_wait(&full[st], (t / kTcStages) & 1);

    float sc[32], dp[32];
    const uint64_t dqd = opaque(dqd0), ddo = opaque(ddo0);
    const uint64_t dk = sw128_desc(ks), dv = sw128_desc(ks + 2 * kDqKBox);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(sc, dqd + kslice(kk, kDqBox), dk + kslice(kk, kDqKBox),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(dp, ddo + kslice(kk, kDqBox), dv + kslice(kk, kDqKBox),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // sum 8j + u: row (u & 2 ? b : a), key kv0 + 16j + 8 (u >> 2) + 2 t4 +
    // (u & 1); the causal test only where the tile reaches the diagonal
    const bool diag = p.causal && kv0 + kDqKeys > q0;
    uint32_t sf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = 16 * j + 8 * (u >> 2) + 2 * t4 + (u & 1);
        const bool b_row = u & 2;
        const int sg = p.seg ? sk[c] : 1;
        const bool ok = sg == (b_row ? seg_b : seg_a)
            && (!diag || kv0 + c <= (b_row ? row_b : row_a));
        const float pv = ok ? ex2(sc[8 * j + u] * scale_log2
                                  - (b_row ? lse_b : lse_a)) : 0.f;
        ds[u] = (dp[8 * j + u] - (b_row ? di_b : di_a)) * pv * p.scale;
      }
      sf[j][0] = pack_bf16(ds[0], ds[1]);
      sf[j][1] = pack_bf16(ds[2], ds[3]);
      sf[j][2] = pack_bf16(ds[4], ds[5]);
      sf[j][3] = pack_bf16(ds[6], ds[7]);
    }

    // dQ += dS K: K's rows are the contracted keys (2048 bytes per 16),
    // d runs along them, read MN-major (box 1, d 64-127, 8 KB on)
    const uint64_t dkt = sw128_mn_desc(ks, kDqKBox);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs_n128<1>(dq, sf[j], dkt + j * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_regs(sf[j]);
    if ((threadIdx.x & 127) == 0) release<kTcStages>(taken, st, t, n_tiles,
                                                  load_tile);
  }

  store_rows(dq, static_cast<__nv_bfloat16*>(p.out0)
                     + ((size_t)bi * p.s * p.h + hi) * 128,
             (size_t)p.h * 128, row_a, t4);
}

// ---- dk, dv: one block per (128 keys, kv head, batch row)

constexpr int kKvRows = 128;  // keys per block: 64 a consumer warpgroup
constexpr int kKvStep = 64;   // queries per Q or dO tile
constexpr int kKvBox = kKvRows * 128;   // a TMA box of K or V: 16 KB
constexpr int kKvQBox = kKvStep * 128;  // a TMA box of Q or dO: 8 KB
constexpr int kKvStage = 4 * kKvQBox;      // Q then dO, two boxes each
constexpr int kKvVecs = 3 * kKvStep * 4;   // lse, di, the segment ids
constexpr int kKvSmem = 4 * kKvBox + kTcStages * (kKvStage + kKvVecs)
    + (2 * kTcStages + 1) * 8 + 1024;
static_assert(kKvSmem <= 232448, "more shared memory than a block has");

// Thread 0 loads K and V once, then walks the kv group's query heads in
// order and, for each, the 64-query tiles from the causal diagonal to the
// end, streaming Q, dO and the tile's lse,
// di and segment ids through the ring. Warpgroup wg owns keys 64 wg ..
// 64 wg + 63 of the block. Per tile: S^T = K Q^T and dP^T = V dO^T
// (m64n64k16 from shared memory, K-major), P^T and dS^T in registers,
// rounded to bf16 as the A operands of dV += P^T dO and dK += dS^T Q (dO
// and Q read MN-major from the same swizzled tiles); dk and dv stay in
// float32 registers and are written once.
__global__ void __launch_bounds__(kTcThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, TcParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + 2 * kKvBox;
  uint8_t* qd = vs + 2 * kKvBox;  // stage st at qd + st kKvStage
  // stage st's lse, di and query segment ids at vecs + st kKvVecs
  uint8_t* vecs = qd + kTcStages * kKvStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(vecs + kTcStages * kKvVecs);
  uint64_t* kvbar = full + kTcStages;
  int* taken = reinterpret_cast<int*>(kvbar + 1);  // releases, per stage

  const int k0 = blockIdx.x * kKvRows;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int rep = p.h / p.h_kv;
  const int q_begin = p.causal ? k0 : 0;
  const int per_head = (p.s - q_begin) / kKvStep;
  const int n_tiles = rep * per_head;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(&full[st], 1);
      taken[st] = 0;
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  // thread 0 loads the resident tiles and the first kTcStages tiles; each
  // later tile is loaded by the warpgroup that releases its stage second,
  // so neither waits for the other
  auto load_tile = [&](int t) {
    const int st = t % kTcStages;
    const int hq = hk * rep + t / per_head;
    const int q0 = q_begin + (t % per_head) * kKvStep;
    uint8_t* qt = qd + st * kKvStage;
    float* lse_s = reinterpret_cast<float*>(vecs + st * kKvVecs);
    const size_t row = ((size_t)bi * p.h + hq) * p.s + q0;
    mbar_expect_tx(&full[st], 4 * kKvQBox + (p.seg ? 3 : 2) * kKvStep * 4);
    tma_load_4d(qt, &tq, &full[st], 0, hq, q0, bi);
    tma_load_4d(qt + kKvQBox, &tq, &full[st], 64, hq, q0, bi);
    tma_load_4d(qt + 2 * kKvQBox, &tdo, &full[st], 0, hq, q0, bi);
    tma_load_4d(qt + 3 * kKvQBox, &tdo, &full[st], 64, hq, q0, bi);
    bulk_load(lse_s, p.lse + row, kKvStep * 4, &full[st]);
    bulk_load(lse_s + kKvStep, p.di + row, kKvStep * 4, &full[st]);
    if (p.seg)
      bulk_load(lse_s + 2 * kKvStep, p.seg + (size_t)bi * p.s + q0,
                kKvStep * 4, &full[st]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, 4 * kKvBox);
    tma_load_4d(ks, &tk, kvbar, 0, hk, k0, bi);
    tma_load_4d(ks + kKvBox, &tk, kvbar, 64, hk, k0, bi);
    tma_load_4d(vs, &tv, kvbar, 0, hk, k0, bi);
    tma_load_4d(vs + kKvBox, &tv, kvbar, 64, hk, k0, bi);
    for (int t = 0; t < n_tiles && t < kTcStages; ++t) load_tile(t);
  }

  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key_a = k0 + 64 * wg + 16 * (warp & 3) + g, key_b = key_a + 8;
  const int seg_a = p.seg ? p.seg[(size_t)bi * p.s + key_a] : 1;
  const int seg_b = p.seg ? p.seg[(size_t)bi * p.s + key_b] : 1;
  const float scale_log2 = p.scale * kLog2e;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const uint64_t dkd0 = sw128_desc(ks + wg * 64 * 128);
  const uint64_t dvd0 = sw128_desc(vs + wg * 64 * 128);
  mbar_wait(kvbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTcStages;
    const int q0 = q_begin + (t % per_head) * kKvStep;
    uint8_t* qt = qd + st * kKvStage;
    const float* lse_s =
        reinterpret_cast<const float*>(vecs + st * kKvVecs);
    const float* di_s = lse_s + kKvStep;
    const int* segq = reinterpret_cast<const int*>(lse_s + 2 * kKvStep);
    mbar_wait(&full[st], (t / kTcStages) & 1);

    float sc[32], dp[32];
    const uint64_t dkd = opaque(dkd0), dvd = opaque(dvd0);
    const uint64_t dq = sw128_desc(qt), ddo = sw128_desc(qt + 2 * kKvQBox);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(sc, dkd + kslice(kk, kKvBox), dq + kslice(kk, kKvQBox),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64(dp, dvd + kslice(kk, kKvBox), ddo + kslice(kk, kKvQBox),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // sum 8j + u: key (u & 2 ? key_b : key_a), query q0 + 16j + 8 (u >> 2)
    // + 2 t4 + (u & 1); the causal test only where the tile reaches the
    // diagonal
    const bool diag = p.causal && q0 < k0 + kKvRows;
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pv[8], ds[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = 16 * j + 8 * (u >> 2) + 2 * t4 + (u & 1);
        const bool b_row = u & 2;
        const int sg = p.seg ? segq[c] : 1;
        const bool ok = sg == (b_row ? seg_b : seg_a)
            && (!diag || (b_row ? key_b : key_a) <= q0 + c);
        pv[u] = ok ? ex2(sc[8 * j + u] * scale_log2 - lse_s[c] * kLog2e)
                   : 0.f;
        ds[u] = (dp[8 * j + u] - di_s[c]) * pv[u] * p.scale;
      }
      pf[j][0] = pack_bf16(pv[0], pv[1]);
      pf[j][1] = pack_bf16(pv[2], pv[3]);
      pf[j][2] = pack_bf16(pv[4], pv[5]);
      pf[j][3] = pack_bf16(pv[6], pv[7]);
      sf[j][0] = pack_bf16(ds[0], ds[1]);
      sf[j][1] = pack_bf16(ds[2], ds[3]);
      sf[j][2] = pack_bf16(ds[4], ds[5]);
      sf[j][3] = pack_bf16(ds[6], ds[7]);
    }

    // dV += P^T dO and dK += dS^T Q: the rows of dO and Q are the
    // contracted queries (2048 bytes per 16), d runs along them, read
    // MN-major (box 1, d 64-127, 8 KB on)
    const uint64_t dot = sw128_mn_desc(qt + 2 * kKvQBox, kKvQBox);
    const uint64_t qtt = sw128_mn_desc(qt, kKvQBox);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs_n128<1>(dv, pf[j], dot + j * 128);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs_n128<1>(dk, sf[j], qtt + j * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fence_regs(pf[j]);
      fence_regs(sf[j]);
    }
    if ((threadIdx.x & 127) == 0) release<kTcStages>(taken, st, t, n_tiles,
                                                  load_tile);
  }

  const size_t off = ((size_t)bi * p.s * p.h_kv + hk) * 128;
  const size_t stride = (size_t)p.h_kv * 128;
  store_rows(dk, static_cast<__nv_bfloat16*>(p.out0) + off, stride, key_a,
             t4);
  store_rows(dv, static_cast<__nv_bfloat16*>(p.out1) + off, stride, key_a,
             t4);
}

// The four tensor maps of q, dout (boxes of `q_rows` tokens) and k, v
// (boxes of `kv_rows`).
int encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                const void* v, const void* dout, int b, int s, int h,
                int h_kv, int q_rows, int kv_rows) {
  int code = encode_bshd(&maps[0], q, b, s, h, 128, q_rows);
  if (!code) code = encode_bshd(&maps[1], dout, b, s, h, 128, q_rows);
  if (!code) code = encode_bshd(&maps[2], k, b, s, h_kv, 128, kv_rows);
  if (!code) code = encode_bshd(&maps[3], v, b, s, h_kv, 128, kv_rows);
  return code;
}

template <typename Kernel>
int launch_tc(Kernel kernel, bool& sized, int smem, dim3 grid,
              const CUtensorMap (&maps)[4], const TcParams& p,
              cudaStream_t stream) {
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  kernel<<<grid, kTcThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                             maps[3], p);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Params& p, int is_bf16, cudaStream_t stream) {
  const dim3 grid((p.s + kRows - 1) / kRows, p.h_kv, p.b);
  if (is_bf16)
    return launch(dkv_bf16_kernel<D>, grid, 128, dkv_bf16_smem_bytes<D>(), p, stream);
  return launch(dkv_f32_kernel<D>, grid, 256, dkv_f32_smem_bytes<D>(), p, stream);
}

template <int D>
int launch_dq(const Params& p, int is_bf16, cudaStream_t stream) {
  const dim3 grid((p.s + kRows - 1) / kRows, p.h, p.b);
  if (is_bf16)
    return launch(dq_bf16_kernel<D>, grid, 128, dq_bf16_smem_bytes<D>(), p, stream);
  return launch(dq_f32_kernel<D>, grid, 256, dq_f32_smem_bytes<D>(), p, stream);
}

int check(int b, int s, int h, int h_kv) {
  if (h_kv <= 0 || h % h_kv != 0 || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// as an int: 0 when the launch was accepted, cudaErrorInvalidValue for a
// head width outside {16, 32, 64, 128}, a head count that is not a multiple
// of the kv head count, or a grid the card cannot hold. Nothing is launched
// when b, s or h is 0. Every pointer is to a contiguous tensor: q, dout, dq
// [b, s, h, d]; k, v, dk, dv [b, s, h_kv, d] (all bf16 or all float32);
// lse, di [b, h, s] float32; seg [b, s] int32 or null.

// dk and dv: every element written, each once.
int fa_backward_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* di,
                    const int* seg, void* dk, void* dv, int b, int s, int h,
                    int h_kv, int d, float scale, int causal, int is_bf16,
                    void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (int err = check(b, s, h, h_kv)) return err;
  const Params p{q, k, v, dout, lse, di, seg, nullptr, dk, dv,
                 b, s, h, h_kv, scale, causal};
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_dkv<16>(p, is_bf16, st);
    case 32: return launch_dkv<32>(p, is_bf16, st);
    case 64: return launch_dkv<64>(p, is_bf16, st);
    case 128: return launch_dkv<128>(p, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq: every element written, each once.
int fa_backward_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di,
                   const int* seg, void* dq, int b, int s, int h, int h_kv,
                   int d, float scale, int causal, int is_bf16, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (int err = check(b, s, h, h_kv)) return err;
  const Params p{q, k, v, dout, lse, di, seg, dq, nullptr, nullptr,
                 b, s, h, h_kv, scale, causal};
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_dq<16>(p, is_bf16, st);
    case 32: return launch_dq<32>(p, is_bf16, st);
    case 64: return launch_dq<64>(p, is_bf16, st);
    case 128: return launch_dq<128>(p, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The `wgmma` variants: bf16, d = 128, s a multiple of 128, every pointer
// 16-byte aligned (TMA reads q, k, v, dout; lse, di and the segment ids
// are copied in bulk). The same arguments and codes as fa_backward_dkv and
// fa_backward_dq, less is_bf16, or a descriptor-encoding code that
// fa_bwd_error_string names.
int fa_backward_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       const int* seg, void* dk, void* dv, int b, int s,
                       int h, int h_kv, int d, float scale, int causal,
                       void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (int err = check(b, s, h, h_kv)) return err;
  if (d != 128 || s % kKvRows) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (int code = encode_maps(maps, q, k, v, dout, b, s, h, h_kv, kKvStep,
                             kKvRows))
    return code;
  static bool sized = false;
  const TcParams p{lse, di, seg, dk, dv, s, h, h_kv, scale, causal};
  return launch_tc(dkv_wgmma_kernel, sized, kKvSmem,
                   dim3(s / kKvRows, h_kv, b), maps, p, (cudaStream_t)stream);
}

int fa_backward_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      const int* seg, void* dq, int b, int s, int h,
                      int h_kv, int d, float scale, int causal,
                      void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (int err = check(b, s, h, h_kv)) return err;
  if (d != 128 || s % kDqRows) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (int code = encode_maps(maps, q, k, v, dout, b, s, h, h_kv, kDqRows,
                             kDqKeys))
    return code;
  static bool sized = false;
  const TcParams p{lse, di, seg, dq, nullptr, s, h, h_kv, scale, causal};
  return launch_tc(dq_wgmma_kernel, sized, kDqSmem, dim3(s / kDqRows, h, b),
                   maps, p, (cudaStream_t)stream);
}

const char* fa_bwd_error_string(int code) { return hopper_error_string(code); }

}  // extern "C"
