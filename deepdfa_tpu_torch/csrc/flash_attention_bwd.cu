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
// bf16 runs on `mma.sync.m16n8k16` with float32 accumulators, as the
// forward: the score fragments of one product are laid out as the A operand
// of the next, so P and dS are rounded to bf16 in registers and never
// stored; every B operand is a 32-bit shared load from a tile stored
// row-major or transposed as that product needs it. The inner tile is 32
// wide so that at d = 128 the two 16 x 128 float32 accumulators (128
// registers) and the score fragments fit a thread's 255 registers without
// spilling. Float32 (the test-size model) takes FFMA kernels of the same
// structure: four threads per row, P and dS through shared memory.
// `wgmma`, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

const char* fa_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
