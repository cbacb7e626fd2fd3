// Device code shared by the GGNN forward (fused_ggnn.cu), its training
// backward (fused_ggnn_bwd.cu) and the whole-model forward (megabatch.cu):
// the FFMA variant's tile sizes, the CSR row-pointer search, the FFMA
// row-tile linear, the in-order float4 edge sum, the two fused 3-gate GRU
// products and the GRU round kernel built from them, and gru_cell, the
// FFMA arithmetic of one GRU column that the tensor-core variant
// (ggnn_tc.cuh) also takes for the padding sink's rows.
//
// What bounds the FFMA variant: its products run on the FP32 units from
// shared memory (each thread keeps 2 rows x 4 columns: shared-memory
// bandwidth sets the pace, ~12 TFLOP/s at width 128), and one warp adds
// the padding sink's segment serially (17k adds at the megabatch shape,
// a row loaded once per 32 equal senders). It is kept for widths the
// tensor-core kernels are not written for, and as the yardstick the smoke
// times beside them. Each source includes this header once and is built
// into its own library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 16;      // rows of h per block
constexpr int kCols = 128;     // output columns per block
constexpr int kChunk = 8;      // weight rows staged per shared-memory pass

// row_ptr[v] = first edge whose key is >= v, by binary search over a key
// list sorted ascending (receivers for the forward's CSR, senders for the
// backward's CSC).
__global__ void csr_kernel(const int* __restrict__ keys, int n_edges,
                           int n_nodes, int* __restrict__ row_ptr) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v > n_nodes) return;
  int lo = 0, hi = n_edges;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  row_ptr[v] = lo;
}

// Copy kRows rows of a [n, d] matrix into shared memory, zero past n.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float* dst, int row0, int n,
                                          int d) {
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    int r = i / d;
    int row = row0 + r;
    dst[i] = row < n ? src[(size_t)row * d + (i - r * d)] : 0.f;
  }
}

// out[n, d_out] (+)= a[n, d_in] @ w[d_in, d_out] (+ b[d_out]): a tile of
// kRows rows by kCols columns per block. `b` may be null; with `accumulate`
// the product is added to what `out` holds.
__global__ void __launch_bounds__(kThreads)
linear_kernel(const float* __restrict__ a, const float* __restrict__ w,
              const float* __restrict__ b, float* __restrict__ out, int n,
              int d_in, int d_out, int accumulate) {
  extern __shared__ float smem[];
  float* a_s = smem;                  // [kRows][d_in]
  float* w_s = smem + kRows * d_in;   // [kChunk][kCols]
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;   // rows ty and ty + 8

  load_rows(a, a_s, row0, n, d_in);
  float acc[2][4] = {};
  for (int k0 = 0; k0 < d_in; k0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      int kk = i / kCols, c = i - kk * kCols;
      int k = k0 + kk, col = col0 + c;
      w_s[i] = (k < d_in && col < d_out) ? w[(size_t)k * d_out + col] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kChunk, d_in - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float a0 = a_s[ty * d_in + k0 + kk];
      const float a1 = a_s[(ty + 8) * d_in + k0 + kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float wv = w_s[kk * kCols + tx + 32 * q];
        acc[0][q] = fmaf(a0, wv, acc[0][q]);
        acc[1][q] = fmaf(a1, wv, acc[1][q]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + ty + 8 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + tx + 32 * q;
      if (row < n && col < d_out) {
        const size_t o = (size_t)row * d_out + col;
        float v = acc[r][q];
        if (b != nullptr) v += b[col];
        out[o] = accumulate ? out[o] + v : v;
      }
    }
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// The GRU update of one column from the gate products without their biases
// (ax = agg @ xw, ah = h @ hw, r|z|n): one function, so every kernel that
// computes a row in the FFMA arithmetic rounds it alike.
__device__ __forceinline__ float gru_cell(float ax_r, float ax_z, float ax_n,
                                          float ah_r, float ah_z, float ah_n,
                                          const float* __restrict__ xb,
                                          const float* __restrict__ hb,
                                          int col, int d, float h) {
  const float xr = ax_r + xb[col];
  const float xz = ax_z + xb[d + col];
  const float xn = ax_n + xb[2 * d + col];
  const float hr = ah_r + hb[col];
  const float hz = ah_z + hb[d + col];
  const float hn = ah_n + hb[2 * d + col];
  const float rg = sigmoid_f(xr + hr);
  const float zg = sigmoid_f(xz + hz);
  const float ng = tanhf(xn + rg * hn);
  return (1.f - zg) * ng + zg * h;
}

// Sum of src[idx[e]] over entries [beg, end) of an index list, in list
// order; called by a whole warp (the forward sums messages over a
// receiver's CSR segment, the backward cotangents over a sender's CSC
// segment). A lane keeps four consecutive columns (one float4) of each
// 128-wide column block. The warp loads 32 indices at once. When all 32 name
// one row (the padding sink's segment: batch_np's padding edges are all
// sink -> sink), that row is loaded once and added 32 times, in order, so
// the segment is bound by the add chain; otherwise 8 row loads are started
// before they are added. Either way every row is added in list order. The
// sum goes to shared memory `sdst`, to global memory `gdst`, or both (each
// may be null). Needs d % 4 == 0: the wrappers pad other widths with zero
// columns.
__device__ __forceinline__ void aggregate_row_vec4(
    const float* __restrict__ src, const int* __restrict__ idx, int beg,
    int end, int d, int lane, float* sdst, float* __restrict__ gdst) {
  for (int cb = 0; cb < d; cb += 128) {
    const int col = cb + 4 * lane;
    const bool live = col < d;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    int row_s = -1;  // index whose row `row` holds
    for (int base = beg; base < end; base += 32) {
      const int cnt = min(32, end - base);
      const int my_s = lane < cnt ? idx[base + lane] : 0;
      const int s0 = __shfl_sync(0xffffffffu, my_s, 0);
      if (__all_sync(0xffffffffu, cnt == 32 && my_s == s0)) {
        if (s0 != row_s) {
          row = live ? *reinterpret_cast<const float4*>(src + (size_t)s0 * d + col)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
          row_s = s0;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          acc.x += row.x;
          acc.y += row.y;
          acc.z += row.z;
          acc.w += row.w;
        }
        continue;
      }
      for (int j0 = 0; j0 < cnt; j0 += 8) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = __shfl_sync(0xffffffffu, my_s, (j0 + j) & 31);
          v[j] = (live && j0 + j < cnt)
                     ? *reinterpret_cast<const float4*>(src + (size_t)s * d + col)
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
    }
    if (live) {
      if (sdst != nullptr) {
        sdst[col] = acc.x;
        sdst[col + 1] = acc.y;
        sdst[col + 2] = acc.z;
        sdst[col + 3] = acc.w;
      }
      if (gdst != nullptr) *reinterpret_cast<float4*>(gdst + col) = acc;
    }
  }
}

// Both 3-gate GRU products for the kRows rows staged in agg_s and h_s
// ([kRows][d] each): thread (ty, tx) = (warp, lane) gets, for rows ty and
// ty + 8, ax[r][g][q] = (agg @ xw)[., g*d + col0 + tx + 32q] and ah likewise
// for h @ hw, without the biases. Weight rows go through wx_s and wh_s
// ([kChunk][3][kCols] each). Starts with a barrier, so the caller's writes
// to agg_s and h_s are visible.
__device__ __forceinline__ void gate_products(
    const float* agg_s, const float* h_s, const float* __restrict__ xw,
    const float* __restrict__ hw, float* wx_s, float* wh_s, int d, int col0,
    float ax[2][3][4], float ah[2][3][4]) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int d3 = 3 * d;
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * 3 * kCols; i += kThreads) {
      int kk = i / (3 * kCols);
      int rem = i - kk * 3 * kCols;
      int g = rem / kCols, c = rem - g * kCols;
      int k = k0 + kk, col = col0 + c;
      bool ok = k < d && col < d;
      size_t off = (size_t)k * d3 + g * d + col;
      wx_s[i] = ok ? xw[off] : 0.f;
      wh_s[i] = ok ? hw[off] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kChunk, d - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const int k = k0 + kk;
      const float a0 = agg_s[ty * d + k], a1 = agg_s[(ty + 8) * d + k];
      const float b0 = h_s[ty * d + k], b1 = h_s[(ty + 8) * d + k];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = (kk * 3 + g) * kCols + tx + 32 * q;
          const float wx = wx_s[idx], wh = wh_s[idx];
          ax[0][g][q] = fmaf(a0, wx, ax[0][g][q]);
          ax[1][g][q] = fmaf(a1, wx, ax[1][g][q]);
          ah[0][g][q] = fmaf(b0, wh, ah[0][g][q]);
          ah[1][g][q] = fmaf(b1, wh, ah[1][g][q]);
        }
      }
    }
  }
}

// One GRU round for kRows rows and kCols columns of h'. `agg_bank` may be
// null; otherwise each row's aggregate is written there too (training).
__global__ void __launch_bounds__(kThreads)
gru_round_kernel(const float* __restrict__ h, const float* __restrict__ msg,
                 const int* __restrict__ row_ptr,
                 const int* __restrict__ senders,
                 const float* __restrict__ xw, const float* __restrict__ xb,
                 const float* __restrict__ hw, const float* __restrict__ hb,
                 float* __restrict__ h_out, float* __restrict__ agg_bank,
                 int n, int d) {
  extern __shared__ float smem[];
  float* agg_s = smem;                   // [kRows][d]
  float* h_s = agg_s + kRows * d;        // [kRows][d]
  float* wx_s = h_s + kRows * d;         // [kChunk][3][kCols]
  float* wh_s = wx_s + kChunk * 3 * kCols;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  load_rows(h, h_s, row0, n, d);

  // Aggregation: warp w owns rows w and w + 8 and sums each row's segment
  // one edge after the other, in edge-list order. Only the blocks of the
  // first column tile write the bank.
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int row = row0 + rr;
    const int beg = row < n ? row_ptr[row] : 0;
    const int end = row < n ? row_ptr[row + 1] : 0;
    float* bank = (agg_bank != nullptr && blockIdx.y == 0 && row < n)
                      ? agg_bank + (size_t)row * d : nullptr;
    aggregate_row_vec4(msg, senders, beg, end, d, lane, agg_s + rr * d, bank);
  }

  // Both 3-gate products: thread (ty, tx) owns rows ty, ty + 8 and columns
  // col0 + tx + 32 q of each of the r, z, n blocks.
  float ax[2][3][4] = {};
  float ah[2][3][4] = {};
  gate_products(agg_s, h_s, xw, hw, wx_s, wh_s, d, col0, ax, ah);

  const int tx = lane;
  const int ty = warp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = ty + 8 * r;
    const int row = row0 + rr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + tx + 32 * q;
      if (row >= n || col >= d) continue;
      h_out[(size_t)row * d + col] = gru_cell(
          ax[r][0][q], ax[r][1][q], ax[r][2][q], ah[r][0][q], ah[r][1][q],
          ah[r][2][q], xb, hb, col, d, h_s[rr * d + col]);
    }
  }
}

size_t linear_smem(int d_in) {
  return sizeof(float) * ((size_t)kRows * d_in + (size_t)kChunk * kCols);
}

// Shared memory of a kernel that stages agg and h rows plus both gate
// weight chunks (the forward round and the backward gate kernel).
size_t round_smem(int d) {
  return sizeof(float) * (2 * (size_t)kRows * d + 2 * (size_t)kChunk * 3 * kCols);
}

// Raise a kernel's dynamic shared-memory ceiling when a launch needs more
// than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int launch_linear(const float* a, const float* w, const float* b, float* out,
                  int n, int d_in, int d_out, int accumulate,
                  cudaStream_t stream) {
  const size_t smem = linear_smem(d_in);
  cudaError_t err = allow_smem(linear_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, (d_out + kCols - 1) / kCols);
  linear_kernel<<<grid, kThreads, smem, stream>>>(a, w, b, out, n, d_in, d_out,
                                                  accumulate);
  return (int)cudaGetLastError();
}

int launch_gru_round(const float* h, const float* msg, const int* row_ptr,
                     const int* senders, const float* xw, const float* xb,
                     const float* hw, const float* hb, float* h_out,
                     float* agg_bank, int n, int d, cudaStream_t stream) {
  if (d % 4 != 0) return (int)cudaErrorInvalidValue;  // float4 edge sum
  const size_t smem = round_smem(d);
  cudaError_t err = allow_smem(gru_round_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, (d + kCols - 1) / kCols);
  gru_round_kernel<<<grid, kThreads, smem, stream>>>(
      h, msg, row_ptr, senders, xw, xb, hw, hb, h_out, agg_bank, n, d);
  return (int)cudaGetLastError();
}

int launch_csr(const int* keys, int n_edges, int n_nodes, int* row_ptr,
               cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n_nodes + 1 + threads - 1) / threads;
  csr_kernel<<<blocks, threads, 0, stream>>>(keys, n_edges, n_nodes, row_ptr);
  return (int)cudaGetLastError();
}

// Largest width whose kernels fit the per-block shared memory, given the
// bytes a kernel needs per unit of width and its fixed bytes.
int width_limit(size_t per_width, size_t fixed) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if ((size_t)optin <= fixed) return 0;
  return (int)(((size_t)optin - fixed) / per_width);
}

}  // namespace
