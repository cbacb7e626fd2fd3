// Fused GGNN message passing (forward) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` of deepdfa_tpu/ops/fused_ggnn.py
// (launched by `_fused_ggnn`, public `fused_ggnn`). It computes n_steps
// rounds of
//     msg = h @ ew + eb
//     agg[r] = sum of msg[s] over the edges (s -> r), in edge-list order
//     xp = agg @ xw + xb,  hp = h @ hw + hb          (r|z|n column blocks)
//     r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//     h' = (1 - z) * n + z * h
// in float32 on the FFMA units (no TF32, no tensor cores).
//
// What bounds it on this card. At the serving width D = 128 a round does
// 2*N*D*D FLOPs for the edge linear and 2*2*N*D*3D for the two GRU
// products, against a few MB of state that stays in the 50 MB L2: it is
// bound by FP32 operations, not bytes. The TPU kept h in VMEM across the
// rounds of one sequential grid; on Hopper blocks run in no order and
// nothing carries over between them, and the aggregation of a node needs
// the messages of arbitrary other nodes, so every round needs a grid-wide
// barrier after the edge linear.
//
// What the design does about that. Three kernels, all launched on the
// caller's stream, none synchronising:
//   1. csr_kernel (once per call): row_ptr[v] = first edge whose receiver
//      is >= v, by binary search over the receiver-sorted edge list.
//   2. linear_kernel (per round): msg = h @ ew + eb, a tile of 16 rows by
//      128 columns per block, weight rows staged through shared memory.
//   3. gru_round_kernel (per round): for its 16 rows, one warp per row sums
//      msg[s] over the row's CSR segment in edge-list order (no float
//      atomics, so reruns are bit-stable and the sum order is the JAX
//      reference's), with sender indices and rows loaded ahead of the adds;
//      then both 3-gate products run from shared memory and
//      the GRU epilogue writes h' into the other buffer of a ping-pong pair.
// Each launch is checked with cudaGetLastError by the caller.
//
// Known imbalance, kept on purpose: batch_np points every padding edge at
// the padding sink node, so one CSR segment can hold thousands of edges,
// and the warp that owns it adds them one after the other. They are part of
// the function and are summed in order like any other segment; runs of one
// sender reuse one loaded row (see aggregate_row_vec4), but the chain of
// adds stays serial. Balancing it across warps is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 16;      // rows of h per block
constexpr int kCols = 128;     // output columns per block
constexpr int kChunk = 8;      // weight rows staged per shared-memory pass

__global__ void csr_kernel(const int* __restrict__ receivers, int n_edges,
                           int n_nodes, int* __restrict__ row_ptr) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v > n_nodes) return;
  int lo = 0, hi = n_edges;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (receivers[mid] < v) lo = mid + 1; else hi = mid;
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

// out[n, d_out] = a[n, d_in] @ w[d_in, d_out] + b[d_out]
__global__ void __launch_bounds__(kThreads)
linear_kernel(const float* __restrict__ a, const float* __restrict__ w,
              const float* __restrict__ b, float* __restrict__ out, int n,
              int d_in, int d_out) {
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
      if (row < n && col < d_out)
        out[(size_t)row * d_out + col] = acc[r][q] + b[col];
    }
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// Sum of msg[senders[e]] over edges [beg, end), in edge-list order, into
// dst[0, d); called by a whole warp. A lane keeps four consecutive columns
// (one float4) of each 128-wide column block. The warp loads 32 sender
// indices at once. When all 32 name one sender (the padding sink's segment:
// batch_np's padding edges are all sink -> sink), that row is loaded once
// and added 32 times, in order, so the segment is bound by the add chain;
// otherwise 8 row loads are issued before they are added. Either way every
// message is added in edge-list order. Needs d % 4 == 0: the wrapper pads
// other widths with zero columns.
__device__ __forceinline__ void aggregate_row_vec4(
    const float* __restrict__ msg, const int* __restrict__ senders, int beg,
    int end, int d, int lane, float* dst) {
  for (int cb = 0; cb < d; cb += 128) {
    const int col = cb + 4 * lane;
    const bool live = col < d;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    int row_s = -1;  // sender whose row `row` holds
    for (int base = beg; base < end; base += 32) {
      const int cnt = min(32, end - base);
      const int my_s = lane < cnt ? senders[base + lane] : 0;
      const int s0 = __shfl_sync(0xffffffffu, my_s, 0);
      if (__all_sync(0xffffffffu, cnt == 32 && my_s == s0)) {
        if (s0 != row_s) {
          row = live ? *reinterpret_cast<const float4*>(msg + (size_t)s0 * d + col)
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
                     ? *reinterpret_cast<const float4*>(msg + (size_t)s * d + col)
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
      dst[col] = acc.x;
      dst[col + 1] = acc.y;
      dst[col + 2] = acc.z;
      dst[col + 3] = acc.w;
    }
  }
}

// One GRU round for kRows rows and kCols columns of h'.
__global__ void __launch_bounds__(kThreads)
gru_round_kernel(const float* __restrict__ h, const float* __restrict__ msg,
                 const int* __restrict__ row_ptr,
                 const int* __restrict__ senders,
                 const float* __restrict__ xw, const float* __restrict__ xb,
                 const float* __restrict__ hw, const float* __restrict__ hb,
                 float* __restrict__ h_out, int n, int d) {
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
  // one edge after the other, in edge-list order.
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int row = row0 + rr;
    const int beg = row < n ? row_ptr[row] : 0;
    const int end = row < n ? row_ptr[row + 1] : 0;
    aggregate_row_vec4(msg, senders, beg, end, d, lane, agg_s + rr * d);
  }

  // Both 3-gate products: thread (ty, tx) owns rows ty, ty + 8 and columns
  // col0 + tx + 32 q of each of the r, z, n blocks.
  const int tx = lane;
  const int ty = warp;
  const int d3 = 3 * d;
  float ax[2][3][4] = {};
  float ah[2][3][4] = {};
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = ty + 8 * r;
    const int row = row0 + rr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + tx + 32 * q;
      if (row >= n || col >= d) continue;
      const float xr = ax[r][0][q] + xb[col];
      const float xz = ax[r][1][q] + xb[d + col];
      const float xn = ax[r][2][q] + xb[2 * d + col];
      const float hr = ah[r][0][q] + hb[col];
      const float hz = ah[r][1][q] + hb[d + col];
      const float hn = ah[r][2][q] + hb[2 * d + col];
      const float rg = sigmoid_f(xr + hr);
      const float zg = sigmoid_f(xz + hz);
      const float ng = tanhf(xn + rg * hn);
      h_out[(size_t)row * d + col] = (1.f - zg) * ng + zg * h_s[rr * d + col];
    }
  }
}

size_t linear_smem(int d_in) {
  return sizeof(float) * ((size_t)kRows * d_in + (size_t)kChunk * kCols);
}

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

}  // namespace

extern "C" {

// Every entry point launches one kernel on `stream` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.

int ggnn_csr(const int* receivers, int n_edges, int n_nodes, int* row_ptr,
             void* stream) {
  const int threads = 256;
  const int blocks = (n_nodes + 1 + threads - 1) / threads;
  csr_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(receivers, n_edges,
                                                          n_nodes, row_ptr);
  return (int)cudaGetLastError();
}

int ggnn_linear(const float* a, const float* w, const float* b, float* out,
                int n, int d_in, int d_out, void* stream) {
  const size_t smem = linear_smem(d_in);
  cudaError_t err = allow_smem(linear_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, (d_out + kCols - 1) / kCols);
  linear_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a, w, b, out, n,
                                                               d_in, d_out);
  return (int)cudaGetLastError();
}

int ggnn_gru_round(const float* h, const float* msg, const int* row_ptr,
                   const int* senders, const float* xw, const float* xb,
                   const float* hw, const float* hb, float* h_out, int n,
                   int d, void* stream) {
  if (d % 4 != 0) return (int)cudaErrorInvalidValue;  // float4 edge sum
  const size_t smem = round_smem(d);
  cudaError_t err = allow_smem(gru_round_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, (d + kCols - 1) / kCols);
  gru_round_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      h, msg, row_ptr, senders, xw, xb, hw, hb, h_out, n, d);
  return (int)cudaGetLastError();
}

// Largest width both per-round kernels can take (shared memory per block).
int ggnn_max_width(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t fixed = sizeof(float) * 2 * (size_t)kChunk * 3 * kCols;
  if ((size_t)optin <= fixed) return 0;
  return (int)(((size_t)optin - fixed) / (sizeof(float) * 2 * kRows));
}

const char* ggnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
