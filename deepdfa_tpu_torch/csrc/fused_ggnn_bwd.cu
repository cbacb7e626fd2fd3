// Fused GGNN message passing, training backward, for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_train_kernel` of
// deepdfa_tpu/ops/fused_ggnn.py (launched by `_pallas_train_bwd`, chosen in
// `_fused_ggnn_bwd`). Given the states h_t and aggregates agg_t that the
// training forward banked for t = 0 .. n_steps-1 and the cotangent
// g = dL/dh_out, it runs the reverse rounds t = n_steps-1 .. 0:
//     xp = agg_t @ xw + xb, hp = h_t @ hw + hb, r, z, n as in the forward
//     dz = g(h - n), dn = g(1 - z), dpre_n = dn(1 - n^2), dr = dpre_n hn
//     dpre_r = dr r(1 - r), dpre_z = dz z(1 - z)
//     dxp = [dpre_r | dpre_z | dpre_n],  dhp = [dpre_r | dpre_z | dpre_n r]
//     dagg = dxp @ xw^T;  dh' = g z + dhp @ hw^T
//     dmsg[s] = sum of dagg[r] over the edges (s -> r), in edge-list order
//     dh' += dmsg @ ew^T;  g <- dh'
//     dxw += agg_t^T dxp, dhw += h_t^T dhp, dew += h_t^T dmsg, and the
//     three bias gradients as column sums of dxp, dhp, dmsg
// in float32 on the FFMA units, and returns dL/dh0 and the six weight and
// bias gradients.
//
// What bounds it on this card. A reverse round is 40 N D^2 FLOPs at width
// D (both 3-gate products again, two products with transposed gate
// weights, one with the transposed edge weight, three weight gradients)
// against ~10 N D floats of banked state: at D = 128 it is bound by FP32
// operations. The TPU re-ran the forward inside the kernel to refill a VMEM
// history bank; an 80 GB card keeps the bank from the forward instead, so
// nothing here repeats the edge linear or the edge sum of the forward. The
// TPU accumulated the weight gradients in VMEM across the sequential grid;
// Hopper's blocks run in no order, and float atomics would make the sums
// change from run to run.
//
// What the design does about that. Per reverse round, six launches on the
// caller's stream, none synchronising:
//   1. gate_bwd_kernel: recomputes both 3-gate products for a 16-row tile
//      from the banked agg_t and h_t (the forward's code, so the same
//      values), applies the chain above and writes dxp, dhp and g z.
//   2.-3. linear_kernel with the transposed gate weights: dagg, then
//      dh' += dhp @ hw^T.
//   4. transpose_sum_kernel: one warp per sender sums dagg over its segment
//      of the sender-sorted (CSC) edge list, in edge-list order, with the
//      forward's in-order float4 edge sum.
//   5. linear_kernel: dh' += dmsg @ ew^T.
//   6. wgrad_kernel: the three weight gradients and bias column sums over a
//      fixed partition of the rows into chunks of kWRows; each block adds
//      its 64x64 tile into its chunk's own slot of a partial buffer.
// Once per call: csr_kernel builds the CSC row pointer from the sorted
// senders, and reduce_chunks_kernel sums the partial buffer's chunks in
// chunk order. No float atomics anywhere, so two calls on the same inputs
// return bitwise equal gradients.

#include "ggnn_common.cuh"

namespace {

constexpr int kWTile = 64;    // weight-gradient tile: 64 x 64 outputs
constexpr int kWRows = 512;   // rows of the node axis per chunk
constexpr int kWStep = 16;    // rows staged per shared-memory pass

// Reverse of one GRU round for kRows rows and kCols columns.
__global__ void __launch_bounds__(kThreads)
gate_bwd_kernel(const float* __restrict__ h, const float* __restrict__ agg,
                const float* __restrict__ g, const float* __restrict__ xw,
                const float* __restrict__ xb, const float* __restrict__ hw,
                const float* __restrict__ hb, float* __restrict__ dxp,
                float* __restrict__ dhp, float* __restrict__ dh_out, int n,
                int d) {
  extern __shared__ float smem[];
  float* agg_s = smem;                   // [kRows][d]
  float* h_s = agg_s + kRows * d;        // [kRows][d]
  float* wx_s = h_s + kRows * d;         // [kChunk][3][kCols]
  float* wh_s = wx_s + kChunk * 3 * kCols;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;

  load_rows(h, h_s, row0, n, d);
  load_rows(agg, agg_s, row0, n, d);
  float ax[2][3][4] = {};
  float ah[2][3][4] = {};
  gate_products(agg_s, h_s, xw, hw, wx_s, wh_s, d, col0, ax, ah);

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const size_t d3 = 3 * (size_t)d;
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
      const float hv = h_s[rr * d + col];
      const float gv = g[(size_t)row * d + col];
      const float dz = gv * (hv - ng);
      const float dn = gv * (1.f - zg);
      const float dpre_n = dn * (1.f - ng * ng);
      const float dr = dpre_n * hn;
      const float dpre_r = dr * rg * (1.f - rg);
      const float dpre_z = dz * zg * (1.f - zg);
      const size_t o = (size_t)row * d3;
      dxp[o + col] = dpre_r;
      dxp[o + d + col] = dpre_z;
      dxp[o + 2 * d + col] = dpre_n;
      dhp[o + col] = dpre_r;
      dhp[o + d + col] = dpre_z;
      dhp[o + 2 * d + col] = dpre_n * rg;
      dh_out[(size_t)row * d + col] = gv * zg;
    }
  }
}

// dmsg[s] = sum of dagg[receiver] over the edges leaving s, in edge-list
// order: one warp per row over the row's segment of the CSC edge list.
__global__ void __launch_bounds__(kThreads)
transpose_sum_kernel(const float* __restrict__ dagg,
                     const int* __restrict__ csc_ptr,
                     const int* __restrict__ csc_rcv, float* __restrict__ dmsg,
                     int n, int d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together
  aggregate_row_vec4(dagg, csc_rcv, csc_ptr[row], csc_ptr[row + 1], d, lane,
                     nullptr, dmsg + (size_t)row * d);
}

// The three products C_k = a_k^T b_k of one reverse round, with a_k
// [n, da] and b_k [n, db_k], placed at w_off[k] in a chunk's row of the
// partial buffer, and the column sums of b_k at b_off[k].
struct WgradProducts {
  const float* a[3];
  const float* b[3];
  int db[3];
  int w_off[3];
  int b_off[3];
  int tiles[3];  // 64x64 tiles of C_k
};

// Block (chunk, tile): the chunk's rows' contribution to one 64x64 tile of
// one product, added to (or, for the first round, written into) the
// chunk's slot part[chunk][...]. Blocks of the first tile row also sum
// their 64 columns of b. Thread (ty, tx) owns rows i0 + ty + 16u and
// columns j0 + tx + 16v of the tile.
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(WgradProducts p, float* __restrict__ part, int ld, int n,
             int da, int accumulate) {
  __shared__ float a_s[kWStep][kWTile];
  __shared__ float b_s[kWStep][kWTile];
  int t = blockIdx.y, k = 0;
  while (k < 2 && t >= p.tiles[k]) {
    t -= p.tiles[k];
    ++k;
  }
  const float* __restrict__ a = p.a[k];
  const float* __restrict__ b = p.b[k];
  const int db = p.db[k];
  const int tiles_j = (db + kWTile - 1) / kWTile;
  const int i0 = (t / tiles_j) * kWTile;
  const int j0 = (t % tiles_j) * kWTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int r_beg = blockIdx.x * kWRows;
  const int r_end = min(n, r_beg + kWRows);
  const bool sum_cols = i0 == 0 && threadIdx.x < kWTile;

  float acc[4][4] = {};
  float colsum = 0.f;
  for (int r0 = r_beg; r0 < r_end; r0 += kWStep) {
    __syncthreads();
    for (int i = threadIdx.x; i < kWStep * kWTile; i += kThreads) {
      const int rr = i / kWTile, c = i - rr * kWTile;
      const int row = r0 + rr;
      const bool ok = row < r_end;
      a_s[rr][c] = (ok && i0 + c < da) ? a[(size_t)row * da + i0 + c] : 0.f;
      b_s[rr][c] = (ok && j0 + c < db) ? b[(size_t)row * db + j0 + c] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kWStep, r_end - r0);
    for (int kk = 0; kk < kmax; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = a_s[kk][ty + 16 * u];
        bv[u] = b_s[kk][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
      if (sum_cols) colsum += b_s[kk][threadIdx.x];
    }
  }
  float* out = part + (size_t)blockIdx.x * ld;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty + 16 * u, j = j0 + tx + 16 * v;
      if (i < da && j < db) {
        const size_t o = (size_t)p.w_off[k] + (size_t)i * db + j;
        out[o] = accumulate ? out[o] + acc[u][v] : acc[u][v];
      }
    }
  }
  if (sum_cols && j0 + (int)threadIdx.x < db) {
    const size_t o = (size_t)p.b_off[k] + j0 + threadIdx.x;
    out[o] = accumulate ? out[o] + colsum : colsum;
  }
}

// out[i] = sum over chunks c of part[c][i], in chunk order.
__global__ void reduce_chunks_kernel(const float* __restrict__ part,
                                     int chunks, int ld,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ld) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(size_t)c * ld + i];
  out[i] = s;
}

// Layout of one chunk's row of partials at width d:
// [dxw d*3d | dxb 3d | dhw d*3d | dhb 3d | dew d*d | deb d].
void partial_layout(int d, int db[3], int w_off[3], int b_off[3], int* ld) {
  db[0] = 3 * d;
  db[1] = 3 * d;
  db[2] = d;
  int off = 0;
  for (int k = 0; k < 3; ++k) {
    w_off[k] = off;
    off += d * db[k];
    b_off[k] = off;
    off += db[k];
  }
  *ld = off;
}

}  // namespace

extern "C" {

// Every entry point launches one kernel on `stream` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.

int ggnn_bwd_csc(const int* sorted_senders, int n_edges, int n_nodes,
                 int* csc_ptr, void* stream) {
  return launch_csr(sorted_senders, n_edges, n_nodes, csc_ptr,
                    (cudaStream_t)stream);
}

int ggnn_bwd_gate(const float* h, const float* agg, const float* g,
                  const float* xw, const float* xb, const float* hw,
                  const float* hb, float* dxp, float* dhp, float* dh_out,
                  int n, int d, void* stream) {
  const size_t smem = round_smem(d);
  cudaError_t err = allow_smem(gate_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, (d + kCols - 1) / kCols);
  gate_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      h, agg, g, xw, xb, hw, hb, dxp, dhp, dh_out, n, d);
  return (int)cudaGetLastError();
}

// out (+)= a @ w, without a bias.
int ggnn_bwd_linear(const float* a, const float* w, float* out, int n,
                    int d_in, int d_out, int accumulate, void* stream) {
  return launch_linear(a, w, nullptr, out, n, d_in, d_out, accumulate,
                       (cudaStream_t)stream);
}

int ggnn_bwd_transpose_sum(const float* dagg, const int* csc_ptr,
                           const int* csc_rcv, float* dmsg, int n, int d,
                           void* stream) {
  if (d % 4 != 0) return (int)cudaErrorInvalidValue;  // float4 edge sum
  const int rows_per_block = kThreads / 32;
  transpose_sum_kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads,
                         0, (cudaStream_t)stream>>>(dagg, csc_ptr, csc_rcv,
                                                    dmsg, n, d);
  return (int)cudaGetLastError();
}

// Floats in one chunk's row of the partial buffer at width d.
int ggnn_bwd_partial_width(int d) {
  int db[3], w_off[3], b_off[3], ld;
  partial_layout(d, db, w_off, b_off, &ld);
  return ld;
}

// Chunks of the node axis the weight gradients are split into.
int ggnn_bwd_chunks(int n) { return (n + kWRows - 1) / kWRows; }

// The weight and bias gradients of one reverse round, into the partial
// buffer part [ggnn_bwd_chunks(n)][ggnn_bwd_partial_width(d)]: written
// when `accumulate` is 0, added otherwise.
int ggnn_bwd_wgrad(const float* agg, const float* dxp, const float* h,
                   const float* dhp, const float* dmsg, float* part, int n,
                   int d, int accumulate, void* stream) {
  WgradProducts p;
  int ld;
  partial_layout(d, p.db, p.w_off, p.b_off, &ld);
  p.a[0] = agg;
  p.b[0] = dxp;
  p.a[1] = h;
  p.b[1] = dhp;
  p.a[2] = h;
  p.b[2] = dmsg;
  const int tiles_i = (d + kWTile - 1) / kWTile;
  int total = 0;
  for (int k = 0; k < 3; ++k) {
    p.tiles[k] = tiles_i * ((p.db[k] + kWTile - 1) / kWTile);
    total += p.tiles[k];
  }
  dim3 grid(ggnn_bwd_chunks(n), total);
  wgrad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, part, ld, n, d,
                                                            accumulate);
  return (int)cudaGetLastError();
}

int ggnn_bwd_reduce(const float* part, int chunks, int ld, float* out,
                    void* stream) {
  const int threads = 256;
  reduce_chunks_kernel<<<(ld + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(part, chunks, ld, out);
  return (int)cudaGetLastError();
}

// Largest width the backward's kernels can take: the products with the
// transposed gate weights stage rows of width 3d, the gate kernel two rows
// of width d.
int ggnn_bwd_max_width(void) {
  const int lin = width_limit(sizeof(float) * 3 * kRows,
                              sizeof(float) * (size_t)kChunk * kCols);
  const int gate = width_limit(sizeof(float) * 2 * kRows,
                               sizeof(float) * 2 * (size_t)kChunk * 3 * kCols);
  return lin < gate ? lin : gate;
}

const char* ggnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
