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
// in float32, and returns dL/dh0 and the six weight and bias gradients.
//
// The TPU re-ran the forward inside the kernel to refill a VMEM history
// bank; an 80 GB card keeps the bank from the forward instead, so nothing
// here repeats the edge linear or the edge sum of the forward. The TPU
// accumulated the weight gradients in VMEM across the sequential grid;
// Hopper's blocks run in no order, and float atomics would make the sums
// change from run to run: both variants sum the weight gradients over a
// fixed partition of the node axis into chunks of kWRows (each block adds
// its tile into its chunk's own slot of a partial buffer) and
// reduce_chunks_kernel sums the chunks in chunk order, once per call. No
// float atomics anywhere, so two calls on the same inputs return bitwise
// equal gradients. Two variants, chosen in Python (ops/fused_ggnn.py
// `variant`).
//
// `wgmma` (width 128). What bounds it: a reverse round is 40 N D^2 product
// FLOPs (both 3-gate products again, dagg and dhp @ hw^T, dmsg @ ew^T, the
// three weight gradients), three tensor-core passes each in 3xTF32, ~0.07
// ms a round at N = 16,768 at the TF32 peak, against ~10 N D floats of
// banked state and the dxp [N, 384] round trip through memory. Each
// kernel holds one block an SM (registers) and runs its phases in turn,
// so what sets the pace is how much of each product's latency the next
// loads hide. Per reverse round, three launches on the caller's stream
// (ggnn_tc.cuh's tiles and products, every product transposed: the
// weights as wgmma's A in registers, the node rows as its split B tiles):
//   1. gate_bwd_tc_kernel: both 3-gate products for 64 nodes recomputed
//      from the banked agg_t and h_t (the round's code, the gate weights
//      through its TMA ring), the chain above, then dagg = dxp @ xw^T and
//      dh' = g z + dhp @ hw^T with dxp's columns split into the tiles that
//      held agg and h (dhp shares its first 256 columns with dxp); dxp and
//      dhn = dpre_n r go to memory for the weight gradients;
//   2. tsum_tc_kernel: dmsg by the forward's edge sum over the
//      sender-sorted (CSC) index (in edge-list order, runs in closed
//      form), then dh' += dmsg @ ew^T;
//   3. wgrad_tc_kernel: the three weight gradients, contracted over the
//      chunk's nodes in slices of 32 (both operands are node-major, so b's
//      slice is transposed on its way into the swizzled tile) and the
//      bias column sums.
// Once per call: tc_prep_kernel builds the CSC row pointer and the change
// bitmask of the CSC receivers.
//
// `ffma` (other widths, and the yardstick): six launches per reverse round,
// bound by FP32 operations:
//   1. gate_bwd_kernel: recomputes both 3-gate products for a 16-row tile
//      from the banked agg_t and h_t (the forward's code, so the same
//      values), applies the chain above and writes dxp, dhp and g z.
//   2.-3. linear_kernel with the transposed gate weights: dagg, then
//      dh' += dhp @ hw^T.
//   4. transpose_sum_kernel: one warp per sender sums dagg over its segment
//      of the sender-sorted (CSC) edge list, in edge-list order, with the
//      forward's in-order float4 edge sum.
//   5. linear_kernel: dh' += dmsg @ ew^T.
//   6. wgrad_kernel: the three weight gradients and bias column sums, a
//      64x64 tile a block.
// Once per call: csr_kernel builds the CSC row pointer.

#include "ggnn_common.cuh"
#include "ggnn_tc.cuh"

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


// ------------------------------------------------ the tensor-core variant

constexpr int kTsumSmem = 2 * kTileBytes + 1024;
constexpr int kWgradStage = 2 * 128 * 128;  // big + small: 128 rows x 128 B
constexpr int kWgradSmem = 2 * kWgradStage + 1024;
constexpr int kGateSmem = 4 * kTileBytes + 2 * kWStage + 16 + 1024;

// Stores one float of a B operand tile, split, at (row r, column k) of a
// tile of K-major 32-float slices (xt_off's layout).
__device__ __forceinline__ void put1(uint8_t* big, uint8_t* small, int r,
                                     int k, float v) {
  uint32_t b, sm;
  split_tf32(v, b, sm);
  const int off = xt_off(r, k & ~3) + 4 * (k & 3);
  *reinterpret_cast<uint32_t*>(big + off) = b;
  *reinterpret_cast<uint32_t*>(small + off) = sm;
}

// dagg (+)= X @ wx^T and dh (+)= Y @ wy^T over K columns k0 .. k0 + 8 steps
// of the [128, 384] gate weights, X and Y the split tiles of the block's
// 64 nodes (K-major, column k - k0): the warpgroup's 64 output columns i,
// the weights read K-major as stored, their fragments one step ahead.
template <int kSteps>
__device__ __forceinline__ void transposed_gate_products(
    const uint8_t* x_big, const uint8_t* x_small, const uint8_t* y_big,
    const uint8_t* y_small, const float* __restrict__ wx,
    const float* __restrict__ wy, int k0, float (&acc_a)[32],
    float (&acc_h)[32]) {
  constexpr int d3 = 3 * kTcD;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int m = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3)
                + (lane >> 2);
  float rx[4], rh[4];
  load_a<true>(rx, wx, d3, m, k0 + t);
  load_a<true>(rh, wy, d3, m, k0 + t);
#pragma unroll 1
  for (int ks = 0; ks < kSteps; ++ks) {
    uint32_t fxb[4], fxs[4], fhb[4], fhs[4];
    split_a(rx, fxb, fxs);
    split_a(rh, fhb, fhs);
    wgmma_fence();
    mma3(acc_a, fxb, fxs, step_desc(x_big, ks), step_desc(x_small, ks));
    mma3(acc_h, fhb, fhs, step_desc(y_big, ks), step_desc(y_small, ks));
    wgmma_commit();
    if (ks + 1 < kSteps) {
      load_a<true>(rx, wx, d3, m, k0 + 8 * (ks + 1) + t);
      load_a<true>(rh, wy, d3, m, k0 + 8 * (ks + 1) + t);
    }
    wgmma_wait_all();
    fence_regs(acc_a);
    fence_regs(acc_h);
    fence_regs(fxb);
    fence_regs(fxs);
    fence_regs(fhb);
    fence_regs(fhs);
  }
}

// Reverse of one GRU round for 64 nodes, and the two products with the
// transposed gate weights that follow it:
//   1. both 3-gate products recomputed from the banked agg_t and h_t (as
//      the forward's round computes them, the gate weights through its TMA
//      ring), then the chain: dxp [n, 384] and dhn = dpre_n r [n, 128] to
//      memory for the weight gradients (dhp = [dpre_r | dpre_z | dhn] is
//      dxp but for its last block), g z into dh_out;
//   2. dpre_r and dpre_z, split into the tiles that held agg and h, are
//      the first 256 columns of both dxp and dhp: dagg = dxp @ xw^T and
//      dh_out += dhp @ hw^T over them;
//   3. then dpre_n and dhn (kept in registers) into the tiles for the last
//      128 columns; dagg to memory, dh_out added to.
__global__ void __launch_bounds__(kTcThreads, 1)
gate_bwd_tc_kernel(const float* __restrict__ h, const float* __restrict__ agg,
                   const float* __restrict__ g, const float* __restrict__ xw,
                   const float* __restrict__ xb, const float* __restrict__ hw,
                   const float* __restrict__ hb, float* __restrict__ dxp,
                   float* __restrict__ dhn, float* __restrict__ dagg,
                   float* __restrict__ dh_out, int n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* agg_big = align1024(smem_raw);
  uint8_t* agg_small = agg_big + kTileBytes;
  uint8_t* h_big = agg_small + kTileBytes;
  uint8_t* h_small = h_big + kTileBytes;
  uint8_t* ring = h_small + kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kWStage);
  const int row0 = blockIdx.x * kTcRows;
  if (threadIdx.x == 0) ring_start(ring, full, xw, hw);
  load_split_rows(h, row0, n, h_big, h_small);
  load_split_rows(agg, row0, n, agg_big, agg_small);
  fence_proxy_async();
  __syncthreads();

  GateSums s;
  gate_products_tc(agg_big, agg_small, h_big, h_small, ring, full, xw, hw, s);
  __syncthreads();  // both warpgroups are done with the agg and h tiles

  // the first 256 columns of dxp (= of dhp): 8 slices, big then small
  uint8_t* rz_big = agg_big;
  uint8_t* rz_small = agg_big + 2 * kTileBytes;
  constexpr int d3 = 3 * kTcD;
  float pn[2][16], pnr[2][16];  // dpre_n and dhn of this thread's elements
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = tile_col(hh);
    float hv[16], gv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_row(j, e);
        const size_t o = (size_t)row * kTcD + col;
        hv[2 * j + e] = row < n ? __ldg(h + o) : 0.f;
        gv[2 * j + e] = row < n ? __ldg(g + o) : 0.f;
      }
    const float br = xb[col] + hb[col], bz = xb[kTcD + col] + hb[kTcD + col];
    const float bxn = xb[2 * kTcD + col], chn = hb[2 * kTcD + col];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = tile_row(j, e), row = row0 + r;
        const int i = 4 * j + 2 * hh + e, u = 2 * j + e;
        float dpre_r = 0.f, dpre_z = 0.f, dpre_n = 0.f, rg = 0.f;
        if (row < n) {
          rg = sigmoid_fast(s.r[i] + br);
          const float zg = sigmoid_fast(s.z[i] + bz);
          const float hn = s.hn[i] + chn;
          const float ng = tanh_fast(s.xn[i] + bxn + rg * hn);
          const float dz = gv[u] * (hv[u] - ng);
          const float dn = gv[u] * (1.f - zg);
          dpre_n = dn * (1.f - ng * ng);
          const float dr = dpre_n * hn;
          dpre_r = dr * rg * (1.f - rg);
          dpre_z = dz * zg * (1.f - zg);
          const size_t o3 = (size_t)row * d3 + col;
          dxp[o3] = dpre_r;
          dxp[o3 + kTcD] = dpre_z;
          dxp[o3 + 2 * kTcD] = dpre_n;
          dhn[(size_t)row * kTcD + col] = dpre_n * rg;
          dh_out[(size_t)row * kTcD + col] = gv[u] * zg;
        }
        pn[hh][u] = dpre_n;
        pnr[hh][u] = dpre_n * rg;
        put1(rz_big, rz_small, r, col, dpre_r);
        put1(rz_big, rz_small, r, kTcD + col, dpre_z);
      }
  }
  fence_proxy_async();
  __syncthreads();

  float acc_a[32], acc_h[32];
  zero(acc_a);
  zero(acc_h);
  transposed_gate_products<2 * kTcD / 8>(rz_big, rz_small, rz_big, rz_small,
                                         xw, hw, 0, acc_a, acc_h);
  __syncthreads();  // both warpgroups are done with the first 256 columns

  uint8_t* x_big = agg_big;
  uint8_t* x_small = x_big + kTileBytes;
  uint8_t* y_big = x_small + kTileBytes;
  uint8_t* y_small = y_big + kTileBytes;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = tile_col(hh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = tile_row(j, e), u = 2 * j + e;
        put1(x_big, x_small, r, col, pn[hh][u]);
        put1(y_big, y_small, r, col, pnr[hh][u]);
      }
  }
  fence_proxy_async();
  __syncthreads();
  transposed_gate_products<kTcD / 8>(x_big, x_small, y_big, y_small, xw,
                                     hw, 2 * kTcD, acc_a, acc_h);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = tile_col(hh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_row(j, e);
        if (row >= n) continue;
        const int i = 4 * j + 2 * hh + e;
        const size_t o = (size_t)row * kTcD + col;
        dagg[o] = acc_a[i];
        dh_out[o] += acc_h[i];
      }
  }
}

// dmsg[s] = sum of dagg[receiver] over the edges leaving s, in edge-list
// order (the forward's edge sum over the CSC index, runs in closed form),
// for 64 senders; then dh += dmsg @ ew^T on `wgmma`.
__global__ void __launch_bounds__(kTcThreads, 1)
tsum_tc_kernel(const float* __restrict__ dagg, const int* __restrict__ csc_ptr,
               const int* __restrict__ csc_rcv,
               const uint32_t* __restrict__ heads, const float* __restrict__ ew,
               float* __restrict__ dmsg, float* __restrict__ dh, int n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* big = align1024(smem_raw);
  uint8_t* small = big + kTileBytes;
  const int row0 = blockIdx.x * kTcRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int bnd = bounds(csc_ptr, row0, n, warp, lane);
  for (int i = 0; i < 8; ++i) {
    const int rr = warp + 8 * i, row = row0 + rr;
    const int beg = __shfl_sync(0xffffffffu, bnd, i);
    const int end = __shfl_sync(0xffffffffu, bnd, 8 + i);
    const float4 v = segment_sum(dagg, csc_rcv, heads, beg, end, lane);
    put4(big, small, xt_off(rr, 4 * lane), v);
    if (row < n)
      *reinterpret_cast<float4*>(dmsg + (size_t)row * kTcD + 4 * lane) = v;
  }
  fence_proxy_async();
  __syncthreads();

  const int m = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3)
                + (lane >> 2);
  float acc[32];
  zero(acc);
  float raw[4];
  load_a<true>(raw, ew, kTcD, m, t);
#pragma unroll 1
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t fb[4], fs[4];
    split_a(raw, fb, fs);
    wgmma_fence();
    mma3(acc, fb, fs, step_desc(big, ks), step_desc(small, ks));
    wgmma_commit();
    if (ks + 1 < kKSteps) load_a<true>(raw, ew, kTcD, m, 8 * (ks + 1) + t);
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(fb);
    fence_regs(fs);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = tile_col(hh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_row(j, e);
        if (row < n) dh[(size_t)row * kTcD + col] += acc[4 * j + 2 * hh + e];
      }
  }
}

// Block (chunk, tile): the chunk's kWRows nodes' contribution to one
// 128 x 128 tile (all 128 rows i, 128 columns from j0) of one product
// C_k = a_k^T b_k, contracted over the nodes in slices of 32 on `wgmma`,
// and the column sums of b_k over the chunk; added to (or, in the first
// reverse round, written into) the chunk's slot of the partial buffer, as
// the FFMA variant's wgrad_kernel does. The contraction runs over the node
// axis, along which both operands are rows, so b's slice is transposed on
// its way into the swizzled tile (thread (warp w, lane l) holds nodes
// 4w .. 4w + 3 by columns 4l .. 4l + 3 and stores each column's four nodes
// as one 16-byte chunk, in a rotated column order that keeps the eight
// lanes of a store phase on eight distinct chunks); a's fragments load
// transposed into registers. Tiles 0-2: agg^T dxp, 3-5: h^T dhp, 6: h^T dmsg;
// dhp's first 256 columns are dxp's, so tiles 3-4 read dxp and tile 5 reads
// dhn = dpre_n r ([n, 128], p.b[1]).
__global__ void __launch_bounds__(kTcThreads, 1)
wgrad_tc_kernel(WgradProducts p, float* __restrict__ part, int ld, int n,
                int accumulate) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  __shared__ float cs[8][128];
  const int tile = blockIdx.y;
  const int k = tile < 3 ? 0 : (tile < 6 ? 1 : 2);
  const int j0 = 128 * (tile - (k == 0 ? 0 : (k == 1 ? 3 : 6)));
  const float* __restrict__ a = p.a[k];
  const int db = p.db[k];  // the product's width
  // where b's columns j0 .. j0 + 127 lie: a row stride and a first column
  const bool from_dxp = k == 1 && j0 < 2 * kTcD;
  const float* __restrict__ b = from_dxp ? p.b[0] : p.b[k];
  const int ldb = k == 2 ? kTcD : (k == 1 && !from_dxp ? kTcD : 3 * kTcD);
  const int bcol = k == 1 && !from_dxp ? j0 - 2 * kTcD : j0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3;
  const int m = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int r_beg = blockIdx.x * kWRows;
  const int r_end = min(n, r_beg + kWRows);
  const int nk = (r_end - r_beg + 31) >> 5;

  // b's next slice loads while this one's wgmmas run
  float4 bv[4];
  auto load_b = [&](int kc, float4 (&dst)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r_beg + 32 * kc + 4 * warp + q;
      dst[q] = row < r_end ? ld4(b + (size_t)row * ldb + bcol + 4 * lane)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // A[i][node] = a[node][i]: rows m, m + 8, nodes node0 + t, node0 + t + 4;
  // a whole slice's (4 k8 steps) loaded a slice ahead
  auto load_a_nodes = [&](int node0, float (&raw)[4]) {
    const int n0 = node0 + t, n1 = node0 + t + 4;
    raw[0] = n0 < r_end ? __ldg(a + (size_t)n0 * kTcD + m) : 0.f;
    raw[1] = n0 < r_end ? __ldg(a + (size_t)n0 * kTcD + m + 8) : 0.f;
    raw[2] = n1 < r_end ? __ldg(a + (size_t)n1 * kTcD + m) : 0.f;
    raw[3] = n1 < r_end ? __ldg(a + (size_t)n1 * kTcD + m + 8) : 0.f;
  };
  float ra[4][4], na[4][4];
  float acc[64];
  zero(acc);
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
  load_b(0, bv);
#pragma unroll
  for (int s = 0; s < 4; ++s) load_a_nodes(r_beg + 8 * s, ra[s]);
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    uint8_t* big = base + (kc & 1) * kWgradStage;
    uint8_t* small = big + kWgradStage / 2;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      colsum[0] += bv[q].x;
      colsum[1] += bv[q].y;
      colsum[2] += bv[q].z;
      colsum[3] += bv[q].w;
    }
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int jj = (step + (lane >> 1)) & 3;
      const int j = 4 * lane + jj;
      const float4 v = jj == 0 ? make_float4(bv[0].x, bv[1].x, bv[2].x, bv[3].x)
                     : jj == 1 ? make_float4(bv[0].y, bv[1].y, bv[2].y, bv[3].y)
                     : jj == 2 ? make_float4(bv[0].z, bv[1].z, bv[2].z, bv[3].z)
                               : make_float4(bv[0].w, bv[1].w, bv[2].w, bv[3].w);
      put4(big, small, ((j >> 3) << 10) + ((j & 7) << 7) + ((warp ^ (j & 7)) << 4),
           v);
    }
    fence_proxy_async();
    __syncthreads();
    if (kc + 1 < nk) {
      load_b(kc + 1, bv);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        load_a_nodes(r_beg + 32 * (kc + 1) + 8 * s, na[s]);
    }
    const uint64_t bbd = sw128_desc(big), bsd = sw128_desc(small);
    // the slice's four k8 steps: 12 wgmmas between waits
    uint32_t fb[4][4], fs[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) split_a(ra[s], fb[s], fs[s]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) mma3(acc, fb[s], fs[s], bbd + 2 * s, bsd + 2 * s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fence_regs(fb[s]);
      fence_regs(fs[s]);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[s][i] = na[s][i];
  }
  float* out = part + (size_t)blockIdx.x * ld;
  const int gl = lane >> 2;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + gl + 8 * hh;
      const int j = j0 + 8 * jj + 2 * t;
      const size_t o = (size_t)p.w_off[k] + (size_t)i * db + j;
      float2 v = make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
      if (accumulate) {
        const float2 w = *reinterpret_cast<const float2*>(out + o);
        v.x += w.x;
        v.y += w.y;
      }
      *reinterpret_cast<float2*>(out + o) = v;
    }
#pragma unroll
  for (int c = 0; c < 4; ++c) cs[warp][4 * lane + c] = colsum[c];
  __syncthreads();
  if (tid < 128) {
    float sum = 0.f;
    for (int w = 0; w < 8; ++w) sum += cs[w][tid];
    const size_t o = (size_t)p.b_off[k] + j0 + tid;
    out[o] = accumulate ? out[o] + sum : sum;
  }
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

// ---- the tensor-core variant (width 128)

// The CSC row pointer from the sender-sorted senders and the change
// bitmask of the receivers in that order (ceil(n_edges / 1024) words, at
// least one).
int ggnn_bwd_tc_prep(const int* sorted_senders, const int* csc_rcv,
                     int n_edges, int n_nodes, int* csc_ptr,
                     unsigned int* heads, void* stream) {
  return launch_tc_prep(sorted_senders, csc_rcv, n_edges, n_nodes, csc_ptr,
                        heads, (cudaStream_t)stream);
}

// The reverse round's gate kernel: dxp [n, 384], dhn = dpre_n r [n, 128],
// dagg = dxp @ xw^T, and dh_out = g z + dhp @ hw^T.
int ggnn_bwd_tc_gate(const float* h, const float* agg, const float* g,
                     const float* xw, const float* xb, const float* hw,
                     const float* hb, float* dxp, float* dhn, float* dagg,
                     float* dh_out, int n, void* stream) {
  static bool sized = false;
  const cudaError_t err = allow_smem_once(gate_bwd_tc_kernel, kGateSmem,
                                          sized);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  gate_bwd_tc_kernel<<<(n + kTcRows - 1) / kTcRows, kTcThreads, kGateSmem,
                       (cudaStream_t)stream>>>(h, agg, g, xw, xb, hw, hb, dxp,
                                               dhn, dagg, dh_out, n);
  return (int)cudaGetLastError();
}

// dmsg = the transposed edge sum of dagg, dh += dmsg @ ew^T
int ggnn_bwd_tc_tsum(const float* dagg, const int* csc_ptr,
                     const int* csc_rcv, const unsigned int* heads,
                     const float* ew, float* dmsg, float* dh, int n,
                     void* stream) {
  static bool sized = false;
  const cudaError_t err = allow_smem_once(tsum_tc_kernel, kTsumSmem, sized);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  tsum_tc_kernel<<<(n + kTcRows - 1) / kTcRows, kTcThreads, kTsumSmem,
                   (cudaStream_t)stream>>>(dagg, csc_ptr, csc_rcv, heads, ew,
                                           dmsg, dh, n);
  return (int)cudaGetLastError();
}

// The weight and bias gradients of one reverse round into the partial
// buffer, as ggnn_bwd_wgrad lays it out (dhp's last 128 columns as dhn).
int ggnn_bwd_tc_wgrad(const float* agg, const float* dxp, const float* h,
                      const float* dhn, const float* dmsg, float* part, int n,
                      int accumulate, void* stream) {
  static bool sized = false;
  const cudaError_t err = allow_smem_once(wgrad_tc_kernel, kWgradSmem, sized);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  WgradProducts p;
  int ld;
  partial_layout(kTcD, p.db, p.w_off, p.b_off, &ld);
  p.a[0] = agg;
  p.b[0] = dxp;
  p.a[1] = h;
  p.b[1] = dhn;
  p.a[2] = h;
  p.b[2] = dmsg;
  dim3 grid(ggnn_bwd_chunks(n), 7);
  wgrad_tc_kernel<<<grid, kTcThreads, kWgradSmem, (cudaStream_t)stream>>>(
      p, part, ld, n, accumulate);
  return (int)cudaGetLastError();
}

const char* ggnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
