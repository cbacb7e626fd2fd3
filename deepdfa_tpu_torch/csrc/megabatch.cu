// Whole-model GGNN forward for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_model_kernel` of
// deepdfa_tpu/ops/megabatch.py (launched by `_megabatch_model`, public
// `fused_ggnn_model`). For a packed batch it computes
//     h0 = [table[ids[:, 0]] | ... | table[ids[:, n_sub - 1]]]
//     h  = n_steps GGNN rounds from h0 (the rounds of fused_ggnn.cu)
//     s_i = [h_i | h0_i] . gw + gb
//     gate = masked softmax of s within each graph slot
//     pooled[g] = sum over the slot's rows of gate_i * [h_i | h0_i]
//     logits = head(pooled): linear layers with relu between them
// in float32.
//
// What bounds it on this card. The rounds dominate: 2*N*D*D + 12*N*D*D
// FLOPs per round at D = 128 against a few MB of state that stays in the
// 50 MB L2. At width 128 they run on B1's tensor-core variant (3xTF32
// `wgmma`, ggnn_tc.cuh), where the edge sum's latency and the launches
// set the pace; at other widths on B1's FFMA kernels, bound by FP32
// operations. The epilogue adds 4*N*D for
// the gate logits and the readout and G * sum(2*in*out) for the head, which
// is small beside the rounds.
//
// What the design does about that. The TPU ran one sequential grid with the
// node states resident in VMEM, and pooled with a node-by-graph one-hot
// matrix on the MXU. On Hopper nothing carries over between blocks and the
// rounds need a grid-wide barrier each, so the model is five kinds of
// launch on the caller's stream, none synchronising:
//   1. embed_kernel: the prologue gather of every sub-table row into h0,
//      which stays as the bank for the [h | h0] concat;
//   2. the receivers' CSR row pointer (with B1's tensor-core variant also
//      the bitmask of where the sender changes: tc_prep_kernel), and the
//      graph row pointer of the sorted node_gidx (csr_kernel; nodes are
//      contiguous per graph slot, and all padding nodes sit in the last
//      one: the batch_np contract);
//   3. per round, B1's two kernels, unchanged: the edge linear, then the
//      in-order aggregate and both GRU products, into a ping-pong pair of
//      buffers (ggnn_tc.cuh at width 128, ggnn_common.cuh otherwise);
//   4. pool_head_kernel: one block per graph slot walks the slot's rows:
//      gate logits one warp per row (no concat is materialised), the masked
//      max, the exponentials and their sum, the readout summed in row order
//      per column, then the head, one thread per output column with the
//      weights streamed from global memory (a 256 x 256 layer is 256 KB, more
//      than a block's shared memory; it stays in L2), only the two
//      activation vectors in shared memory.
// No float atomics anywhere, and every reduction has a fixed order, so two
// calls on the same inputs are bitwise equal. Each launch is checked with
// cudaGetLastError by the caller.

#include <math.h>

#include "ggnn_common.cuh"
#include "ggnn_tc.cuh"

namespace {

constexpr int kMaxLayers = 8;

struct HeadDims {
  int n_layers;
  int dims[kMaxLayers + 1];  // dims[0] = 2d, dims[l + 1] = layer l's output
};

// h0[i, k * ed + c] = table[ids[i, k], c]: the stacked sub-tables' rows
// side by side, one thread per element.
__global__ void embed_kernel(const float* __restrict__ table,
                             const int* __restrict__ ids,
                             float* __restrict__ h0, int n, int n_sub,
                             int ed) {
  const int d = n_sub * ed;
  const size_t total = (size_t)n * d;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const size_t row = i / d;
    const int col = (int)(i - row * d);
    const int k = col / ed;
    h0[i] = table[(size_t)ids[row * n_sub + k] * ed + (col - k * ed)];
  }
}

// One block per graph slot g over its rows [gptr[g], gptr[g + 1]):
// attention pooling over [h | h0] with segment_softmax's rules (a slot
// without a masked-in row gets max 0, a zero denominator becomes 1), then
// the head. `gate` is scratch of one float per node; `out` gets the last
// layer's dims[n_layers] values per slot (the pooled row when n_layers is 0).
__global__ void __launch_bounds__(kThreads)
pool_head_kernel(const float* __restrict__ h, const float* __restrict__ h0,
                 const int* __restrict__ gptr,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ gw, const float* __restrict__ gb,
                 const float* __restrict__ head_w, HeadDims head,
                 float* __restrict__ gate, float* __restrict__ out, int d) {
  extern __shared__ float act[];  // two vectors of the widest layer
  __shared__ float red[kThreads / 32];
  __shared__ float s_max, s_den;
  const int g = blockIdx.x;
  const int beg = gptr[g], end = gptr[g + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  int widest = 0;
  for (int l = 0; l <= head.n_layers; ++l) widest = max(widest, head.dims[l]);

  // gate logits of the masked-in rows, one warp per row; the butterfly sum
  // leaves every lane with the same bits
  float wmax = -INFINITY;
  for (int i = beg + warp; i < end; i += kWarps) {
    if (!mask[i]) continue;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(h[(size_t)i * d + c], gw[c], acc);
    for (int c = lane; c < d; c += 32)
      acc = fmaf(h0[(size_t)i * d + c], gw[d + c], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    const float s = acc + gb[0];
    if (lane == 0) gate[i] = s;
    wmax = fmaxf(wmax, s);
  }
  if (lane == 0) red[warp] = wmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w]);
    s_max = isfinite(m) ? m : 0.f;
  }
  __syncthreads();

  // exponentials and their sum: lane-strided partial sums, then a fixed tree
  if (warp == 0) {
    float part = 0.f;
    for (int i = beg + lane; i < end; i += 32) {
      if (!mask[i]) continue;
      const float e = expf(gate[i] - s_max);
      gate[i] = e;
      part += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) s_den = part == 0.f ? 1.f : part;
  }
  __syncthreads();

  // readout, one thread per column of [h | h0], rows added in order
  float* a = act;
  float* b = act + widest;
  const int d2 = 2 * d;
  const float den = s_den;
  for (int c = threadIdx.x; c < d2; c += kThreads) {
    const float* src = c < d ? h + c : h0 + (c - d);
    float acc = 0.f;
    for (int i = beg; i < end; ++i) {
      if (mask[i]) acc += (gate[i] / den) * src[(size_t)i * d];
    }
    a[c] = acc;
  }

  // the head: each layer's weight [in, out] is followed by its bias [out]
  const float* w = head_w;
  for (int l = 0; l < head.n_layers; ++l) {
    const int din = head.dims[l], dout = head.dims[l + 1];
    __syncthreads();
    for (int j = threadIdx.x; j < dout; j += kThreads) {
      float acc = 0.f;
      for (int k = 0; k < din; ++k) acc = fmaf(a[k], w[(size_t)k * dout + j], acc);
      acc += w[(size_t)din * dout + j];
      b[j] = l + 1 < head.n_layers ? fmaxf(acc, 0.f) : acc;
    }
    w += (size_t)din * dout + dout;
    float* t = a;
    a = b;
    b = t;
  }
  __syncthreads();
  const int dlast = head.dims[head.n_layers];
  for (int j = threadIdx.x; j < dlast; j += kThreads)
    out[(size_t)g * dlast + j] = a[j];
}

}  // namespace

extern "C" {

// Every entry point launches one kernel on `stream` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.

int mb_embed(const float* table, const int* ids, float* h0, int n, int n_sub,
             int ed, void* stream) {
  const size_t total = (size_t)n * n_sub * ed;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 32 ? want : 65535 * 32);
  if (blocks == 0) return 0;
  embed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(table, ids, h0, n,
                                                             n_sub, ed);
  return (int)cudaGetLastError();
}

// row_ptr[v] = first key >= v for v in [0, n_slots], over sorted keys.
int mb_csr(const int* keys, int n_keys, int n_slots, int* row_ptr,
           void* stream) {
  return launch_csr(keys, n_keys, n_slots, row_ptr, (cudaStream_t)stream);
}

int mb_linear(const float* a, const float* w, const float* b, float* out,
              int n, int d_in, int d_out, void* stream) {
  return launch_linear(a, w, b, out, n, d_in, d_out, 0, (cudaStream_t)stream);
}

int mb_gru_round(const float* h, const float* msg, const int* row_ptr,
                 const int* senders, const float* xw, const float* xb,
                 const float* hw, const float* hb, float* h_out, int n, int d,
                 void* stream) {
  return launch_gru_round(h, msg, row_ptr, senders, xw, xb, hw, hb, h_out,
                          nullptr, n, d, (cudaStream_t)stream);
}

// B1's tensor-core variant (width 128): the receivers' row pointer and the
// senders' change bitmask, the edge linear (which also writes the
// padding-sink flags [n]) and the round.
int mb_tc_prep(const int* receivers, const int* senders, int n_edges,
               int n_nodes, int* row_ptr, unsigned int* heads, void* stream) {
  return launch_tc_prep(receivers, senders, n_edges, n_nodes, row_ptr, heads,
                        (cudaStream_t)stream);
}

int mb_tc_linear(const float* a, const float* w, const float* b,
                 const int* row_ptr, const int* senders,
                 const unsigned int* heads, int* flags, float* out, int n,
                 void* stream) {
  return launch_tc_linear(a, w, b, row_ptr, senders, heads, flags, out, n,
                          (cudaStream_t)stream);
}

int mb_tc_round(const float* h, const float* msg, const int* row_ptr,
                const int* senders, const unsigned int* heads,
                const int* flags, const float* xw, const float* xb,
                const float* hw, const float* hb, float* h_out, int n,
                void* stream) {
  return launch_tc_round(h, msg, row_ptr, senders, heads, flags, xw, xb, hw,
                         hb, h_out, nullptr, n, (cudaStream_t)stream);
}

// `dims` is a host array of n_layers + 1 widths (dims[0] = 2d).
int mb_pool_head(const float* h, const float* h0, const int* gptr,
                 const unsigned char* mask, const float* gw, const float* gb,
                 const float* head_w, int n_layers, const int* dims,
                 float* gate, float* out, int n_graphs, int d, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  HeadDims head;
  head.n_layers = n_layers;
  int widest = 0;
  for (int l = 0; l <= kMaxLayers; ++l) {
    head.dims[l] = l <= n_layers ? dims[l] : 0;
    if (head.dims[l] > widest) widest = head.dims[l];
  }
  if (n_graphs == 0) return 0;
  const size_t smem = 2 * sizeof(float) * (size_t)widest;
  cudaError_t err = allow_smem(pool_head_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pool_head_kernel<<<n_graphs, kThreads, smem, (cudaStream_t)stream>>>(
      h, h0, gptr, mask, gw, gb, head_w, head, gate, out, d);
  return (int)cudaGetLastError();
}

int mb_max_layers(void) { return kMaxLayers; }

// Largest width the round kernels can take (shared memory per block).
int mb_max_width(void) {
  return width_limit(sizeof(float) * 2 * kRows,
                     sizeof(float) * 2 * (size_t)kChunk * 3 * kCols);
}

const char* mb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
