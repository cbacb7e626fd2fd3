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
//      In training the wrapper gives each round its own output buffer (the
//      bank of pre-update states the backward reads) and the kernel also
//      writes the round's aggregate agg_t to a bank.
// Each launch is checked with cudaGetLastError by the caller. The CSR
// search, the linear kernel, the round kernel, the edge sum and the gate
// products live in ggnn_common.cuh, which the backward (fused_ggnn_bwd.cu)
// and the whole-model kernel (megabatch.cu) share.
//
// Known imbalance, kept on purpose: batch_np points every padding edge at
// the padding sink node, so one CSR segment can hold thousands of edges,
// and the warp that owns it adds them one after the other. They are part of
// the function and are summed in order like any other segment; runs of one
// sender reuse one loaded row (see aggregate_row_vec4), but the chain of
// adds stays serial. Balancing it across warps is later work.

#include "ggnn_common.cuh"

extern "C" {

// Every entry point launches one kernel on `stream` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.

int ggnn_csr(const int* receivers, int n_edges, int n_nodes, int* row_ptr,
             void* stream) {
  return launch_csr(receivers, n_edges, n_nodes, row_ptr, (cudaStream_t)stream);
}

int ggnn_linear(const float* a, const float* w, const float* b, float* out,
                int n, int d_in, int d_out, void* stream) {
  return launch_linear(a, w, b, out, n, d_in, d_out, 0, (cudaStream_t)stream);
}

int ggnn_gru_round(const float* h, const float* msg, const int* row_ptr,
                   const int* senders, const float* xw, const float* xb,
                   const float* hw, const float* hb, float* h_out,
                   float* agg_bank, int n, int d, void* stream) {
  return launch_gru_round(h, msg, row_ptr, senders, xw, xb, hw, hb, h_out,
                          agg_bank, n, d, (cudaStream_t)stream);
}

// Largest width both per-round kernels can take (shared memory per block).
int ggnn_max_width(void) {
  return width_limit(sizeof(float) * 2 * kRows,
                     sizeof(float) * 2 * (size_t)kChunk * 3 * kCols);
}

const char* ggnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
