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
// in float32.
//
// Two variants, chosen in Python (ops/fused_ggnn.py `variant`).
//
// `wgmma` (width 128, every main-path bucket). What bounds it: a round is
// 2 N D^2 FLOPs for the edge linear and 12 N D^2 for the two 3-gate
// products; in 3xTF32 each product is three tensor-core passes, ~7 us of
// tensor work a round at N = 5,120, against a few MB of state in the 50 MB
// L2. So latency sets the pace: a block of 64 nodes runs its phases in
// turn (load and split h, the edge sum's dependent loads, 16 k8 steps of
// 18 wgmmas each waiting on the last, the epilogue), one block an SM, and
// a round costs the slowest block. The FFMA variant's time went to
// shared-memory-bound FFMA products and to the padding sink's segment, one
// serial chain of ~17k adds at the megabatch shape. What the design does
// (ggnn_tc.cuh):
//   1. tc_prep_kernel (once per call): the receivers' row pointer and the
//      bitmask of where the sender index changes;
//   2. linear_tc_kernel (per round): msg = h @ ew + eb on `wgmma`, a block
//      of two warpgroups per 64 nodes, h split into big and small TF32
//      tiles in shared memory as wgmma's B, ew's fragments split in
//      registers as A (the product is computed transposed); it also flags
//      the padding sink's row (a whole segment of self-loops);
//   3. gru_round_tc_kernel (per round): for its 64 nodes, the in-order edge
//      sum (indices loaded a window ahead; a run of one sender added in
//      closed form, bit for bit the serial chain; a segment that is one
//      run, the sink's, summed by the whole block at one column a thread),
//      both 3-gate products on `wgmma` with the gate weights staged by TMA
//      bulk copies through a two-stage ring (r and z each one sum of
//      agg @ xw and h @ hw, four 64 x 64 accumulators a warpgroup), and
//      the GRU epilogue into h'. Flagged rows (the sink: its aggregate is
//      thousands of times its message, and its saturated gates turn any
//      other rounding of the products into a visible difference) stay out
//      of the tiles and take the FFMA variant's arithmetic, bit for bit.
//
// `ffma` (any other width that fits, and the yardstick): the kernel below
// from ggnn_common.cuh, in float32 on the FFMA units.
//   1. csr_kernel (once per call): row_ptr[v] = first edge whose receiver
//      is >= v, by binary search over the receiver-sorted edge list.
//   2. linear_kernel (per round): msg = h @ ew + eb, a tile of 16 rows by
//      128 columns per block, weight rows staged through shared memory.
//   3. gru_round_kernel (per round): for its 16 rows, one warp per row sums
//      msg[s] over the row's CSR segment in edge-list order, then both
//      3-gate products run from shared memory and the GRU epilogue writes
//      h'. The padding sink's segment is one serial chain of adds.
//
// Both: every launch is on the caller's stream, none synchronises, each is
// checked with cudaGetLastError by the caller. The TPU kept h in VMEM across
// the rounds of one sequential grid; on Hopper blocks run in no order, and
// a node's aggregate needs the messages of arbitrary other nodes, so each
// round needs a grid-wide barrier (a launch) after the edge linear. No float
// atomics: the edge sum's order is the JAX reference's (edge-list order per
// receiver) and reruns are bitwise equal. In training the wrapper gives each
// round its own output buffer (the bank of pre-update states the backward
// reads) and the round also writes its aggregate agg_t to a bank.

#include "ggnn_common.cuh"
#include "ggnn_tc.cuh"

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

// The tensor-core variant (width 128): row_ptr from the receivers and the
// change bitmask `heads` (ceil(n_edges / 1024) words, at least one) of
// the senders.
int ggnn_tc_prep(const int* receivers, const int* senders, int n_edges,
                 int n_nodes, int* row_ptr, unsigned int* heads,
                 void* stream) {
  return launch_tc_prep(receivers, senders, n_edges, n_nodes, row_ptr, heads,
                        (cudaStream_t)stream);
}

// The edge linear; it also writes flags [n] (the padding-sink rows, which
// it and the round compute in the FFMA arithmetic).
int ggnn_tc_linear(const float* a, const float* w, const float* b,
                   const int* row_ptr, const int* senders,
                   const unsigned int* heads, int* flags, float* out, int n,
                   void* stream) {
  return launch_tc_linear(a, w, b, row_ptr, senders, heads, flags, out, n,
                          (cudaStream_t)stream);
}

int ggnn_tc_round(const float* h, const float* msg, const int* row_ptr,
                  const int* senders, const unsigned int* heads,
                  const int* flags, const float* xw, const float* xb,
                  const float* hw, const float* hb, float* h_out,
                  float* agg_bank, int n, void* stream) {
  return launch_tc_round(h, msg, row_ptr, senders, heads, flags, xw, xb, hw,
                         hb, h_out, agg_bank, n, (cudaStream_t)stream);
}

// Largest width the FFMA variant's per-round kernels can take (shared
// memory per block).
int ggnn_max_width(void) {
  return width_limit(sizeof(float) * 2 * kRows,
                     sizeof(float) * 2 * (size_t)kChunk * 3 * kCols);
}

const char* ggnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
