// int8-weight matrix product for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` of deepdfa_tpu/ops/int8_matmul.py
// (launched by `_int8_matmul`, public `int8_matmul`). It computes
//     y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
// with x float32 or bf16, q int8 (symmetric per-output-channel weights),
// scale float32 and y float32 or bf16: the per-column scale distributes out
// of the contraction, so it is applied once per output, in the epilogue. As
// in the TPU kernel, bf16 activations are converted to float32 (here on
// their way into shared memory), summed in float32 and the scaled sum is
// rounded to the output type once.
//
// What bounds it on this card. For the GGNN's conv products (K = 128,
// N = 128 or 384, M = the padded node count) the work is 2*M*K*N FFMA
// FLOPs against 4*M*(K + N) bytes of activations; at K = 128 that is 32 to
// 48 FLOPs per byte, above the FP32 ridge of 67e12 / 3.35e12 = 20, so it is
// bound by FP32 operations. The int8 weight is at most 48 KB and stays in
// L2. The LLM's projections (M = 1024 tokens, K and N 4096 or 11008, bf16
// activations) do 2*M FLOPs per weight byte, 2048: bound by operations too.
//
// What the design does about that. The TPU kernel walked a sequential grid
// with K innermost and accumulated each output tile in place across K steps.
// Here one block owns one 64 x 128 output tile and loops over K itself, so
// nothing carries between blocks and there are no atomics. Per 32-deep K
// step the block stages the x tile (float32) and the q tile in shared
// memory: q is read from global memory as int8 and dequantized to float32
// in registers on the way in (each weight once per block; the values are
// exact integers, the scale waits for the epilogue), which keeps the
// int-to-float conversions, far slower per clock than FFMA, out of the
// inner loop (there each weight would be converted once per thread row).
// Each of the 256 threads then accumulates a 4 x 8 tile with FFMA in a
// fixed order over K (k = 0, 1, ..., K - 1 for every output), so two calls
// on the same inputs are bitwise equal. No TF32 and no tensor
// cores: the port's parity bar is float32. Any M, K and N are taken; the
// ragged edges are masked in the kernel, nothing is padded in memory. The
// bf16 instantiation differs only in the x load and the output store, so
// the float32 path is the same code as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 32;        // K depth staged per shared-memory pass
constexpr int kTM = 4;         // rows per thread: ty * 4 + i
// columns per thread: tx * 4 + j and 64 + tx * 4 + j for j < 4, so a
// half-warp's float4 reads of a weight row are contiguous

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, TY* __restrict__ y,
                   int m, int k, int n) {
  __shared__ float xs[kBM][kBK + 1];          // x tile, padded rows
  __shared__ __align__(16) float ws[kBK][kBN];  // dequantized q tile
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x tile: a warp reads one row's 32 consecutive K values
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int row = row0 + r, kk = k0 + c;
      xs[r][c] = (row < m && kk < k) ? to_f32(x[(size_t)row * k + kk]) : 0.f;
    }
    // q tile: int8 from global memory, consecutive threads on consecutive
    // columns, converted to float32 in registers
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i - r * kBN;
      const int kk = k0 + r, col = col0 + c;
      ws[r][c] = (kk < k && col < n) ? (float)q[(size_t)kk * n + col] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kBK, k - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[ty * kTM + i][kk];
      const float4 lo = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 hi = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the per-column scale, once per output
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < n) store(&y[(size_t)row * n + col], acc[i][j] * scale[col]);
    }
  }
}

template <typename TX, typename TY>
int launch(const TX* x, const int8_t* q, const float* scale, TY* y, int m,
           int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int8_matmul_kernel<TX, TY><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, q, scale, y, m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the product on `stream` and returns cudaGetLastError() as an
// int: 0 when the launch was accepted. Launches nothing for an empty output.
int i8_matmul(const float* x, const int8_t* q, const float* scale, float* y,
              int m, int k, int n, void* stream) {
  return launch(x, q, scale, y, m, k, n, stream);
}

// The same with bf16 activations; `y` is bf16 when `out_bf16` is non-zero,
// float32 otherwise.
int i8_matmul_bf16(const void* x, const int8_t* q, const float* scale,
                   void* y, int m, int k, int n, int out_bf16, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (out_bf16)
    return launch(xb, q, scale, static_cast<__nv_bfloat16*>(y), m, k, n,
                  stream);
  return launch(xb, q, scale, static_cast<float*>(y), m, k, n, stream);
}

const char* i8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
