// Fused canonical-field head for Hopper (sm_90a): sigma MLP E -> 64 -> 16
// (sigma = geo[0]) and colour MLP geo[1:16] 15 -> 64 -> 64 -> 3 (ReLU,
// ReLU, sigmoid) in one kernel, forward only.
//
// Replaces the Pallas TPU kernel instantavatar_tpu/ops/fused_head.py
// (fused_field_head, body _kernel). Same numerical contract: bf16
// operands, fp32 accumulation, each hidden bias added in fp32 BEFORE the
// ReLU and the bf16 cast, output layers kept in fp32. The input is taken
// as bf16 directly (the TPU kernel's f32 -> bf16 round trip is lossless
// for the bf16 features the field encodes). Ragged row counts are masked
// in-kernel; there is no padding to a tile multiple.
//
// What bounds it: per row 112 B in (E = 56 bf16) and 16 B out against
// 9,856 MACs (19.7 kFLOP), so this scalar version is bound by CUDA-core
// FMA throughput, not by memory. Design: one thread per row; all weights
// (converted once per block to fp32, ~39 KB) and biases in shared memory,
// read as float4 broadcasts (every thread of a warp reads the same
// weight), so one LDS.128 feeds four FMAs; the row's input and hidden
// activations live in registers (fully unrolled loops). Moving the
// 64-wide layers onto the tensor cores (mma.sync / wgmma) is the
// follow-up.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHs = 64;          // sigma hidden width
constexpr int kGeo = 16;         // geo features; sigma = geo[0]
constexpr int kCin = kGeo - 1;   // colour input width
constexpr int kHc = 64;          // colour hidden width
constexpr int kThreads = 128;    // rows per block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16 pair packed in one 32-bit word (element 0 in the low half)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// acc[j] += x * W[j] over a 64-wide shared-memory weight row
template <int N>
__device__ __forceinline__ void fma_row(float (&acc)[N], float x,
                                        const float* __restrict__ wrow) {
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 w = w4[j];
    acc[4 * j + 0] = fmaf(x, w.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(x, w.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(x, w.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(x, w.w, acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void stage(float* dst,
                                      const __nv_bfloat16* __restrict__ src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = __bfloat162float(src[i]);
}

__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <int E>
__global__ void __launch_bounds__(kThreads)
fused_head_kernel(const __nv_bfloat16* __restrict__ enc,
                  const __nv_bfloat16* __restrict__ w0,
                  const float* __restrict__ b0,
                  const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ cw0,
                  const float* __restrict__ cb0,
                  const __nv_bfloat16* __restrict__ cw1,
                  const float* __restrict__ cb1,
                  const __nv_bfloat16* __restrict__ cw2,
                  const float* __restrict__ cb2,
                  float* __restrict__ color, float* __restrict__ sigma,
                  int M) {
  static_assert(E % 8 == 0, "rows are read as 16-byte vectors");
  __shared__ __align__(16) float s_w0[E * kHs];
  __shared__ __align__(16) float s_w1[kHs * kGeo];
  __shared__ __align__(16) float s_cw0[kCin * kHc];
  __shared__ __align__(16) float s_cw1[kHc * kHc];
  __shared__ __align__(16) float s_cw2[kHc * 3];
  __shared__ __align__(16) float s_b0[kHs];
  __shared__ __align__(16) float s_b1[kGeo];
  __shared__ __align__(16) float s_cb0[kHc];
  __shared__ __align__(16) float s_cb1[kHc];
  __shared__ float s_cb2[3];

  stage(s_w0, w0, E * kHs);
  stage(s_w1, w1, kHs * kGeo);
  stage(s_cw0, cw0, kCin * kHc);
  stage(s_cw1, cw1, kHc * kHc);
  stage(s_cw2, cw2, kHc * 3);
  stage(s_b0, b0, kHs);
  stage(s_b1, b1, kGeo);
  stage(s_cb0, cb0, kHc);
  stage(s_cb1, cb1, kHc);
  stage(s_cb2, cb2, 3);
  __syncthreads();

  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= M) return;

  // input row: E bf16 as E/8 16-byte loads
  float x[E];
  const uint4* src = reinterpret_cast<const uint4*>(enc) + (size_t)row * (E / 8);
#pragma unroll
  for (int v = 0; v < E / 8; ++v) {
    const uint4 q = __ldg(src + v);
    x[8 * v + 0] = bf16_lo(q.x); x[8 * v + 1] = bf16_hi(q.x);
    x[8 * v + 2] = bf16_lo(q.y); x[8 * v + 3] = bf16_hi(q.y);
    x[8 * v + 4] = bf16_lo(q.z); x[8 * v + 5] = bf16_hi(q.z);
    x[8 * v + 6] = bf16_lo(q.w); x[8 * v + 7] = bf16_hi(q.w);
  }

  // sigma trunk: E -> 64, fp32 bias, ReLU, bf16
  float h[kHs];
#pragma unroll
  for (int j = 0; j < kHs; ++j) h[j] = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) fma_row(h, x[k], s_w0 + k * kHs);
#pragma unroll
  for (int j = 0; j < kHs; ++j) h[j] = bf16_round(fmaxf(h[j] + s_b0[j], 0.f));

  // 64 -> 16 geo features, fp32
  float geo[kGeo];
#pragma unroll
  for (int j = 0; j < kGeo; ++j) geo[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kHs; ++k) fma_row(geo, h[k], s_w1 + k * kGeo);
#pragma unroll
  for (int j = 0; j < kGeo; ++j) geo[j] += s_b1[j];
  sigma[row] = geo[0];

  // colour: geo[1:16] (bf16) -> 64 -> 64 -> 3
  float c1[kHc];
#pragma unroll
  for (int j = 0; j < kHc; ++j) c1[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kCin; ++k)
    fma_row(c1, bf16_round(geo[k + 1]), s_cw0 + k * kHc);
#pragma unroll
  for (int j = 0; j < kHc; ++j)
    c1[j] = bf16_round(fmaxf(c1[j] + s_cb0[j], 0.f));

  float c2[kHc];
#pragma unroll
  for (int j = 0; j < kHc; ++j) c2[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kHc; ++k) fma_row(c2, c1[k], s_cw1 + k * kHc);
#pragma unroll
  for (int j = 0; j < kHc; ++j)
    c2[j] = bf16_round(fmaxf(c2[j] + s_cb1[j], 0.f));

  float o[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kHc; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) o[j] = fmaf(c2[k], s_cw2[k * 3 + j], o[j]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    color[(size_t)row * 3 + j] = 1.f / (1.f + expf(-(o[j] + s_cb2[j])));
}

template <int E>
cudaError_t launch(const void* enc, const void* w0, const void* b0,
                   const void* w1, const void* b1, const void* cw0,
                   const void* cb0, const void* cw1, const void* cb1,
                   const void* cw2, const void* cb2, void* color,
                   void* sigma, int M, cudaStream_t stream) {
  const dim3 grid((M + kThreads - 1) / kThreads);
  fused_head_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(enc),
      static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(b0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(cw0), static_cast<const float*>(cb0),
      static_cast<const __nv_bfloat16*>(cw1), static_cast<const float*>(cb1),
      static_cast<const __nv_bfloat16*>(cw2), static_cast<const float*>(cb2),
      static_cast<float*>(color), static_cast<float*>(sigma), M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Encoder widths compiled in (the flagship E = 8 + 3 * 16); the Python
// wrapper checks against this list. A width is one more case below.
int fused_field_head_supports(int E) { return E == 56; }

int fused_field_head_launch(const void* enc, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* cw0,
                            const void* cb0, const void* cw1, const void* cb1,
                            const void* cw2, const void* cb2, void* color,
                            void* sigma, int M, int E, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 56:
      return launch<56>(enc, w0, b0, w1, b1, cw0, cb0, cw1, cb1, cw2, cb2,
                        color, sigma, M, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_field_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
