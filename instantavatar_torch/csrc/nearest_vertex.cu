// Exact nearest vertex (1-NN) for Hopper (sm_90a): for each of M points
// the squared distance to its nearest of V vertices and that vertex's
// index, with no (points, vertices) distance matrix in device memory.
//
// Replaces no Pallas kernel: the JAX package computes the same function in
// XLA (instantavatar_tpu/deformers/smpl_deformer.py:67, nearest_vertex, a
// chunked squared-distance matmul and an argmin), and so did the port's
// plain version (ops/knn.py:nearest_vertex_ref), which writes a (chunk, V)
// fp32 matrix to device memory and reads it back about eight times: ~59 GB
// for the per-pose shell grid's 64^3 cells against 7,008 vertices, 23 ms.
// It serves the per-pose shell grid (AvatarModel._shell_grid, every
// animate frame and smpl_init), and the SMPL deformer's per-sample search.
//
// Same numbers as the plain version on the card, bit for bit:
//  - d^2 = |x|^2 - 2 x.v + |v|^2 in fp32, rounded where PyTorch rounds it:
//    |p|^2 as (p * p).sum(-1) sums its three rounded squares on the card,
//    (x^2 + z^2) + y^2 (Reduce.cuh: a three-wide row is two lanes, the
//    first summing elements 0 and 2, then one shuffle); x.v as cuBLAS's
//    fp32 K = 3 product accumulates it, fma(z, vz, fma(y, vy, x * vx));
//    then fma(-2, x.v, |x|^2) (-2 * x.v is exact, so this is the plain
//    version's c2 - 2 * dot) and + |v|^2. Intrinsics throughout: nvcc may
//    contract nothing. (Probed on the card, each order against the
//    others. The plain version's own rounding of x.v depends on its
//    chunk's rows: cuBLAS takes other kernels for a chunk of one row, and
//    at V = 192 of 2-7 rows (unfused products), which differ in the last
//    bit of some dots; from ~100 rows up, every full chunk of 8,192
//    included, it is the order above. The kernel holds that one order at
//    every M.)
//  - The minimum over the vertices in index order, a later vertex taken
//    only when strictly nearer, so an exact tie keeps the first index, as
//    torch.min does; a NaN distance counts as the least and the first NaN
//    wins, as in torch.min. The distance is then clamped at 0 (a NaN stays
//    NaN), the index written as int64.
//  - Each point's search is one thread's, in one order: no atomics, runs
//    are bit-equal.
//
// What bounds it: operations. A (point, vertex) pair is 8 fp32
// instructions (the multiply and two FMAs of the dot, the FMA and add of
// the expansion, the compare, and two selects for the running minimum and
// its index); the 3 MB of points and 84 KB of vertices read and 3 MB
// written are ~2 us at the HBM rate. 262,144 cells x 7,008 vertices is
// 14.7 G instructions, 0.22 ms at the fp32 rate (chip_smoke.knn_bound).
//
// The design:
//  - Vertices are staged per block in dynamic shared memory as (x, y, z,
//    |v|^2) float4, a tile of up to kMaxTile (112 KB, so two blocks fit an
//    SM); V above a tile loops over tiles in index order. Every thread
//    reads the same vertex at once: one broadcast load serves the warp.
//  - Each thread holds kPoints = 4 points and their running (d^2, index)
//    in registers, and reuses each vertex it loads for all 4 of them; the
//    4 chains are independent, which hides the FMA latency. At equal work
//    per SM 4 points a thread were 13-18% faster than 1 and 7-9% faster
//    than 2 (8 was 4% slower, at 80 registers). Tiles of 512-2,048
//    vertices were no faster than all of V (PERF.md).
//  - The NaN-aware compare costs instructions, so it runs only in a block
//    whose points or tile hold a squared norm that is not below 1e36
//    (a NaN, an infinity, or a size whose d^2 could overflow); below it
//    every d^2 is finite and a strict compare is the same rule.
//
// Plain C interface, loaded with ctypes: the entry point launches one
// kernel on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 4;              // points a thread
constexpr int kBlockPoints = kThreads * kPoints;
constexpr int kMaxTile = 7168;          // 112 KB of float4
constexpr int kMaxDevices = 64;
// squared norms below it give finite distances (|d^2| < 4e36)
constexpr float kSafeSq = 1e36f;

// |p|^2 as PyTorch's (p * p).sum(-1) rounds it on the card
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                   __fmul_rn(y, y));
}

// |x|^2 - 2 x.v + |v|^2 as the plain version rounds it on the card
__device__ __forceinline__ float sq_dist(float x, float y, float z, float c2,
                                         float4 v) {
  const float dot = __fmaf_rn(z, v.z, __fmaf_rn(y, v.y, __fmul_rn(x, v.x)));
  return __fadd_rn(__fmaf_rn(-2.f, dot, c2), v.w);
}

// torch.min's order: a NaN is less than any number, ties go to the first
template <bool kNaN>
__device__ __forceinline__ bool nearer(float d, float best) {
  if (kNaN) return d != d ? best == best : d < best;
  return d < best;
}

// one tile of n vertices (global indices base, base + 1, ...) against the
// thread's kPoints points
template <bool kNaN>
__device__ __forceinline__ void scan(
    const float4* __restrict__ tile, int n, int base,
    const float (&x)[kPoints], const float (&y)[kPoints],
    const float (&z)[kPoints], const float (&c2)[kPoints],
    float (&best)[kPoints], int (&arg)[kPoints]) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 v = tile[j];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const float d = sq_dist(x[k], y[k], z[k], c2[k], v);
      if (nearer<kNaN>(d, best[k])) {
        best[k] = d;
        arg[k] = base + j;
      }
    }
  }
}

// A block of kThreads threads, kPoints points each: point first + k *
// kThreads for k < kPoints, so that the block's loads and stores of a k
// are contiguous.
__global__ void __launch_bounds__(kThreads)
    nearest_vertex_kernel(const float* __restrict__ pts,
                          const float* __restrict__ verts,
                          float* __restrict__ dist,
                          int64_t* __restrict__ idx, long long M, int V,
                          int tile) {
  extern __shared__ float4 s_verts[];
  const long long first =
      static_cast<long long>(blockIdx.x) * kBlockPoints + threadIdx.x;
  float x[kPoints], y[kPoints], z[kPoints], c2[kPoints], best[kPoints];
  int arg[kPoints];
  bool unsafe = false;
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const long long i = first + k * kThreads;
    x[k] = y[k] = z[k] = 0.f;   // a padding point, never written
    if (i < M) {
      x[k] = pts[3 * i];
      y[k] = pts[3 * i + 1];
      z[k] = pts[3 * i + 2];
    }
    c2[k] = sq_norm(x[k], y[k], z[k]);
    unsafe |= !(c2[k] < kSafeSq);
    best[k] = __int_as_float(0x7f800000);   // +inf
    arg[k] = 0;
  }
  for (int t0 = 0; t0 < V; t0 += tile) {
    const int n = min(tile, V - t0);
    if (t0) __syncthreads();   // every thread is done with the last tile
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* v = verts + 3 * static_cast<long long>(t0 + j);
      const float w = sq_norm(v[0], v[1], v[2]);
      unsafe |= !(w < kSafeSq);
      s_verts[j] = make_float4(v[0], v[1], v[2], w);
    }
    if (__syncthreads_or(unsafe))
      scan<true>(s_verts, n, t0, x, y, z, c2, best, arg);
    else
      scan<false>(s_verts, n, t0, x, y, z, c2, best, arg);
  }
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const long long i = first + k * kThreads;
    if (i < M) {
      dist[i] = best[k] < 0.f ? 0.f : best[k];   // a NaN stays NaN
      idx[i] = arg[k];
    }
  }
}

// Raise the kernel's dynamic shared-memory limit to a whole tile, once per
// device (at the first launch there, eager: a graph capture then finds it
// set).
cudaError_t allow_tiles() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(nearest_vertex_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxTile * static_cast<int>(sizeof(float4)));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// pts (M, 3) and verts (V, 3) fp32 contiguous -> dist (M,) fp32 and idx
// (M,) int64, in blocks of kBlockPoints points. M = 0 launches nothing.
int nearest_vertex_launch(const float* pts, const float* verts, float* dist,
                          int64_t* idx, long long M, int V,
                          cudaStream_t stream) {
  if (M < 0 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const long long blocks = (M + kBlockPoints - 1) / kBlockPoints;
  if (blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = allow_tiles();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = min(V, kMaxTile);
  nearest_vertex_kernel<<<static_cast<unsigned>(blocks), kThreads,
                          tile * sizeof(float4), stream>>>(
      pts, verts, dist, idx, M, V, tile);
  return static_cast<int>(cudaGetLastError());
}

const char* nearest_vertex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
