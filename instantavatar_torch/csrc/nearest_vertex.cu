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
// The nearest-vertex warp (nearest_warp_*, below the search): each
// sample's canonical point through its nearest vertex's inverse
// transform, forward and backward, for the SMPL deformer.
//
// Plain C interface, loaded with ctypes: each entry point launches one
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

// ---- the nearest-vertex warp ----------------------------------------------
//
// xc = R p + t for each sample p, where [R | t] are rows 0-2 of T_inv[idx]
// of the (V, 4, 4) per-vertex inverse transforms, and its backward, in
// place of the SMPL deformer's plain version (ops/knn.py:nearest_warp_ref:
// the (M, 4, 4) gather T_inv[idx], a batched matmul and an add). The JAX
// package computes the same in XLA (instantavatar_tpu/deformers/
// smpl_deformer.py, deform). The plain version's backward goes through
// PyTorch's index_put_(accumulate=True): it sorts the M indices and walks
// each run of equal ones serially in one warp, and in a fit step all the
// samples of a ray, and every sample outside the body, share a few
// vertices: 5.8 ms of a 16 ms step on an H100 for 262,144 samples, whose
// bytes take ~3.4 us at the HBM rate.
//
// Forward, a thread a sample: rows 0-2 of its vertex (the table, 7,008 x
// 48 B, stays in L2), xc written; nothing of size (M, 4, 4) is made. Each
// coordinate rounds as the plain version's batched matmul does on the
// card, fma(R1, y, R0 * x) + R2 * z, then + t: bit-equal to it. (The fit's
// pose gradient sees the last bit of xc, through the finest hash levels'
// weights.)
//
// Backward, a thread a sample:
//  - grad_pts = R^T grad_xc (when asked for), rounded as the plain
//    version's matmul backward at a fit's batch, fma(R1c, g1, R0c * g0) +
//    R2c * g2 (below ~100 rows cuBLAS takes another order);
//  - grad_T[v, r, :] += grad_xc[r] * [p, 1] for r = 0..2 (row 3 stays
//    zero), into a zeroed (V, 4, 4) table. The lanes of a warp that add
//    to one vertex (a run: __match_any_sync on the index) are summed in
//    lane order, that is in sample order, by the run's lowest lane, term
//    by term as the plain version rounds them (products, then adds; no
//    FMA), and that lane adds the sums with three float4 atomics. The
//    samples of a ray are consecutive, so a warp mostly holds a few runs.
//    A lane whose grad_xc is exactly zero (every sample outside the
//    threshold) adds nothing: +0.0 changes no sum. Where a vertex's
//    samples lie in one warp its sum is the plain version's, bit for bit;
//    across warps the atomics add the warps' sums in an order that varies
//    from run to run.
//  - Under deterministic algorithms the wrapper sorts the indices stably
//    (torch.sort), finds each vertex's run (torch.searchsorted), and
//    nearest_warp_runs sums each (vertex, row) in sample order, a thread
//    each, as the plain version's sorted backward does: the same bits
//    from run to run, and the plain version's bits on the card. That
//    path is not a speed target (one long run is one thread's).
// An index outside [0, V) gives a NaN point and no gradient.

namespace {

constexpr int kWarpThreads = 256;   // threads a block of the warp kernels
constexpr unsigned kFullMask = 0xffffffffu;

// rows 0-2 of vertex v's transform
__device__ __forceinline__ void load_rows(const float4* __restrict__ T,
                                          int64_t v, float4 (&row)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) row[r] = __ldg(T + 4 * v + r);
}

// a . (x, y, z) as cuBLAS's batched K = 3 products round it in the plain
// version (probed on the card, every order of the three terms against
// its bmm, batches of 100 to 262,144 rows): fma(a1, y, a0 * x) + a2 * z
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float x,
                                      float y, float z) {
  return __fadd_rn(__fmaf_rn(a1, y, __fmul_rn(a0, x)), __fmul_rn(a2, z));
}

__device__ __forceinline__ bool in_table(int64_t v, int V) {
  return v >= 0 && v < V;
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ void add_row(float4* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(dst, v);
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d, v.x);
  atomicAdd(d + 1, v.y);
  atomicAdd(d + 2, v.z);
  atomicAdd(d + 3, v.w);
#endif
}

__global__ void __launch_bounds__(kWarpThreads)
    nearest_warp_forward(const float4* __restrict__ T,
                         const int64_t* __restrict__ idx,
                         const float* __restrict__ pts,
                         float* __restrict__ xc, long long M, int V) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpThreads + threadIdx.x;
  if (i >= M) return;
  const int64_t v = idx[i];
  const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
  float out[3] = {quiet_nan(), quiet_nan(), quiet_nan()};
  if (in_table(v, V)) {
    float4 row[3];
    load_rows(T, v, row);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      out[r] = __fadd_rn(dot3(row[r].x, row[r].y, row[r].z, x, y, z),
                         row[r].w);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) xc[3 * i + r] = out[r];
}

// grad_T or grad_pts may be null (not asked for); every lane of the grid
// reaches the warp's collectives, so no lane returns early
__global__ void __launch_bounds__(kWarpThreads)
    nearest_warp_backward(const float4* __restrict__ T,
                          const int64_t* __restrict__ idx,
                          const float* __restrict__ pts,
                          const float* __restrict__ grad_xc,
                          float4* __restrict__ grad_T,
                          float* __restrict__ grad_pts, long long M, int V) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float g[3] = {0.f, 0.f, 0.f}, p[3] = {0.f, 0.f, 0.f};
  int64_t v = -1;
  if (i < M) {
    v = idx[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g[c] = grad_xc[3 * i + c];
      p[c] = pts[3 * i + c];
    }
  }
  const bool ok = i < M && in_table(v, V);
  if (grad_pts != nullptr && i < M) {
    float d[3] = {quiet_nan(), quiet_nan(), quiet_nan()};
    if (ok) {
      float4 row[3];
      load_rows(T, v, row);
      d[0] = dot3(row[0].x, row[1].x, row[2].x, g[0], g[1], g[2]);
      d[1] = dot3(row[0].y, row[1].y, row[2].y, g[0], g[1], g[2]);
      d[2] = dot3(row[0].z, row[1].z, row[2].z, g[0], g[1], g[2]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) grad_pts[3 * i + c] = d[c];
  }
  if (grad_T == nullptr) return;   // the same for the whole grid
  const bool adds = ok && (g[0] != 0.f || g[1] != 0.f || g[2] != 0.f);
  // a lane that adds nothing is a run of its own
  const unsigned long long key =
      adds ? static_cast<unsigned long long>(v) : ~0ULL - lane;
  const unsigned run = __match_any_sync(kFullMask, key);
  const int leader = __ffs(run) - 1;
  float acc[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = __fmul_rn(g[r], p[c]);
    acc[r][3] = g[r];
  }
  // every other lane of a run, in lane order, into the run's lowest lane
  for (unsigned rest = __ballot_sync(kFullMask, adds && lane != leader);
       rest; rest &= rest - 1) {
    const int k = __ffs(rest) - 1;
    float gk[3], pk[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gk[c] = __shfl_sync(kFullMask, g[c], k);
      pk[c] = __shfl_sync(kFullMask, p[c], k);
    }
    if (adds && lane == leader && (run >> k & 1u)) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(gk[r], pk[c]));
        acc[r][3] = __fadd_rn(acc[r][3], gk[r]);
      }
    }
  }
  if (adds && lane == leader) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
      add_row(grad_T + 4 * v + r,
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
}

// a thread per (vertex, row): the vertex's run of the stably sorted
// samples (perm[offsets[v]:offsets[v + 1]]) summed in sample order
__global__ void __launch_bounds__(kWarpThreads)
    nearest_warp_runs(const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ offsets,
                      const float* __restrict__ pts,
                      const float* __restrict__ grad_xc,
                      float4* __restrict__ grad_T, int V) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarpThreads + threadIdx.x;
  if (t >= 3LL * V) return;
  const int v = static_cast<int>(t / 3), r = static_cast<int>(t % 3);
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t k = offsets[v]; k < offsets[v + 1]; ++k) {
    const int64_t i = perm[k];
    const float g = grad_xc[3 * i + r];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a[c] = __fadd_rn(a[c], __fmul_rn(g, pts[3 * i + c]));
    a[3] = __fadd_rn(a[3], g);
  }
  grad_T[4 * v + r] = make_float4(a[0], a[1], a[2], a[3]);
}

int warp_blocks(long long n, unsigned* blocks) {
  const long long b = (n + kWarpThreads - 1) / kWarpThreads;
  if (n < 0 || b >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned>(b);
  return 0;
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

// T_inv (V, 4, 4) fp32 (16-byte aligned), idx (M,) int64 and pts (M, 3)
// fp32, contiguous -> xc (M, 3). M = 0 launches nothing.
int nearest_warp_forward_launch(const float* T_inv, const int64_t* idx,
                                const float* pts, float* xc, long long M,
                                int V, cudaStream_t stream) {
  unsigned blocks = 0;
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = warp_blocks(M, &blocks)) return err;
  if (M == 0) return 0;
  nearest_warp_forward<<<blocks, kWarpThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(T_inv), idx, pts, xc, M, V);
  return static_cast<int>(cudaGetLastError());
}

// grad_xc (M, 3) -> grad_T (V, 4, 4), zeroed by the caller, added to by
// atomics (null: not asked for), and grad_pts (M, 3) (null: not asked
// for); T_inv is read only for grad_pts.
int nearest_warp_backward_launch(const float* T_inv, const int64_t* idx,
                                 const float* pts, const float* grad_xc,
                                 float* grad_T, float* grad_pts,
                                 long long M, int V, cudaStream_t stream) {
  unsigned blocks = 0;
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = warp_blocks(M, &blocks)) return err;
  if (M == 0 || (grad_T == nullptr && grad_pts == nullptr)) return 0;
  nearest_warp_backward<<<blocks, kWarpThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(T_inv), idx, pts, grad_xc,
      reinterpret_cast<float4*>(grad_T), grad_pts, M, V);
  return static_cast<int>(cudaGetLastError());
}

// the deterministic grad_T: perm (M,) the stable sort's order of idx,
// offsets (V + 1,) where each vertex's run starts in it; rows 0-2 of
// grad_T written (row 3 is the caller's zeros)
int nearest_warp_runs_launch(const int64_t* perm, const int64_t* offsets,
                             const float* pts, const float* grad_xc,
                             float* grad_T, int V, cudaStream_t stream) {
  unsigned blocks = 0;
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = warp_blocks(3LL * V, &blocks)) return err;
  nearest_warp_runs<<<blocks, kWarpThreads, 0, stream>>>(
      perm, offsets, pts, grad_xc, reinterpret_cast<float4*>(grad_T), V);
  return static_cast<int>(cudaGetLastError());
}

const char* nearest_vertex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
