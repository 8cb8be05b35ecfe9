// Multi-resolution hash-grid encode (Instant-NGP) for Hopper (sm_90a):
// forward, the table's gradient (fp32 atomics, or a deterministic run sum
// over rows sorted by the caller) and the points' gradient, for any
// number of features per row F and up to kMaxLevels levels.
//
// Replaces instantavatar_tpu/ops/hashgrid.py:82 (hash_encode: XLA gathers
// and a trilerp chain per level, XLA's scatter-add backward), which in
// turn replaced tiny-cuda-nn's HashGrid encoding in the reference
// InstantAvatar. Same semantics as the port's plain version
// (ops/hashgrid.py:hash_encode_ref), level for level:
//  - x clipped to [0, 1] as min(max(x, 0), 1), a NaN staying NaN;
//  - pos = x * res and frac = pos - floor(pos), each rounded on its own
//    (__fmul_rn / __fsub_rn: no FMA contraction, so floor sees the same
//    fp32 value as the CPU at lattice points x = k / res);
//  - the cell clamped to [0, res] in integer space after the conversion,
//    so a NaN point (NaN features) never indexes outside its level;
//  - corner c = 4 i + 2 j + k at offset (i, j, k), clamped to res; a level
//    with (res + 1)^3 <= T indexed densely, x + y (res + 1) + z (res + 1)^2,
//    the others hashed in uint32 with wraparound, (x * 1) ^ (y *
//    2654435761) ^ (z * 805459861), masked with T - 1 (the low bits of the
//    port's int64 products and of JAX's wrapped uint32);
//  - the weight (wx * wy) * wz in fp32, in that order.
//
// What bounds it. By bytes, 12 B of x in and L * F * 4 B of features out
// per point plus each touched row once (chip_smoke.encode_bound); the
// ~60 FLOPs per point and level are < 1% of that at the fp32 rate. In
// practice two other rates hold it (PERF.md): where rows are shared (the
// coarse levels, a training call's repeated points) the per-(point,
// level) work itself, ~0.18 ms for a training call's 16.8M (point,
// level) items even with the table loads taken out; where they are not
// (an animate frame's fine levels) the rate of 32-byte sector requests,
// one random row per corner: the earlier design (a thread per (point,
// level), point-major, 8 row loads) took 0.083 ms per such level of
// 1.77M points even on a one-level, L2-resident view of the table, ~171G
// sectors/s.
//
// The design, for this card (each choice held against the others on the
// card with tools/torch_encode_bench.py; PERF.md):
//  - A thread per (point, level), as before, but no 64-bit division per
//    thread, and level-major: the levels come in groups whose features
//    fill one 32-byte sector of a point's row (4 levels at F = 2; never
//    more lanes than the table has levels, rounded up to a power of two,
//    so a small table idles none), and the group is the grid's slow
//    dimension, so the card gathers from 4
//    levels' slices at a time (16 MiB at the default grid, which L2
//    holds) and finishes them for every point before the next group.
//    Inside a block the level is the fast index, so the group's lanes of
//    a point store its sector whole; no shared-memory staging, which
//    measured slower. Groups of 8 or 16 levels were slower at the animate
//    call (8 faster at the training call), groups of 2 (staged) slower at
//    both.
//  - Corners visited as x-neighbour pairs (0, 4, 1, 5, ...): the x prime
//    of the hash is 1 and a dense level's x stride is one row, so the
//    rows of x and x + 1 often share a sector. Loading a pair as one
//    vector when it is one aligned pair (s1 = s0 ^ 1) measured slower:
//    the branch costs more than the requests it saves.
//  - Rows are loaded, stored and added as vectors: float, float2, float4
//    or two float4 for F = 1, 2, 4, 8 (template instances); any other F
//    runs an instance with a feature loop, one level per group.
//
// Backward to the table: a thread per (point, level), full rows per group
// (128 B at the default grid: 16 levels; groups of one sector made it half
// again as slow on a training call, whose time is reading the incoming
// gradient, skipping its zeros and the atomics). Each thread adds w * g to
// its 8 corners' rows with native vector atomics (float2 / float4
// atomicAdd on sm_90); for F <= 2 an x-neighbour pair that is one aligned
// pair of rows takes one vector atomic (add_pair). The atomics are not
// aggregated within the warp: a shuffle sum of the lanes that hit one row
// adds fewer, larger terms to the row and so rounds differently from the
// plain version's sequential fp32 sum; on a training call's points, where
// a coarse row collects thousands of terms, that moved the table's
// gradient 2.3e-5 L2-relative from it, past the 1e-5 that reordered
// sequential sums stay within. A (point, level) whose gradient is zero is
// skipped before its cell is computed: a training call's padded samples
// repeat one point per ray and would otherwise pile atomics onto the same
// rows. The sum's order varies from run to run, so under deterministic
// algorithms the wrapper instead takes hash_encode_rows (each entry's flat
// row), sorts them stably (torch.sort: point order within a row), and sums
// each run of equal rows in that order in fixed chunks
// (hash_encode_run_pieces, then hash_encode_run_join for the runs that
// cross a chunk); that path is point-major and not a speed target.
//
// Backward to the points (fit's and refine's calls): four lanes a point,
// each summing res * sum_c dw_c / dfrac . <row_c, g> over every fourth
// level in order; two xor shuffles add the lanes' sums in one fixed
// order, and the sum is multiplied by JAX's clip derivative (1 inside (0,
// 1), 0.5 at exactly 0 or 1, 0 outside). Each point owns its gradient:
// deterministic. Against a thread walking all its levels it is 0.89x the
// time at a training call and 0.46x at an animate frame's points (more
// gathers in flight); two lanes and eight, and 32 points a block with the
// warps splitting the levels and summing in shared memory, were slower
// (PERF.md).
//
// Plain C interface, loaded with ctypes: each entry point launches one
// kernel on the caller's stream, allocates nothing, uses no shared memory
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 64;
constexpr int kThreads = 256;
// the floats of a point's row one level group fills: 32 B in the forward,
// the whole 128 B row at the default grid in the table's backward
constexpr int kForwardFloats = 8;
constexpr int kBackwardFloats = 32;

struct Levels {
  int res[kMaxLevels];
  uint64_t dense;      // bit l: level l is indexed densely
  uint32_t mask;       // T - 1
  int n;               // levels
  int f;               // features per row (read by the runtime-F instance)
  int64_t size;        // T
};

struct Cell {
  uint32_t c[3][2];   // per axis: corner coordinate at offset 0 and 1
  float frac[3];
};

// jnp.clip(x, 0, 1) as min(max(x, 0), 1); a NaN stays NaN
__device__ __forceinline__ float clip01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

__device__ __forceinline__ Cell cell_of(const float (&xp)[3], int res) {
  Cell cl;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(clip01(xp[a]), static_cast<float>(res));
    const float fl = floorf(pos);
    cl.frac[a] = __fsub_rn(pos, fl);
    // a NaN converts to 0 (cvt.rzi); the clamp keeps any value in range
    const int b = min(max(static_cast<int>(fl), 0), res);
    cl.c[a][0] = static_cast<uint32_t>(b);
    cl.c[a][1] = static_cast<uint32_t>(min(b + 1, res));
  }
  return cl;
}

__device__ __forceinline__ uint32_t slot(const Cell& cl, int corner,
                                         int res, bool dense,
                                         uint32_t mask) {
  const uint32_t x = cl.c[0][(corner >> 2) & 1];
  const uint32_t y = cl.c[1][(corner >> 1) & 1];
  const uint32_t z = cl.c[2][corner & 1];
  if (dense) {
    const uint32_t s = static_cast<uint32_t>(res) + 1u;
    return (x + y * s + z * s * s) & mask;
  }
  return ((x * 1u) ^ (y * 2654435761u) ^ (z * 805459861u)) & mask;
}

// per-axis weights of a corner: (1 - frac) at offset 0, frac at offset 1
__device__ __forceinline__ void axis_weights(const Cell& cl, int corner,
                                             float w[3]) {
  const int bit[3] = {(corner >> 2) & 1, (corner >> 1) & 1, corner & 1};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    w[a] = bit[a] ? cl.frac[a] : __fsub_rn(1.f, cl.frac[a]);
}

__device__ __forceinline__ float weight(const Cell& cl, int corner) {
  float w[3];
  axis_weights(cl, corner, w);
  return __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
}

// The k-th corner to visit: 0, 4, 1, 5, 2, 6, 3, 7. The corners x and
// x + 1 (y and z equal) come one after the other: the x prime of the hash
// is 1 and a dense level's x stride is one row, so their rows often share
// a sector, whose second load then follows its first.
__device__ __forceinline__ int x_pairs(int k) {
  return (k >> 1) | ((k & 1) << 2);
}

__device__ __forceinline__ void load_point(const float* __restrict__ x,
                                           int64_t p, bool live,
                                           float (&xp)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) xp[a] = live ? __ldg(x + 3 * p + a) : 0.f;
}

// ---- rows of F floats: vectors for F = 1, 2, 4, 8 -------------------------

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ r,
                                         float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(r);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(r));
    v[0] = a.x;
    v[1] = a.y;
  } else {
    static_assert(F % 4 == 0, "rows of 4 or 8 floats");
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(r) + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
}

template <int F>
__device__ __forceinline__ void add_row(float* r, const float (&v)[F]) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  if constexpr (F == 1) {
    atomicAdd(r, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(r), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(r) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                            v[4 * q + 3]));
  }
#else
#pragma unroll
  for (int q = 0; q < F; ++q) atomicAdd(r + q, v[q]);
#endif
}

// a0 to row s0 and a1 to row s1 of a corner pair (x offset 0 and 1, y
// and z equal). The x prime of the hash is 1 and a dense level's x stride
// is one row, so s1 = s0 ^ 1 half the time (an even x, hashed; an even
// s0, dense): then, for F <= 2, the two rows are one aligned vector of 2F
// floats and one vector atomic adds both. Each float still takes one
// fp32 add, as with two atomics.
template <int F>
__device__ __forceinline__ void add_pair(float* rows, uint32_t s0,
                                         uint32_t s1, const float (&a0)[F],
                                         const float (&a1)[F]) {
  if constexpr (F <= 2) {
    if (s1 == (s0 ^ 1u)) {
      float u[2 * F];
      const int lo = (s0 & 1u) ? F : 0;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        u[lo + f] = a0[f];
        u[F - lo + f] = a1[f];
      }
      add_row<2 * F>(rows + static_cast<int64_t>(s0 & ~1u) * F, u);
      return;
    }
  }
  add_row<F>(rows + static_cast<int64_t>(s0) * F, a0);
  add_row<F>(rows + static_cast<int64_t>(s1) * F, a1);
}

// An entry whose gradient is zero adds w * 0 = +-0 to its row, which
// leaves every sum as it is, so it is skipped, unless its weights are NaN
// (a NaN point), whose NaN the plain version's scatter-add carries. The
// padded samples of a static budget (the first sample of a ray, repeated,
// gradient masked to zero) are most of such entries.
__device__ __forceinline__ bool adds_nothing(const Cell& cl, bool zero) {
  return zero && !isnan(cl.frac[0] + cl.frac[1] + cl.frac[2]);
}

// ---- the level-group schedule ----------------------------------------------

// A thread per (point, level). The levels come in groups of G, the
// levels whose F features fill Floats of a point's row (in the forward
// one 32-byte sector: G = 4 at F = 2; one level for the runtime-F
// instance) but no more than the table's levels rounded up to a power of
// two, so no lane of a small table idles; and the group is the grid's
// slow dimension (blockIdx.y): the card finishes a group's levels for
// every point before it starts the next group's. Inside a block the level
// is the fast index: lanes G q ... G q + G - 1 take point q's G levels,
// so their stores fill the point's sector whole. lg = log2 G.
int group_shift(int f, int floats, int n_levels) {
  int lg = 0;
  while (f > 0 && (f << (lg + 1)) <= floats && (1 << lg) < n_levels) ++lg;
  return lg;
}

struct Item {
  int64_t p;    // point
  int l;        // level
  bool live;
};

__device__ __forceinline__ Item item_of(int64_t n, const Levels& lv,
                                        int lg) {
  Item it;
  it.p = static_cast<int64_t>(blockIdx.x) * (kThreads >> lg) +
         (threadIdx.x >> lg);
  it.l = static_cast<int>((blockIdx.y << lg) |
                          (threadIdx.x & ((1u << lg) - 1u)));
  it.live = it.p < n && it.l < lv.n;
  return it;
}

dim3 group_grid(int64_t n, int n_levels, int lg) {
  const int64_t points = kThreads >> lg;   // a block's
  return dim3(static_cast<unsigned>((n + points - 1) / points),
              static_cast<unsigned>((n_levels + (1 << lg) - 1) >> lg));
}

template <int F>
__device__ __forceinline__ void store_row(float* r, const float (&v)[F]) {
  if constexpr (F == 1) {
    *r = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(r) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      reinterpret_cast<float4*>(r)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// ---- forward ----------------------------------------------------------------

// F > 0: a compile-time width, rows loaded and stored as vectors. F == 0:
// lv.f features, a loop.
template <int F>
__global__ void __launch_bounds__(kThreads)
encode_forward(const float* __restrict__ table, const float* __restrict__ x,
               float* __restrict__ out, int64_t n, Levels lv, int lg) {
  const Item it = item_of(n, lv, lg);
  if (!it.live) return;
  const int nf = F > 0 ? F : lv.f;
  const int res = lv.res[it.l];
  const bool dense = (lv.dense >> it.l) & 1u;
  float xp[3];
  load_point(x, it.p, true, xp);
  const Cell cl = cell_of(xp, res);
  const float* rows = table + static_cast<int64_t>(it.l) * lv.size * nf;
  float* dst = out + it.p * (lv.n * nf) + it.l * nf;
  if constexpr (F > 0) {
    float acc[F] = {};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = x_pairs(k);
      float v[F];
      load_row<F>(rows + static_cast<int64_t>(
                             slot(cl, c, res, dense, lv.mask)) * F, v);
      const float w = weight(cl, c);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * v[f];
    }
    store_row<F>(dst, acc);
  } else {
    for (int f = 0; f < nf; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = x_pairs(k);
        acc += weight(cl, c) *
               __ldg(rows + static_cast<int64_t>(
                                slot(cl, c, res, dense, lv.mask)) * nf + f);
      }
      dst[f] = acc;
    }
  }
}

// ---- backward to the table (atomics) ----------------------------------------

template <int F>
__global__ void __launch_bounds__(kThreads)
encode_backward_atomic(const float* __restrict__ x,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad_table, int64_t n,
                       Levels lv, int lg) {
  const Item it = item_of(n, lv, lg);
  if (!it.live) return;
  const int nf = F > 0 ? F : lv.f;
  // the features' gradient of (p, l)
  const float* gp = grad_out + it.p * (lv.n * nf) + it.l * nf;
  float g[F > 0 ? F : 1];
  bool zero = true;
  if constexpr (F > 0) {
    load_row<F>(gp, g);
#pragma unroll
    for (int f = 0; f < F; ++f) zero = zero && g[f] == 0.f;
  } else {
    for (int f = 0; f < nf; ++f) zero = zero && __ldg(gp + f) == 0.f;
  }
  float xp[3];
  load_point(x, it.p, true, xp);
  // adds nothing (adds_nothing) unless the point is NaN: a cell's
  // fractions are NaN exactly where the point is
  if (zero && !(isnan(xp[0]) || isnan(xp[1]) || isnan(xp[2]))) return;
  const int res = lv.res[it.l];
  const bool dense = (lv.dense >> it.l) & 1u;
  const Cell cl = cell_of(xp, res);
  float* rows = grad_table + static_cast<int64_t>(it.l) * lv.size * nf;
  if constexpr (F > 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {       // corners q and 4 + q: x and x + 1
      const float w0 = weight(cl, q), w1 = weight(cl, 4 + q);
      float a0[F], a1[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        a0[f] = w0 * g[f];
        a1[f] = w1 * g[f];
      }
      add_pair<F>(rows, slot(cl, q, res, dense, lv.mask),
                  slot(cl, 4 + q, res, dense, lv.mask), a0, a1);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = weight(cl, c);
      float* r = rows + static_cast<int64_t>(
                            slot(cl, c, res, dense, lv.mask)) * nf;
      for (int f = 0; f < nf; ++f) atomicAdd(r + f, w * __ldg(gp + f));
    }
  }
}

// ---- the deterministic table gradient --------------------------------------

// each (point, level, corner) entry's flat row l * T + slot in entry
// order; kNoRow (sorted last, summed never) for an entry that adds nothing
constexpr int32_t kNoRow = INT32_MAX;

__global__ void __launch_bounds__(kThreads)
encode_rows(const float* __restrict__ x, const float* __restrict__ grad_out,
            int32_t* __restrict__ rows_out, int64_t n, Levels lv) {
  const int64_t total = n * lv.n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = i / lv.n;
    const int l = static_cast<int>(i - p * lv.n);
    const int res = lv.res[l];
    const bool dense = (lv.dense >> l) & 1u;
    float xp[3];
    load_point(x, p, true, xp);
    const Cell cl = cell_of(xp, res);
    bool zero = true;
    for (int f = 0; f < lv.f; ++f)
      zero = zero && __ldg(grad_out + i * lv.f + f) == 0.f;
    const bool skip = adds_nothing(cl, zero);
    const int32_t base = static_cast<int32_t>(l * lv.size);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      rows_out[8 * i + c] =
          skip ? kNoRow
               : base + static_cast<int32_t>(slot(cl, c, res, dense,
                                                  lv.mask));
  }
}

// feature f of entry e's contribution w_c * g to its row
__device__ __forceinline__ float contribution(const float* __restrict__ x,
                                              const float* __restrict__ g,
                                              const Levels& lv, int64_t e,
                                              int f) {
  const int64_t i = e >> 3;          // (point, level)
  const int64_t p = i / lv.n;
  const int l = static_cast<int>(i - p * lv.n);
  float xp[3];
  load_point(x, p, true, xp);
  const float w = weight(cell_of(xp, lv.res[l]), static_cast<int>(e & 7));
  return w * __ldg(g + i * lv.f + f);
}

// The deterministic sum, in two passes over the sorted entries, cut into
// fixed chunks of kChunk. sorted[k] is entry perm[k]'s row, rows sorted
// stably, so a run of equal rows lists its entries in point order.
// Pass 1, one thread per chunk: sums each run's piece in the chunk in
// order; a run wholly inside the chunk is written to its row, the piece
// of a run that began in an earlier chunk goes to head[chunk] and the
// piece of a run that goes on past the chunk to tail[chunk]. Pass 2, one
// thread per chunk whose tail piece starts a run: adds the heads of the
// chunks the run goes on into, in chunk order, and writes the row. Every
// sum is taken in one fixed order, so the result is the same on every
// run, and no thread walks more than kChunk entries or (run length /
// kChunk) pieces. Rows, heads and tails hold F floats; each feature is
// summed in the same order.
constexpr int64_t kChunk = 32;

// a run's piece of features f0 .. f0 + nb to its row, head or tail
__device__ __forceinline__ void run_piece(int32_t row, const float* acc,
                                          int nf, int f0, int nb, int64_t s,
                                          int64_t e,
                                          const int32_t* __restrict__ sorted,
                                          int64_t entries, int64_t chunk,
                                          float* __restrict__ table,
                                          float* __restrict__ head,
                                          float* __restrict__ tail) {
  const bool starts = s == 0 || sorted[s - 1] != row;
  const bool ends = e == entries || sorted[e] != row;
  float* dst = starts && ends ? table + static_cast<int64_t>(row) * nf
               : !starts      ? head + chunk * nf  // also a spanning piece
                              : tail + chunk * nf;
  for (int f = 0; f < nb; ++f) dst[f0 + f] = acc[f];
}

constexpr int kRunFeatures = 8;   // features summed per walk of a chunk

__global__ void __launch_bounds__(kThreads)
encode_run_pieces(const float* __restrict__ x,
                  const float* __restrict__ grad_out,
                  const int32_t* __restrict__ sorted,
                  const int64_t* __restrict__ perm, int64_t entries,
                  float* __restrict__ grad_table, float* __restrict__ head,
                  float* __restrict__ tail, Levels lv) {
  const int64_t chunks = (entries + kChunk - 1) / kChunk;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x; t < chunks;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t begin = t * kChunk;
    const int64_t end = min(begin + kChunk, entries);
    // the features in blocks of kRunFeatures, one walk of the chunk each
    for (int f0 = 0; f0 < lv.f; f0 += kRunFeatures) {
      const int nb = min(kRunFeatures, lv.f - f0);
      float acc[kRunFeatures] = {};
      int32_t row = sorted[begin];
      int64_t s = begin;
      for (int64_t k = begin; k < end && row != kNoRow; ++k) {
        const int32_t r = sorted[k];
        if (r != row) {
          run_piece(row, acc, lv.f, f0, nb, s, k, sorted, entries, t,
                    grad_table, head, tail);
          row = r;
          s = k;
          for (int f = 0; f < kRunFeatures; ++f) acc[f] = 0.f;
          if (r == kNoRow) break;
        }
        for (int f = 0; f < nb; ++f)
          acc[f] += contribution(x, grad_out, lv, perm[k], f0 + f);
      }
      if (row != kNoRow)
        run_piece(row, acc, lv.f, f0, nb, s, end, sorted, entries, t,
                  grad_table, head, tail);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
encode_run_join(const int32_t* __restrict__ sorted, int64_t entries,
                float* __restrict__ grad_table,
                const float* __restrict__ head,
                const float* __restrict__ tail, int nf) {
  const int64_t chunks = (entries + kChunk - 1) / kChunk;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x; t < chunks;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t end = min((t + 1) * kChunk, entries);
    const int32_t row = sorted[end - 1];
    if (row == kNoRow || end == entries || sorted[end] != row) continue;
    // the chunk's last run goes on; it starts here unless it also fills
    // the chunk from a run begun before it
    const int64_t begin = t * kChunk;
    if (sorted[begin] == row && begin > 0 && sorted[begin - 1] == row)
      continue;
    for (int f = 0; f < nf; ++f) {
      float acc = tail[t * nf + f];
      for (int64_t u = t + 1; u < chunks; ++u) {
        acc += head[u * nf + f];
        const int64_t e = min((u + 1) * kChunk, entries);
        if (e == entries || sorted[e] != row) break;
      }
      grad_table[static_cast<int64_t>(row) * nf + f] = acc;
    }
  }
}

// ---- backward to the points -------------------------------------------------

// dw_c / dfrac_a . dot for a corner c, added to d: the other two axes'
// weights, signed by the corner's offset on axis a
__device__ __forceinline__ void add_slope(const Cell& cl, int c, float dot,
                                          float (&d)[3]) {
  float w[3];
  axis_weights(cl, c, w);
  const float s0 = (c >> 2) & 1 ? dot : -dot;
  const float s1 = (c >> 1) & 1 ? dot : -dot;
  const float s2 = c & 1 ? dot : -dot;
  d[0] += s0 * (w[1] * w[2]);
  d[1] += s1 * (w[0] * w[2]);
  d[2] += s2 * (w[0] * w[1]);
}

// kPointLanes lanes a point, lane j summing levels j, j + kPointLanes, ...
// in order; the lanes' sums then meet by xor shuffles (one fixed order,
// the same sum on every lane), and the sum is multiplied by JAX's clip
// derivative. Each point owns its gradient: deterministic.
constexpr int kPointLanes = 4;

template <int F>
__global__ void __launch_bounds__(kThreads)
encode_backward_points(const float* __restrict__ table,
                       const float* __restrict__ x,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad_x, int64_t n, Levels lv) {
  const int j = threadIdx.x % kPointLanes;
  const int64_t p = static_cast<int64_t>(blockIdx.x) *
                        (kThreads / kPointLanes) +
                    threadIdx.x / kPointLanes;
  const bool live = p < n;
  const int nf = F > 0 ? F : lv.f;
  float xp[3];
  load_point(x, p, live, xp);
  float gx[3] = {0.f, 0.f, 0.f};
  for (int l = j; live && l < lv.n; l += kPointLanes) {
    const int res = lv.res[l];
    const bool dense = (lv.dense >> l) & 1u;
    const Cell cl = cell_of(xp, res);
    const float* rows = table + static_cast<int64_t>(l) * lv.size * nf;
    const float* gp = grad_out + p * (lv.n * nf) + l * nf;
    float d[3] = {0.f, 0.f, 0.f};
    if constexpr (F > 0) {
      float g[F];
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = __ldg(gp + f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = x_pairs(k);
        float v[F];
        load_row<F>(rows + static_cast<int64_t>(
                               slot(cl, c, res, dense, lv.mask)) * F, v);
        float dot = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) dot += v[f] * g[f];
        add_slope(cl, c, dot, d);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float* r = rows + static_cast<int64_t>(
                                    slot(cl, c, res, dense, lv.mask)) * nf;
        float dot = 0.f;
        for (int f = 0; f < nf; ++f) dot += __ldg(r + f) * __ldg(gp + f);
        add_slope(cl, c, dot, d);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) gx[a] += static_cast<float>(res) * d[a];
  }
#pragma unroll
  for (int m = 1; m < kPointLanes; m <<= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      gx[a] += __shfl_xor_sync(0xffffffffu, gx[a], m);
  }
  if (j == 0 && live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = xp[a];
      const float clip_d = (v > 0.f && v < 1.f) ? 1.f
                           : (v == 0.f || v == 1.f) ? 0.5f : 0.f;
      grad_x[3 * p + a] = gx[a] * clip_d;
    }
  }
}

// ---- host side --------------------------------------------------------------

Levels make_levels(const int* res, int n_levels, int64_t table_size,
                   int n_features) {
  Levels lv{};
  lv.n = n_levels;
  lv.f = n_features;
  lv.size = table_size;
  lv.mask = static_cast<uint32_t>(table_size - 1);
  for (int l = 0; l < n_levels; ++l) {
    lv.res[l] = res[l];
    const int64_t side = static_cast<int64_t>(res[l]) + 1;
    if (side * side * side <= table_size) lv.dense |= uint64_t{1} << l;
  }
  return lv;
}

constexpr int64_t kMaxBlocks = 1 << 20;   // grid-stride past this

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// the wrapper checks these first; a second line of defence for the C API
bool valid(int n_levels, int n_features, int64_t table_size) {
  return n_features >= 1 && n_levels >= 1 && n_levels <= kMaxLevels &&
         table_size > 0 && (table_size & (table_size - 1)) == 0 &&
         n_levels * table_size <= INT32_MAX;
}

// F's template instance: 1, 2, 4, 8 compiled, 0 for any other width
#define HASH_ENCODE_DISPATCH(nf, CALL) \
  switch (nf) {                        \
    case 1: { CALL(1); break; }        \
    case 2: { CALL(2); break; }        \
    case 4: { CALL(4); break; }        \
    case 8: { CALL(8); break; }        \
    default: { CALL(0); break; }       \
  }

}  // namespace

extern "C" {

int hash_encode_forward(const float* table, const float* x, float* out,
                        long long n, const int* res, int n_levels,
                        long long table_size, int n_features,
                        cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size, n_features);
#define LAUNCH(K)                                                       \
  {                                                                     \
    const int lg = group_shift(K, kForwardFloats, n_levels);            \
    encode_forward<K><<<group_grid(n, n_levels, lg), kThreads, 0,        \
                        stream>>>(table, x, out, n, lv, lg);            \
  }
  HASH_ENCODE_DISPATCH(n_features, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_backward_atomic(const float* x, const float* grad_out,
                                float* grad_table, long long n,
                                const int* res, int n_levels,
                                long long table_size, int n_features,
                                cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size, n_features);
#define LAUNCH(K)                                                       \
  {                                                                     \
    const int lg = group_shift(K, kBackwardFloats, n_levels);           \
    encode_backward_atomic<K><<<group_grid(n, n_levels, lg), kThreads,   \
                                0, stream>>>(x, grad_out, grad_table, n, \
                                             lv, lg);                    \
  }
  HASH_ENCODE_DISPATCH(n_features, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_rows(const float* x, const float* grad_out, int* rows,
                     long long n, const int* res, int n_levels,
                     long long table_size, int n_features,
                     cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size, n_features);
  encode_rows<<<blocks_for(n * n_levels), kThreads, 0, stream>>>(
      x, grad_out, rows, n, lv);
  return static_cast<int>(cudaGetLastError());
}

// scratch: head and tail, F floats each, one per chunk of
// hash_encode_run_chunk() sorted entries
long long hash_encode_run_chunk() { return kChunk; }

int hash_encode_run_pieces(const float* x, const float* grad_out,
                           const int* sorted_rows, const long long* perm,
                           long long entries, float* grad_table,
                           float* head, float* tail, const int* res,
                           int n_levels, long long table_size,
                           int n_features, cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size, n_features);
  const int64_t chunks = (entries + kChunk - 1) / kChunk;
  encode_run_pieces<<<blocks_for(chunks), kThreads, 0, stream>>>(
      x, grad_out, sorted_rows, reinterpret_cast<const int64_t*>(perm),
      entries, grad_table, head, tail, lv);
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_run_join(const int* sorted_rows, long long entries,
                         float* grad_table, const float* head,
                         const float* tail, int n_features,
                         cudaStream_t stream) {
  if (n_features < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (entries + kChunk - 1) / kChunk;
  encode_run_join<<<blocks_for(chunks), kThreads, 0, stream>>>(
      sorted_rows, entries, grad_table, head, tail, n_features);
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_backward_points(const float* table, const float* x,
                                const float* grad_out, float* grad_x,
                                long long n, const int* res, int n_levels,
                                long long table_size, int n_features,
                                cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size, n_features);
#define LAUNCH(K)                                                        \
  encode_backward_points<K><<<static_cast<unsigned>(                     \
      (n + kThreads / kPointLanes - 1) / (kThreads / kPointLanes)),        \
                              kThreads, 0, stream>>>(table, x, grad_out, \
                                                     grad_x, n, lv)
  HASH_ENCODE_DISPATCH(n_features, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* hash_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
