// Multi-resolution hash-grid encode (Instant-NGP) for Hopper (sm_90a):
// forward, the table's gradient (fp32 atomics, or a deterministic run sum
// over rows sorted by the caller) and the points' gradient.
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
// What bounds it: bytes. Per point 12 B of x in and L * F * 4 = 128 B of
// features out, plus each touched table row once (chip_smoke.encode_bound);
// the ~1 kFLOP per point is < 1% of that at the fp32 rate. The design is
// the simple one: one thread per (point, level), p-major, so the x reads
// of a point's levels are one broadcast and the float2 feature stores of
// consecutive threads are contiguous; each thread gathers its 8 corners
// as float2 loads through the read-only path. The gathers are the
// traffic that exceeds the bound: 8 random 8-byte rows per (point,
// level), each a 32-byte sector. The coarse dense levels (17^3 ... 55^3
// rows, under 1.4 MB each) stay in the 50 MB L2; the 12 hashed levels
// (4 MB each at 2^19 rows) mostly do too when the points are spatially
// coherent, as a ray's samples are. No shared memory, one launch per
// call.
//
// Backward to the table: the same thread recomputes its corners and
// weights (nothing per (point, level) is saved) and adds w * g to each
// corner's row with one float2 atomicAdd (native on sm_90). Duplicate
// rows are the rule at the coarse levels (a 16^3 level takes 8 adds per
// point into at most 4,913 rows); the L2 resolves the atomics. A (point,
// level) whose gradient is zero is skipped: a training call's padded
// samples repeat one point per ray and would otherwise pile thousands of
// atomics onto the same rows. The sum's order varies from run to run, so
// under deterministic algorithms the wrapper instead takes
// hash_encode_rows (each entry's flat row), sorts them stably
// (torch.sort: point order within a row), and sums each run of equal
// rows in that order in fixed chunks (hash_encode_run_pieces, then
// hash_encode_run_join for the runs that cross a chunk).
//
// Backward to the points: one thread per point walks the levels in order
// and sums res * sum_c dw_c / dfrac . <row_c, g>, then multiplies by JAX's
// clip derivative (1 inside (0, 1), 0.5 at exactly 0 or 1, 0 outside).
// Each point owns its gradient: deterministic.
//
// Plain C interface, loaded with ctypes: each entry point launches one
// kernel on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;   // grid-stride past this

struct Levels {
  int res[kMaxLevels];
  uint32_t dense;     // bit l: level l is indexed densely
  uint32_t mask;      // T - 1
  int n;              // levels
  int64_t size;       // T
};

struct Cell {
  uint32_t c[3][2];   // per axis: corner coordinate at offset 0 and 1
  float frac[3];
};

// jnp.clip(x, 0, 1) as min(max(x, 0), 1); a NaN stays NaN
__device__ __forceinline__ float clip01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

__device__ __forceinline__ Cell cell_of(const float* __restrict__ xp,
                                        int res) {
  Cell cl;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(clip01(__ldg(xp + a)),
                                static_cast<float>(res));
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

__device__ __forceinline__ const float2* level_rows(const float* t,
                                                   const Levels& lv,
                                                   int l) {
  return reinterpret_cast<const float2*>(t) + static_cast<int64_t>(l) *
         lv.size;
}

__device__ __forceinline__ void add_row(float2* row, float2 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(row, v);   // one vector atomic, sm_90
#else
  atomicAdd(&row->x, v.x);
  atomicAdd(&row->y, v.y);
#endif
}

// F = 2 features per row, read and written as float2; other widths are a
// template argument with their own vector type, not compiled in here.
template <int F>
__global__ void __launch_bounds__(kThreads)
encode_forward(const float* __restrict__ table, const float* __restrict__ x,
               float* __restrict__ out, int64_t n, Levels lv) {
  static_assert(F == 2, "rows are float2");
  const int64_t total = n * lv.n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = i / lv.n;
    const int l = static_cast<int>(i - p * lv.n);
    const int res = lv.res[l];
    const bool dense = (lv.dense >> l) & 1u;
    const Cell cl = cell_of(x + 3 * p, res);
    const float2* rows = level_rows(table, lv, l);
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 v = __ldg(rows + slot(cl, c, res, dense, lv.mask));
      const float w = weight(cl, c);
      acc.x += w * v.x;
      acc.y += w * v.y;
    }
    reinterpret_cast<float2*>(out)[i] = acc;
  }
}

// An entry whose gradient is zero adds w * 0 = +-0 to its row, which
// leaves every sum as it is, so it is skipped, unless its weights are NaN
// (a NaN point), whose NaN the plain version's scatter-add carries. The
// padded samples of a static budget (the first sample of a ray, repeated,
// gradient masked to zero) are most of such entries.
__device__ __forceinline__ bool adds_nothing(const Cell& cl, float2 g) {
  return g.x == 0.f && g.y == 0.f &&
         !isnan(cl.frac[0] + cl.frac[1] + cl.frac[2]);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
encode_backward_atomic(const float* __restrict__ x,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad_table, int64_t n,
                       Levels lv) {
  static_assert(F == 2, "rows are float2");
  const int64_t total = n * lv.n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = i / lv.n;
    const int l = static_cast<int>(i - p * lv.n);
    const int res = lv.res[l];
    const bool dense = (lv.dense >> l) & 1u;
    const Cell cl = cell_of(x + 3 * p, res);
    const float2 g = __ldg(reinterpret_cast<const float2*>(grad_out) + i);
    if (adds_nothing(cl, g)) continue;
    float2* rows = const_cast<float2*>(level_rows(grad_table, lv, l));
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = weight(cl, c);
      add_row(rows + slot(cl, c, res, dense, lv.mask),
              make_float2(w * g.x, w * g.y));
    }
  }
}

// each (point, level, corner) entry's flat row l * T + slot in entry
// order; kNoRow (sorted last, summed never) for an entry that adds nothing
constexpr int32_t kNoRow = INT32_MAX;

template <int F>
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
    const Cell cl = cell_of(x + 3 * p, res);
    const float2 g = __ldg(reinterpret_cast<const float2*>(grad_out) + i);
    const bool skip = adds_nothing(cl, g);
    const int32_t base = static_cast<int32_t>(l * lv.size);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      rows_out[8 * i + c] =
          skip ? kNoRow
               : base + static_cast<int32_t>(slot(cl, c, res, dense,
                                                  lv.mask));
  }
}

// entry e's contribution w_c * g to its row
__device__ __forceinline__ float2 contribution(const float* __restrict__ x,
                                               const float* __restrict__ g,
                                               const Levels& lv,
                                               int64_t e) {
  const int64_t i = e >> 3;          // (point, level)
  const int64_t p = i / lv.n;
  const int l = static_cast<int>(i - p * lv.n);
  const float w = weight(cell_of(x + 3 * p, lv.res[l]),
                         static_cast<int>(e & 7));
  const float2 gv = __ldg(reinterpret_cast<const float2*>(g) + i);
  return make_float2(w * gv.x, w * gv.y);
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
// kChunk) pieces.
constexpr int64_t kChunk = 32;

__device__ __forceinline__ void run_piece(int32_t row, float2 acc,
                                          int64_t s, int64_t e,
                                          const int32_t* __restrict__ sorted,
                                          int64_t entries, int64_t chunk,
                                          float2* __restrict__ table,
                                          float2* __restrict__ head,
                                          float2* __restrict__ tail) {
  const bool starts = s == 0 || sorted[s - 1] != row;
  const bool ends = e == entries || sorted[e] != row;
  if (starts && ends) table[row] = acc;
  else if (!starts) head[chunk] = acc;   // also a piece spanning the chunk
  else tail[chunk] = acc;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
encode_run_pieces(const float* __restrict__ x,
                  const float* __restrict__ grad_out,
                  const int32_t* __restrict__ sorted,
                  const int64_t* __restrict__ perm, int64_t entries,
                  float* __restrict__ grad_table, float2* __restrict__ head,
                  float2* __restrict__ tail, Levels lv) {
  static_assert(F == 2, "rows are float2");
  float2* table = reinterpret_cast<float2*>(grad_table);
  const int64_t chunks = (entries + kChunk - 1) / kChunk;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x; t < chunks;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t begin = t * kChunk;
    const int64_t end = min(begin + kChunk, entries);
    int32_t row = sorted[begin];
    int64_t s = begin;
    float2 acc = make_float2(0.f, 0.f);
    for (int64_t k = begin; k < end && row != kNoRow; ++k) {
      const int32_t r = sorted[k];
      if (r != row) {
        run_piece(row, acc, s, k, sorted, entries, t, table, head, tail);
        row = r;
        s = k;
        acc = make_float2(0.f, 0.f);
        if (r == kNoRow) break;
      }
      const float2 c = contribution(x, grad_out, lv, perm[k]);
      acc.x += c.x;
      acc.y += c.y;
    }
    if (row != kNoRow)
      run_piece(row, acc, s, end, sorted, entries, t, table, head, tail);
  }
}

__global__ void __launch_bounds__(kThreads)
encode_run_join(const int32_t* __restrict__ sorted, int64_t entries,
                float* __restrict__ grad_table,
                const float2* __restrict__ head,
                const float2* __restrict__ tail) {
  float2* table = reinterpret_cast<float2*>(grad_table);
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
    float2 acc = tail[t];
    for (int64_t u = t + 1; u < chunks; ++u) {
      const float2 h = head[u];
      acc.x += h.x;
      acc.y += h.y;
      const int64_t e = min((u + 1) * kChunk, entries);
      if (e == entries || sorted[e] != row) break;
    }
    table[row] = acc;
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
encode_backward_points(const float* __restrict__ table,
                       const float* __restrict__ x,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad_x, int64_t n, Levels lv) {
  static_assert(F == 2, "rows are float2");
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x; p < n;
       p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float gx[3] = {0.f, 0.f, 0.f};
    for (int l = 0; l < lv.n; ++l) {
      const int res = lv.res[l];
      const bool dense = (lv.dense >> l) & 1u;
      const Cell cl = cell_of(x + 3 * p, res);
      const float2 g = __ldg(reinterpret_cast<const float2*>(grad_out) +
                             p * lv.n + l);
      const float2* rows = level_rows(table, lv, l);
      float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 v = __ldg(rows + slot(cl, c, res, dense, lv.mask));
        const float dot = v.x * g.x + v.y * g.y;
        float w[3];
        axis_weights(cl, c, w);
        // dw_c / dfrac_a: the other two axes' weights, signed by the
        // corner's offset on axis a
        const float s0 = (c >> 2) & 1 ? dot : -dot;
        const float s1 = (c >> 1) & 1 ? dot : -dot;
        const float s2 = c & 1 ? dot : -dot;
        d[0] += s0 * (w[1] * w[2]);
        d[1] += s1 * (w[0] * w[2]);
        d[2] += s2 * (w[0] * w[1]);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) gx[a] += static_cast<float>(res) * d[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = __ldg(x + 3 * p + a);
      const float clip_d = (v > 0.f && v < 1.f) ? 1.f
                           : (v == 0.f || v == 1.f) ? 0.5f : 0.f;
      grad_x[3 * p + a] = gx[a] * clip_d;
    }
  }
}

Levels make_levels(const int* res, int n_levels, int64_t table_size) {
  Levels lv{};
  lv.n = n_levels;
  lv.size = table_size;
  lv.mask = static_cast<uint32_t>(table_size - 1);
  for (int l = 0; l < n_levels; ++l) {
    lv.res[l] = res[l];
    const int64_t side = static_cast<int64_t>(res[l]) + 1;
    if (side * side * side <= table_size) lv.dense |= 1u << l;
  }
  return lv;
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// the wrapper checks these first; a second line of defence for the C API
bool valid(int n_levels, int n_features, int64_t table_size) {
  return n_features == 2 && n_levels >= 1 && n_levels <= kMaxLevels &&
         table_size > 0 && (table_size & (table_size - 1)) == 0 &&
         n_levels * table_size <= INT32_MAX;
}

}  // namespace

extern "C" {

int hash_encode_forward(const float* table, const float* x, float* out,
                        long long n, const int* res, int n_levels,
                        long long table_size, int n_features,
                        cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size);
  encode_forward<2><<<blocks_for(n * n_levels), kThreads, 0, stream>>>(
      table, x, out, n, lv);
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_backward_atomic(const float* x, const float* grad_out,
                                float* grad_table, long long n,
                                const int* res, int n_levels,
                                long long table_size, int n_features,
                                cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size);
  encode_backward_atomic<2><<<blocks_for(n * n_levels), kThreads, 0,
                              stream>>>(x, grad_out, grad_table, n, lv);
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_rows(const float* x, const float* grad_out, int* rows,
                     long long n, const int* res, int n_levels,
                     long long table_size, int n_features,
                     cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size);
  encode_rows<2><<<blocks_for(n * n_levels), kThreads, 0, stream>>>(
      x, grad_out, rows, n, lv);
  return static_cast<int>(cudaGetLastError());
}

// scratch: head and tail, float2 each, one per chunk of
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
  const Levels lv = make_levels(res, n_levels, table_size);
  const int64_t chunks = (entries + kChunk - 1) / kChunk;
  encode_run_pieces<2><<<blocks_for(chunks), kThreads, 0, stream>>>(
      x, grad_out, sorted_rows, reinterpret_cast<const int64_t*>(perm),
      entries, grad_table, reinterpret_cast<float2*>(head),
      reinterpret_cast<float2*>(tail), lv);
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_run_join(const int* sorted_rows, long long entries,
                         float* grad_table, const float* head,
                         const float* tail, cudaStream_t stream) {
  const int64_t chunks = (entries + kChunk - 1) / kChunk;
  encode_run_join<<<blocks_for(chunks), kThreads, 0, stream>>>(
      sorted_rows, entries, grad_table,
      reinterpret_cast<const float2*>(head),
      reinterpret_cast<const float2*>(tail));
  return static_cast<int>(cudaGetLastError());
}

int hash_encode_backward_points(const float* table, const float* x,
                                const float* grad_out, float* grad_x,
                                long long n, const int* res, int n_levels,
                                long long table_size, int n_features,
                                cudaStream_t stream) {
  if (!valid(n_levels, n_features, table_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv = make_levels(res, n_levels, table_size);
  encode_backward_points<2><<<blocks_for(n), kThreads, 0, stream>>>(
      table, x, grad_out, grad_x, n, lv);
  return static_cast<int>(cudaGetLastError());
}

const char* hash_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
