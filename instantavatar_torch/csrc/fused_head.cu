// Fused canonical-field head for Hopper (sm_90a): sigma MLP E -> 64 -> 16
// (sigma = geo[0]) and colour MLP geo[1:16] 15 -> 64 -> 64 -> 3 (ReLU,
// ReLU, sigmoid) in one kernel, forward only, on the tensor cores.
//
// Replaces the Pallas TPU kernel instantavatar_tpu/ops/fused_head.py
// (fused_field_head, body _kernel). Same numerical contract: bf16
// operands, fp32 accumulation, each hidden bias added in fp32 BEFORE the
// ReLU and the bf16 cast, output layers kept in fp32. The input is taken
// as bf16 directly (the TPU kernel's f32 -> bf16 round trip is lossless
// for the bf16 features the field encodes). Ragged row counts are handled
// in-kernel; the caller's tensors are never padded.
//
// What bounds it: per row 112 B in (E = 56 bf16) and 16 B out against
// 9,856 MACs (19.7 kFLOP), 154 FLOP/B, under the H100's bf16 ridge of
// ~295 FLOP/B, so the bound is device-memory traffic (57 us at 1.5M rows,
// 3.35 TB/s), provided the MACs run on the tensor cores and the hidden
// activations never leave the SM. The design:
//  - all five layers are mma.sync bf16 -> fp32 (m16n8k16; the first
//    layer's K = 56 ends with one m16n8k8), padded to the instruction's
//    shape in shared memory only: the colour input to K = 16 (a zero
//    weight row in front, so the whole geo fragment feeds it and sigma's
//    column multiplies zero), the last layer's N 3 -> 8 (zero columns):
//    10,240 MACs per row issued for 9,856 real;
//  - layers are chained in registers: the fp32 accumulators of two
//    adjacent n8 tiles are, element for element, one k16 A fragment of
//    the next product. The bias enters as the C operand of each layer's
//    first mma; ReLU and rounding are one cvt.rn.relu.bf16x2.f32, whose
//    result is the next layer's A operand, so the (M, 64) activations
//    never touch shared or device memory. Sigma is read from the fp32 geo
//    accumulator before the cast;
//  - weights are staged once per persistent block into shared memory as
//    bf16 (21 KB padded), permuted into the per-lane B-fragment order so
//    that one conflict-free LDS.128 yields the fragments of two n8 tiles;
//    a warp tile of 32 rows (two m16 tiles) makes each such load feed 4
//    mma instructions;
//  - a persistent grid (SMs x resident blocks, from the occupancy API) in
//    which every warp walks its own 32-row tiles with a grid stride and
//    keeps a 3-stage ring of input tiles in shared memory, filled with
//    16-byte cp.async.cg copies (7 per 112-byte row, coalesced). The row
//    pitch is padded to 128 B (the 8th chunk is never read) and XOR-
//    swizzled, so ldmatrix reads without bank conflicts; rows past M are
//    zero-filled through the cp.async src-size operand;
//  - colour (12 B per row) and sigma (4 B per row) are staged per warp in
//    shared memory and stored as contiguous runs.
// Measured on an H100 it reaches about half of the byte bound; the layers
// alone (no input loads) take most of its time, so what holds it now is
// instruction issue (mma.sync and the epilogues at 12 warps per SM), not
// bytes (tools/head_kernel_anatomy.py; wgmma is the next step).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHs = 64;            // sigma hidden width
constexpr int kGeo = 16;           // geo features; sigma = geo[0]
constexpr int kHc = 64;            // colour hidden width
constexpr int kOut = 3;            // colour channels
constexpr int kOutPad = 8;         // last layer's N, padded to one n8 tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;      // resident blocks per SM (smem-limited)
constexpr int kTileRows = 32;      // rows per warp tile: two m16 tiles
constexpr int kStages = 3;         // input ring depth per warp
constexpr int kPitch = 128;        // bytes per staged row: 8 16-byte chunks
constexpr int kSlotBytes = kTileRows * kPitch;
constexpr int kMaxDevices = 64;

// padded K x N weights, in bf16 elements
constexpr int kW0 = 64 * kHs;            // sigma layer 0 (K = E padded)
constexpr int kW1 = kHs * kGeo;          // sigma layer 1
constexpr int kC0 = kGeo * kHc;          // colour layer 0 (zero row 0)
constexpr int kC1 = kHc * kHc;           // colour layer 1
constexpr int kC2 = kHc * kOutPad;       // colour layer 2
constexpr int kWElems = kW0 + kW1 + kC0 + kC1 + kC2;
// fp32 biases: b0 | b1 | cb0 | cb1 | cb2 padded to 8
constexpr int kB0 = 0, kB1 = kB0 + kHs, kCB0 = kB1 + kGeo,
              kCB1 = kCB0 + kHc, kCB2 = kCB1 + kHc,
              kBiasFloats = kCB2 + kOutPad;
constexpr int kOutFloats = kTileRows * (kOut + 1);   // colour run + sigma

// dynamic shared memory layout, bytes
constexpr int kRingOff = 0;
constexpr int kWOff = kRingOff + kWarps * kStages * kSlotBytes;
constexpr int kBiasOff = kWOff + kWElems * 2;
constexpr int kOutOff = kBiasOff + kBiasFloats * 4;
constexpr int kSmemBytes = kOutOff + kWarps * kOutFloats * 4;
static_assert(kWOff % 16 == 0 && kBiasOff % 16 == 0 && kOutOff % 16 == 0,
              "16-byte aligned sections");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) * b (8x8, col): a k8 step, for a K that ends half way
// into a k16 step (a0, a1 are the k16 A fragment's first half, b0 its b0)
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d = a * b + c: the first k16 step of a layer, c = the bias (read where
// it lies, so no register copies seed the accumulators)
__device__ __forceinline__ void mma_c(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1, float2 c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%10,%11};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c.x), "f"(c.y));
}

// two fp32 -> one bf16x2 word, round to nearest even, optionally through
// a ReLU in the same instruction; lo in the low half
template <bool kRelu>
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  if (kRelu)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Position, in bf16 elements, of element (k, n) of a padded K x N weight in
// per-lane B-fragment order. For each k16 step and each group of G n8
// tiles, lane l = 4 * (n % 8) + (k % 8) / 2 holds 2G consecutive words:
// (b0, b1) of each tile of the group, b0 for k % 16 < 8, the even k in the
// low half. One 8G-byte load per lane then yields a whole group.
template <int N, int G>
__device__ __forceinline__ int frag_pos(int k, int n) {
  const int kt = k >> 4, nt = n >> 3;
  const int lane = (n & 7) * 4 + ((k & 7) >> 1);
  const int word = ((kt * (N / 8 / G) + nt / G) * 32 + lane) * (2 * G) +
                   (nt % G) * 2 + ((k >> 3) & 1);
  return word * 2 + (k & 1);
}

// Rows [k0, k0 + rows) of a padded weight with N columns from a row-major
// (rows, N) bf16 tensor, read as 16-byte vectors, scattered into fragment
// order (the padding was zeroed before).
template <int N, int G>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int rows,
    int k0) {
  constexpr int kVec = N / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int k = k0 + i / kVec, n0 = (i % kVec) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[frag_pos<N, G>(k, n0 + j)] = __ushort_as_bfloat16(
          static_cast<unsigned short>(w[j >> 1] >> (16 * (j & 1))));
  }
}

// The fp32 bias of the lane's two columns of n8 tile nt.
__device__ __forceinline__ float2 bias2(const float* bias, int nt, int lane) {
  return *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * (lane & 3));
}

// acc = bias + a x W for a 32-row warp tile; W (KT*16 x NT*8) in fragment
// order with G = 2, so each LDS.128 feeds four mma. With kHalfLast the
// real K ends half way into the last k16 step, which is then a k8 mma.
template <int KT, int NT, bool kHalfLast = false>
__device__ __forceinline__ void layer(float (&acc)[2][NT][4],
                                      const uint32_t (&a)[2][KT][4],
                                      const uint4* __restrict__ w,
                                      const float* bias, int lane) {
  static_assert(KT > 1 || !kHalfLast, "the k8 step follows a k16 step");
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const uint4 b = w[(kt * (NT / 2) + np) * 32 + lane];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (kt == 0) {
          mma_c(acc[m][2 * np], a[m][0], b.x, b.y, bias2(bias, 2 * np, lane));
          mma_c(acc[m][2 * np + 1], a[m][0], b.z, b.w,
                bias2(bias, 2 * np + 1, lane));
        } else if (kHalfLast && kt == KT - 1) {
          mma_k8(acc[m][2 * np], a[m][kt][0], a[m][kt][1], b.x);
          mma_k8(acc[m][2 * np + 1], a[m][kt][0], a[m][kt][1], b.z);
        } else {
          mma(acc[m][2 * np], a[m][kt], b.x, b.y);
          mma(acc[m][2 * np + 1], a[m][kt], b.z, b.w);
        }
      }
    }
  }
}

// fp32 accumulators of 2*KT n8 tiles -> bf16 A fragments of KT k16 steps
// (optionally through a ReLU): the next layer's operand, in registers.
template <int KT, bool kRelu>
__device__ __forceinline__ void to_a(uint32_t (&a)[2][KT][4],
                                     const float (&c)[2][2 * KT][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float(&v)[4] = c[m][2 * kt + h];
        a[m][kt][2 * h] = pack_bf16<kRelu>(v[0], v[1]);       // row g
        a[m][kt][2 * h + 1] = pack_bf16<kRelu>(v[2], v[3]);   // row g + 8
      }
    }
  }
}

// fast exp and divide: within ~3e-7 of the correctly rounded sigmoid for
// the colour logits' range
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

template <int E>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  static_assert(E % 8 == 0 && E <= 64, "rows are 16-byte chunks, K <= 64");
  constexpr int kChunks = E / 8;           // 16-byte chunks per input row
  constexpr int kKT0 = (E + 15) / 16;      // k16 steps of the first layer
  constexpr bool kHalfLast = E % 16 == 8;  // ... the last of them a k8 step
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // -- weights and biases, once per block ----------------------------------
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + kWOff);
  float* s_bias = reinterpret_cast<float*>(smem + kBiasOff);
  for (int i = threadIdx.x; i < kWElems / 8; i += kThreads)
    reinterpret_cast<uint4*>(s_w)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  stage_rows<kHs, 2>(s_w, w0, E, 0);                      // rows E..63 zero
  stage_rows<kGeo, 2>(s_w + kW0, w1, kHs, 0);
  stage_rows<kHc, 2>(s_w + kW0 + kW1, cw0, kGeo - 1, 1);  // row 0 zero
  stage_rows<kHc, 2>(s_w + kW0 + kW1 + kC0, cw1, kHc, 0);
  for (int i = threadIdx.x; i < kHc * kOut; i += kThreads)   // cols 3..7 zero
    s_w[kW0 + kW1 + kC0 + kC1 + frag_pos<kOutPad, 1>(i / kOut, i % kOut)] =
        cw2[i];
  for (int i = threadIdx.x; i < kBiasFloats; i += kThreads) {
    float v;
    if (i < kB1) v = b0[i - kB0];
    else if (i < kCB0) v = b1[i - kB1];
    else if (i < kCB1) v = cb0[i - kCB0];
    else if (i < kCB2) v = cb1[i - kCB1];
    else v = i - kCB2 < kOut ? cb2[i - kCB2] : 0.f;
    s_bias[i] = v;
  }
  const uint4* f_w0 = reinterpret_cast<const uint4*>(s_w);
  const uint4* f_w1 = reinterpret_cast<const uint4*>(s_w + kW0);
  const uint4* f_c0 = reinterpret_cast<const uint4*>(s_w + kW0 + kW1);
  const uint4* f_c1 = reinterpret_cast<const uint4*>(s_w + kW0 + kW1 + kC0);
  const uint2* f_c2 =
      reinterpret_cast<const uint2*>(s_w + kW0 + kW1 + kC0 + kC1);

  unsigned char* ring = smem + kRingOff + warp * kStages * kSlotBytes;
  float* s_out = reinterpret_cast<float*>(smem + kOutOff) + warp * kOutFloats;
  __syncthreads();

  const int ntiles = (M + kTileRows - 1) / kTileRows;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  const int mine = first < ntiles ? (ntiles - 1 - first) / stride + 1 : 0;
  const uint32_t ring_u32 = smem_u32(ring);
  const char* enc_bytes = reinterpret_cast<const char*>(enc);

  // one warp tile of rows [row0, row0 + 32) into ring slot `slot`
  auto load_tile = [&](int tile, int slot) {
    const int row0 = tile * kTileRows;
    const char* base = enc_bytes + (size_t)row0 * (E * 2);
    const uint32_t dst = ring_u32 + slot * kSlotBytes;
#pragma unroll
    for (int j = 0; j < (kTileRows * kChunks + 31) / 32; ++j) {
      const int i = lane + 32 * j;        // chunk i of the contiguous tile
      if (i >= kTileRows * kChunks) break;
      const int r = i / kChunks, c = i - r * kChunks;
      const bool ok = row0 + r < M;
      cp_async16(dst + r * kPitch + ((c ^ (r & 7)) << 4),
                 ok ? base + (size_t)i * 16 : enc_bytes, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load_tile(first + s * stride, s);
    cp_async_commit();
  }

  const int g = lane >> 2, tig = lane & 3;
  for (int it = 0; it < mine; ++it) {
    const int ahead = it + kStages - 1;
    if (ahead < mine) load_tile(first + ahead * stride, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();

    // sigma trunk, layer 0: A fragments straight from the swizzled tile;
    // for E % 16 == 8 only the first half of the last k16 step (a k8 mma)
    const uint32_t slot = ring_u32 + (it % kStages) * kSlotBytes;
    uint32_t x[2][kKT0][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int kt = 0; kt < kKT0; ++kt) {
        const int r = m * 16 + (lane & 15), c = 2 * kt + (lane >> 4);
        const uint32_t addr = slot + r * kPitch + ((c ^ (r & 7)) << 4);
        if (kHalfLast && kt == kKT0 - 1)
          ldmatrix_x2(x[m][kt][0], x[m][kt][1], addr);   // lanes 0-15
        else
          ldmatrix_x4(x[m][kt], addr);
      }
    }
    uint32_t a64[2][4][4];
    {
      float h[2][8][4];
      layer<kKT0, 8, kHalfLast>(h, x, f_w0, s_bias + kB0, lane);
      to_a<4, true>(a64, h);
    }
    // sigma trunk, layer 1: geo (fp32); sigma = geo[:, 0]; bf16 geo feeds
    // the colour MLP (its weight row 0 is zero)
    float sig[2][2];
    uint32_t a16[2][1][4];
    {
      float geo[2][2][4];
      layer<4, 2>(geo, a64, f_w1, s_bias + kB1, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        sig[m][0] = geo[m][0][0];
        sig[m][1] = geo[m][0][2];
      }
      to_a<1, false>(a16, geo);
    }
    {
      float c1[2][8][4];
      layer<1, 8>(c1, a16, f_c0, s_bias + kCB0, lane);
      to_a<4, true>(a64, c1);
    }
    {
      float c2[2][8][4];
      layer<4, 8>(c2, a64, f_c1, s_bias + kCB1, lane);
      to_a<4, true>(a64, c2);
    }
    float o[2][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint2 b = f_c2[kt * 32 + lane];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (kt == 0)
          mma_c(o[m], a64[m][0], b.x, b.y, bias2(s_bias + kCB2, 0, lane));
        else
          mma(o[m], a64[m][kt], b.x, b.y);
      }
    }

    // epilogue: lanes with tig 0 hold colour 0, 1 (and sigma), tig 1 holds
    // colour 2, for rows g and g + 8 of each m16 tile
    if (tig < 2) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m * 16 + g + 8 * h;
          if (tig == 0) {
            s_out[r * kOut] = sigmoid(o[m][2 * h]);
            s_out[r * kOut + 1] = sigmoid(o[m][2 * h + 1]);
            s_out[kTileRows * kOut + r] = sig[m][h];
          } else {
            s_out[r * kOut + 2] = sigmoid(o[m][2 * h]);
          }
        }
      }
    }
    __syncwarp();
    const int row0 = (first + it * stride) * kTileRows;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int i = lane + 32 * j;
      if (row0 + i / kOut < M) color[(size_t)row0 * kOut + i] = s_out[i];
    }
    if (row0 + lane < M) sigma[row0 + lane] = s_out[kTileRows * kOut + lane];
    __syncwarp();   // the slot and s_out are free for the next tile
  }
}

// Blocks of the persistent grid on the current device: SMs x resident
// blocks per SM, computed once per device (this also raises the kernel's
// dynamic shared-memory limit there). 0 with *err set on failure.
template <int E>
int persistent_blocks(cudaError_t* err) {
  static int cache[kMaxDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  *err = cudaFuncSetAttribute(fused_head_kernel<E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
  if (*err != cudaSuccess) return 0;
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_head_kernel<E>, kThreads, kSmemBytes);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (dev < kMaxDevices) cache[dev] = sms * per_sm;
  return sms * per_sm;
}

template <int E>
cudaError_t launch(const void* enc, const void* w0, const void* b0,
                   const void* w1, const void* b1, const void* cw0,
                   const void* cb0, const void* cw1, const void* cb1,
                   const void* cw2, const void* cb2, void* color,
                   void* sigma, int M, cudaStream_t stream) {
  cudaError_t err;
  const int blocks = persistent_blocks<E>(&err);
  if (blocks == 0) return err;
  const int ntiles = (M + kTileRows - 1) / kTileRows;
  const int need = (ntiles + kWarps - 1) / kWarps;
  const dim3 grid(need < blocks ? need : blocks);
  fused_head_kernel<E><<<grid, kThreads, kSmemBytes, stream>>>(
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

// Rows one pass of the persistent grid covers on the current device
// (blocks x warps x 32), or minus a CUDA error code.
int fused_field_head_wave_rows(int E) {
  if (E != 56) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int blocks = persistent_blocks<56>(&err);
  return blocks ? blocks * kWarps * kTileRows : -static_cast<int>(err);
}

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
