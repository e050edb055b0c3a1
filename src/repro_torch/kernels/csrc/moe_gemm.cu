// moe_gemm for Hopper (sm_90a): the grouped per-expert GEMM of a
// mixture-of-experts layer after dispatch.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py (_moe_gemm_kernel,
// moe_gemm; pallas_call at :41).  It computes what that computes, and what
// the plain version repro_torch/kernels/ref.py::moe_gemm_ref computes:
//
//   out[e, c, n] = sum_k x[e, c, k] * w[e, k, n]
//
// for x (E, C, d) and w (E, d, f), the sum in f32, the result rounded once
// to x's dtype, for bf16 and f32.
//
// Bound on this card, at the Granite-3.0 MoE shapes (40 experts, capacity
// 1024, d_model 1536, expert d_ff 512; gate/up and down are each 64.4
// GFLOP and 230.7 MB in bf16): the products take 65.1 us at the 989
// TFLOP/s bf16 tensor-core peak and the bytes 68.9 us at 3.35 TB/s, so
// ~69 us, near the ridge.  In f32 the products need the 67 TFLOP/s of the
// f32 units (the tensor cores would round f32 to TF32; the reference is a
// true f32 dot): 961 us.
//
// Design.  Three kernels; the wrapper (moe_gemm.py::variant) picks one
// before the launch from dtype, shape and alignment, never as a fallback:
//
//   * tma_wgmma (bf16, d and f multiples of 8, x and w 16-byte aligned:
//     what a tensor map can describe).  A persistent grid, one block per
//     SM, walks the (expert, C tile, f tile) tiles in that order, so the
//     blocks in flight share x rows and an expert's w in L2.  A block is
//     three warpgroups: a producer, of which one thread keeps a ring of
//     3 stages full by TMA (a (128 C, 64 d) box of x, K-major, and four
//     (64 d, 64 f) boxes of w, MN-major, all 128-byte swizzled, completion
//     on a "full" mbarrier per stage), and two consumer warpgroups, each
//     multiplying 64 rows of the 128 x 256 output tile by 4 wgmma
//     m64n256k16 per stage (w through the transpose bit), one stage's
//     group kept in flight while the next is issued, releasing a stage on
//     its "empty" mbarrier when its products are done.  TMA's zero fill
//     of out-of-bounds boxes replaces the zero-filling of ragged C and d;
//     the epilogue rounds to bf16 into a swizzled staging tile and TMA
//     stores it, which clips ragged C and f, while the producer already
//     loads the next tile.  Budget: 128 f32 accumulators a consumer
//     thread (setmaxnreg: consumers 232 registers, the producer 40); shared
//     memory 3 x 48 KB ring + 2 x 32 KB staging = 208 KB of 227 KB, so 3
//     stages, not 4 (a 128 x 128 tile would fit 5 stages but read 50% more
//     from L2 per product).  down (d = 512) has 8 stages a tile: there the
//     persistent grid and the asynchronous store keep the tensor cores fed
//     across tiles.
//   * mma_sync (every other bf16 input, e.g. f = 500): a 128 x 128 output
//     tile per block of 8 warps (2 x 4), each warp 64 x 32 from 4 x 4
//     mma.sync.m16n8k16 tiles (bf16 in, f32 accumulators: products of
//     bf16 values are exact in f32, as in the reference's f32 dot).
//     32-deep slices of x and w are copied to shared memory by the
//     threads, 16 bytes a thread where d (resp. f) is a multiple of 8 and
//     the pointer is 16-byte aligned, one element otherwise, zero-filled
//     past C, f and d; A fragments are 32-bit loads from the row-major x
//     tile (rows padded by 8 against bank conflicts); B fragments come
//     from the row-major w tile through ldmatrix.trans.  No copy overlaps
//     a product.
//   * f32_simt (f32): a 128 x 128 tile per block of 256 threads, each
//     thread 8 x 8 outputs (rows strided by 16, columns as two float4s),
//     16-deep slices double-buffered with cp.async (16 bytes a copy where
//     d and f are multiples of 4 and the pointers 16-byte aligned, else 4;
//     zero fill past the edges), one __fmaf_rn per product in ascending k.
//     No padded copy of x, w or out is made (the reference pads with
//     jnp.pad).

// Arithmetic: built with --fmad=false, never fast math.  The sums run in
// another order than the plain version's (cuBLAS on the card, with TF32
// off), so the kernel agrees with it to rounding
// (ref.py::moe_gemm_tolerance), not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;                // 8 warps: 2 (rows) x 4 (cols)
constexpr int kAS = kBK + 8;                 // row stride of the x tile
constexpr int kBS = kBN + 8;                 // row stride of the w tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i, and each lane receives, of each
// matrix, the two elements (2 (lane % 4), lane / 4) and (2 (lane % 4) + 1,
// lane / 4) — for a row-major (k, n) tile, an mma B fragment
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(kThreads)
moe_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int C, int d, int f,
                     bool vec_x, bool vec_w) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBM * kAS];
  __shared__ __align__(16) __nv_bfloat16 ws[kBK * kBS];
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * C * d;
  const __nv_bfloat16* we = w + static_cast<size_t>(e) * d * f;
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * C * f;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;     // mma fragment row / column pair
  const int wm = (warp >> 2) * 64;           // this warp's rows in the tile
  const int wn = (warp & 3) * 32;            // and its columns

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // -- stage the (128, 32) slice of x and the (32, 128) slice of w
    if (vec_x) {
      for (int i = tid; i < kBM * kBK / 8; i += kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const int gr = m0 + r, gc = k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gr < C && gc < d)
          v = *reinterpret_cast<const uint4*>(
              xe + static_cast<size_t>(gr) * d + gc);
        *reinterpret_cast<uint4*>(xs + r * kAS + c) = v;
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int gr = m0 + r, gc = k0 + c;
        xs[r * kAS + c] = (gr < C && gc < d)
            ? xe[static_cast<size_t>(gr) * d + gc] : zero;
      }
    }
    if (vec_w) {
      for (int i = tid; i < kBK * kBN / 8; i += kThreads) {
        const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gk < d && gn < f)
          v = *reinterpret_cast<const uint4*>(
              we + static_cast<size_t>(gk) * f + gn);
        *reinterpret_cast<uint4*>(ws + r * kBS + c) = v;
      }
    } else {
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        const int gk = k0 + r, gn = n0 + c;
        ws[r * kBS + c] = (gk < d && gn < f)
            ? we[static_cast<size_t>(gk) * f + gn] : zero;
      }
    }
    __syncthreads();

    // -- the products of the slice, 16 deep at a time
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = xs + (wm + i * 16 + g) * kAS + kk + t * 2;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * kAS);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * kAS + 8);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        // matrices: k rows kk..kk+7 and kk+8..kk+15 at column n, then the
        // same at column n + 8
        const int row = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = wn + jp * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + row * kBS + col);
        b[jp * 2][0] = r[0];
        b[jp * 2][1] = r[1];
        b[jp * 2 + 1][0] = r[2];
        b[jp * 2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();                 // the slice is consumed
  }

  // -- store: a thread holds rows g and g + 8, columns 2t and 2t + 1, of
  // each 16 x 8 tile
  const bool pairs = (f & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + i * 16 + g + h * 8;
      if (r >= C) continue;
      __nv_bfloat16* orow = oe + static_cast<size_t>(r) * f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn + j * 8 + t * 2;
        const float v0 = acc[i][j][h * 2], v1 = acc[i][j][h * 2 + 1];
        if (pairs && c + 1 < f) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < f) orow[c] = __float2bfloat16_rn(v0);
          if (c + 1 < f) orow[c + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs, cp.async double buffering
// ---------------------------------------------------------------------------
constexpr int kFM = 128, kFN = 128, kFK = 16;
constexpr int kFAS = kFK + 4;          // row stride of the x tile (16-byte rows)

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes, int bytes) {
  // copies src_bytes (0 or bytes) and zero-fills the rest of the bytes
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one 16-deep slice: x (128, 16) row-major with rows kFAS apart, w (16,
// 128) row-major; VEC copies 16 bytes a thread (d, f multiples of 4 and
// 16-byte aligned bases), else 4; out-of-range elements are zero-filled
template <bool VEC>
__device__ __forceinline__ void f32_stage(float* xs, float* ws,
                                          const float* xe, const float* we,
                                          int m0, int n0, int k0, int C,
                                          int d, int f, int tid) {
  constexpr int V = VEC ? 4 : 1;
#pragma unroll
  for (int u = 0; u < kFM * kFK / V / kThreads; ++u) {
    const int c = tid + u * kThreads;
    const int r = c / (kFK / V), k = (c % (kFK / V)) * V;
    const bool ok = m0 + r < C && k0 + k < d;
    const float* src = ok ? xe + static_cast<size_t>(m0 + r) * d + k0 + k
                          : xe;
    cp_async(xs + r * kFAS + k, src, ok ? 4 * V : 0, 4 * V);
  }
#pragma unroll
  for (int u = 0; u < kFK * kFN / V / kThreads; ++u) {
    const int c = tid + u * kThreads;
    const int r = c / (kFN / V), n = (c % (kFN / V)) * V;
    const bool ok = k0 + r < d && n0 + n < f;
    const float* src = ok ? we + static_cast<size_t>(k0 + r) * f + n0 + n
                          : we;
    cp_async(ws + r * kFN + n, src, ok ? 4 * V : 0, 4 * V);
  }
  cp_async_commit();
}

// a 128 x 128 tile per block of 256 threads (16 x 16); thread (ty, tx)
// owns rows ty + 16 i (i < 8) and columns 4 tx + 64 j + c (j < 2, c < 4):
// x reads are broadcasts, w reads float4s of neighbouring columns
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
moe_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int C, int d, int f) {
  __shared__ __align__(16) float xs[2][kFM * kFAS];
  __shared__ __align__(16) float ws[2][kFK * kFN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const float* xe = x + static_cast<size_t>(e) * C * d;
  const float* we = w + static_cast<size_t>(e) * d * f;
  float* oe = out + static_cast<size_t>(e) * C * f;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = (d + kFK - 1) / kFK;
  f32_stage<VEC>(xs[0], ws[0], xe, we, m0, n0, 0, C, d, f, tid);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {                 // the next slice loads meanwhile
      f32_stage<VEC>(xs[cur ^ 1], ws[cur ^ 1], xe, we, m0, n0,
                     (kt + 1) * kFK, C, d, f, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xt = xs[cur];
    const float* wt = ws[cur];
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xt[(ty + 16 * i) * kFAS + kk];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            wt + kk * kFN + 4 * tx + 64 * j);
        b[4 * j] = v.x;
        b[4 * j + 1] = v.y;
        b[4 * j + 2] = v.z;
        b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();                   // the slice is consumed
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= C) continue;
    float* orow = oe + static_cast<size_t>(r) * f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + 4 * tx + 64 * j;
      if (VEC) {
        if (c < f)
          *reinterpret_cast<float4*>(orow + c) = make_float4(
              acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
              acc[i][4 * j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < f) orow[c + q] = acc[i][4 * j + q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, TMA + wgmma: a persistent, warp-specialised kernel
// ---------------------------------------------------------------------------
namespace tma {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 3;
constexpr int kConsumers = 2;               // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 2;      // x slice (128, 64): 16 KB
constexpr int kBox = kBK * 64 * 2;          // w box (64 k, 64 n): 8 KB
constexpr int kStageBytes = kABytes + (kBN / 64) * kBox;   // 48 KB
constexpr int kOutBytes = 64 * kBN * 2;     // a warpgroup's output: 32 KB
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr size_t kSmem = 1024 + kStages * kStageBytes +
                         kConsumers * kOutBytes + 2 * kStages * 8;

__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_tma_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw,
                    const __grid_constant__ CUtensorMap tmo, int E, int C,
                    int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages * kStageBytes + kConsumers * kOutBytes);
  uint64_t* empty = full + kStages;

  const int tiles_m = (C + kBM - 1) / kBM, tiles_n = (f + kBN - 1) / kBN;
  const int tiles = E * tiles_m * tiles_n;
  const int nk = (d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // -- producer: one thread keeps the ring full, tile after tile
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int e = tile / (tiles_m * tiles_n);
        const int rem = tile - e * tiles_m * tiles_n;
        const int m0 = (rem / tiles_n) * kBM, n0 = (rem % tiles_n) * kBN;
        for (int kb = 0; kb < nk; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[stage], kStageBytes);
          hopper::tma_load_3d(st, &tmx, &full[stage], kb * kBK, m0, e);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            hopper::tma_load_3d(st + kABytes + j * kBox, &tmw, &full[stage],
                                n0 + 64 * j, kb * kBK, e);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of the
  // tile; 4 x m64n256k16 per 64-deep stage, one group in flight while the
  // next stage is issued
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* staged = smem + kStages * kStageBytes + wg * kOutBytes;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = tile / (tiles_m * tiles_n);
    const int rem = tile - e * tiles_m * tiles_n;
    const int m0 = (rem / tiles_n) * kBM, n0 = (rem % tiles_n) * kBN;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * kStageBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::wgmma_ss<1>(
            acc, hopper::desc_k_major(st + wg * 64 * 128 + kk * 32),
            hopper::desc_mn_major(st + kABytes + kk * 16 * 128, kBox),
            kb > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();         // the previous stage's products
      if (kb > 0 && threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[prev]);

    // epilogue (the producer is already loading the next tile): the
    // warpgroup's 64 x 256 outputs, rounded to bf16, go to shared memory
    // in the 128-byte-swizzled layout of four (64, 64) boxes, and TMA
    // stores them, clipping ragged C and f.  A thread holds rows r and
    // r + 8 (r % 8 == g), columns 8 j + 2 t and + 1 of each chunk j.
    if (leader) hopper::bulk_wait_read<0>();   // the last tile's store read
    hopper::named_barrier(1 + wg, 128);
    const int r = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      unsigned char* p = staged + (j / 8) * (64 * 128) + r * 128 +
                         (((j % 8) ^ g) * 16) + t * 4;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    hopper::fence_async_shared();
    hopper::named_barrier(1 + wg, 128);
    if (leader) {
#pragma unroll
      for (int b = 0; b < kBN / 64; ++b)
        hopper::tma_store_3d(&tmo, staged + b * 64 * 128, n0 + 64 * b,
                             m0 + 64 * wg, e);
      hopper::bulk_commit();
    }
  }
  if (leader) hopper::bulk_wait<0>();
}

}  // namespace tma

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int E,
                               int C, int d, int f, int bf16, int device,
                               cudaStream_t stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    const dim3 grid((f + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
    moe_gemm_bf16_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        C, d, f, d % 8 == 0 && aligned16(x), f % 8 == 0 && aligned16(w));
  } else {
    const dim3 grid((f + kFN - 1) / kFN, (C + kFM - 1) / kFM, E);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    if (d % 4 == 0 && f % 4 == 0 && aligned16(x) && aligned16(w) &&
        aligned16(out))
      moe_gemm_f32_kernel<true><<<grid, kThreads, 0, stream>>>(xf, wf, of, C,
                                                                d, f);
    else
      moe_gemm_f32_kernel<false><<<grid, kThreads, 0, stream>>>(xf, wf, of,
                                                                 C, d, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// The TMA / wgmma bf16 kernel.  Takes what a tensor map can describe: d
// and f multiples of 8 (row strides of 16 bytes), x and w 16-byte aligned;
// the wrapper (moe_gemm.py::variant) sends every other shape to
// moe_gemm_launch.  Returns 0, a cudaError_t, or hopper::kEncodeError plus
// the CUresult of a failed tensor-map encode.
extern "C" int moe_gemm_tma_launch(const void* x, const void* w, void* out,
                                   int E, int C, int d, int f, int device,
                                   cudaStream_t stream) {
  if (E < 1 || C < 1 || d < 8 || f < 8 || d % 8 != 0 || f % 8 != 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  namespace t = tma;
  CUtensorMap tmx, tmw, tmo;
  const cuuint64_t x_size[3] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(E)};
  const cuuint64_t x_stride[2] = {static_cast<cuuint64_t>(d) * 2,
                                  static_cast<cuuint64_t>(C) * d * 2};
  const cuuint32_t x_box[3] = {t::kBK, t::kBM, 1};
  int code = hopper::encode_bf16(&tmx, x, 3, x_size, x_stride, x_box);
  if (code != 0) return code;
  const cuuint64_t w_size[3] = {static_cast<cuuint64_t>(f),
                                static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(E)};
  const cuuint64_t w_stride[2] = {static_cast<cuuint64_t>(f) * 2,
                                  static_cast<cuuint64_t>(d) * f * 2};
  const cuuint32_t w_box[3] = {64, t::kBK, 1};
  code = hopper::encode_bf16(&tmw, w, 3, w_size, w_stride, w_box);
  if (code != 0) return code;
  const cuuint64_t o_size[3] = {static_cast<cuuint64_t>(f),
                                static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(E)};
  const cuuint64_t o_stride[2] = {static_cast<cuuint64_t>(f) * 2,
                                  static_cast<cuuint64_t>(C) * f * 2};
  const cuuint32_t o_box[3] = {64, 64, 1};
  code = hopper::encode_bf16(&tmo, out, 3, o_size, o_stride, o_box);
  if (code != 0) return code;

  // setmaxnreg moves registers between the warpgroups of one block: the
  // block must hold what the consumers take plus what the producer keeps
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, t::moe_gemm_tma_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * t::kThreads <
      128 * (t::kConsumers * t::kConsumerRegs + t::kProducerRegs))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(t::moe_gemm_tma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(t::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(E) *
                          ((C + t::kBM - 1) / t::kBM) *
                          ((f + t::kBN - 1) / t::kBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  t::moe_gemm_tma_kernel<<<grid, t::kThreads, t::kSmem, stream>>>(
      tmx, tmw, tmo, E, C, d, f);
  return static_cast<int>(cudaGetLastError());
}
