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
// Design.  The TPU grid (expert, C tile, f tile) becomes the CUDA grid;
// blocks are independent.  The TPU kernel loads whole d strips into VMEM;
// here a block walks d in slices staged through shared memory.  Ragged C,
// f and d edges are zero-filled in shared memory and masked on the store,
// so no padded copy of x, w or out is made (the reference pads with
// jnp.pad).
//
//   * bf16: a 128 x 128 output tile per block of 8 warps (2 x 4), each warp
//     64 x 32 from 4 x 4 mma.sync.m16n8k16 tiles (bf16 in, f32 accumulators:
//     products of bf16 values are exact in f32, as in the reference's f32
//     dot).  32-deep slices of x and w are copied to shared memory, 16
//     bytes a thread where d (resp. f) is a multiple of 8 and the pointer
//     is 16-byte aligned, one element otherwise.  A fragments are 32-bit
//     loads from the row-major x tile (rows padded by 8 against bank
//     conflicts); B fragments come from the row-major w tile through
//     ldmatrix.trans, which hands each lane its (k, k + 1) pairs of one
//     column.  The copy of a slice does not overlap the products of the
//     last (no cp.async / TMA pipeline), and mma.sync reaches only part of
//     the tensor-core rate: wgmma fed by TMA is later work.
//   * f32: a 64 x 64 tile per block of 256 threads, each thread 4 x 4
//     outputs strided by 16 (conflict-free shared reads, coalesced
//     stores), 16-deep slices, one fmaf per product in ascending k.
//
// Arithmetic: built with --fmad=false, never fast math.  The sums run in
// another order than the plain version's (cuBLAS on the card, with TF32
// off), so the kernel agrees with it to rounding
// (ref.py::moe_gemm_tolerance), not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// f32: scalar FMAs
// ---------------------------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
moe_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int C, int d, int f) {
  __shared__ float xs[kFM][kFK + 1];
  __shared__ float ws[kFK][kFN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const float* xe = x + static_cast<size_t>(e) * C * d;
  const float* we = w + static_cast<size_t>(e) * d * f;
  float* oe = out + static_cast<size_t>(e) * C * f;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kFK) {
    for (int i = tid; i < kFM * kFK; i += kThreads) {
      const int r = i / kFK, c = i % kFK;
      const int gr = m0 + r, gc = k0 + c;
      xs[r][c] = (gr < C && gc < d) ? xe[static_cast<size_t>(gr) * d + gc]
                                    : 0.0f;
    }
    for (int i = tid; i < kFK * kFN; i += kThreads) {
      const int r = i / kFN, c = i % kFN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < d && gn < f) ? we[static_cast<size_t>(gk) * f + gn]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < f) oe[static_cast<size_t>(r) * f + c] = acc[i][j];
    }
  }
}

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
    moe_gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), C, d, f);
  }
  return static_cast<int>(cudaGetLastError());
}
