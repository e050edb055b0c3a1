// rmsnorm for Hopper (sm_90a): row RMS normalisation scaled by (1 + scale).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py (_rmsnorm_kernel,
// rmsnorm_fwd; pallas_call at :32).  It computes what that computes, and
// what the plain version repro_torch/kernels/ref.py::rmsnorm_ref computes,
// for x (R, d) in f32 or bf16 and an f32 scale (d,):
//
//   out[r, c] = x[r, c] * 1 / sqrt(mean_c(x[r, c]^2) + eps) * (1 + scale[c])
//
// with every step in f32 and the result rounded once to x's dtype.
//
// Bound on this card: bytes.  A launch reads x once and writes out once
// (2 R d times the element size, plus 4 d bytes of scale): at R = 4096,
// d = 5376 in bf16, 88.1 MB, 26.3 us at 3.35 TB/s; its ~4 R d flops are
// nothing beside that.  Design: the row is read from device memory once.
// A row belongs to tpr threads (a power of two from 32 to 512, chosen so
// that each thread holds at most kCache 16-byte vectors of it), and a
// block holds 256 / tpr rows where rows are narrow, so that a block has at
// least 256 threads; the TPU kernel's (256, d) row tiles in VMEM become
// this.  Each thread loads its vectors into registers and sums their
// squares; the sum is reduced over the warp with shuffles and over the
// row's warps through shared memory; the second pass scales the values
// held in registers and stores them.  Loads and stores are 16 bytes a
// thread (8 bf16 or 4 f32) where d is a multiple of that width and the
// pointers are 16-byte aligned, one element otherwise (d = 7, views that
// start off alignment).  Rows longer than tpr * kCache vectors (d > 16384
// bf16 or 8192 f32 on the vector path) read the rest again in the second
// pass.
//
// Arithmetic: built with --fmad=false, never fast math.  The inverse root
// is 1.0f / sqrtf(var + eps): IEEE square root and division, each
// correctly rounded (the approximate rsqrtf is off by up to 2 ulp).  The
// sum of squares is taken in another order than the plain version's, and
// neither XLA's nor PyTorch's CUDA rsqrt is correctly rounded, so the
// kernel agrees with the plain version to a few ulp, not bit for bit
// (ref.py::rmsnorm_tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCache = 4;           // 16-byte vectors a thread holds
constexpr int kMinThreads = 256;    // threads a block has at least
constexpr int kMaxTpr = 512;        // threads a row has at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements at p: one 16-byte access when V > 1
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(*p);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_float(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = from_float<T>(in[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <int V>
__device__ __forceinline__ void load_scale(const float* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 s = *reinterpret_cast<const float4*>(p + i);
      out[i] = s.x;
      out[i + 1] = s.y;
      out[i + 2] = s.z;
      out[i + 3] = s.w;
    }
  }
}

// y = (x * inv) * (1 + s), in the plain version's order
template <typename T, int V>
__device__ __forceinline__ void scale_store(T* o, const float* s_ptr,
                                            const float (&x)[V], float inv) {
  float s[V], y[V];
  load_scale<V>(s_ptr, s);
#pragma unroll
  for (int i = 0; i < V; ++i)
    y[i] = __fmul_rn(__fmul_rn(x[i], inv), __fadd_rn(1.0f, s[i]));
  store_vec<T, V>(o, y);
}

// blockDim = (tpr, rows per block); V elements per access (16 bytes, or 1)
template <typename T, int V>
__global__ void __launch_bounds__(kMaxTpr)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int R, int d, float eps) {
  __shared__ float partial[kMaxTpr / 32];    // one per warp of the block
  const int tpr = blockDim.x;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < R;
  const int nvec = d / V;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * d;
  T* orow = out + static_cast<size_t>(live ? row : 0) * d;

  float cache[kCache][V];
  float ss = 0.0f;
  if (live) {
#pragma unroll
    for (int it = 0; it < kCache; ++it) {
      const int v = tid + it * tpr;
      if (v < nvec) {
        load_vec<T, V>(xr + v * V, cache[it]);
#pragma unroll
        for (int i = 0; i < V; ++i)
          ss = __fadd_rn(ss, __fmul_rn(cache[it][i], cache[it][i]));
      }
    }
    for (int v = tid + kCache * tpr; v < nvec; v += tpr) {
      float vals[V];
      load_vec<T, V>(xr + v * V, vals);
#pragma unroll
      for (int i = 0; i < V; ++i)
        ss = __fadd_rn(ss, __fmul_rn(vals[i], vals[i]));
    }
  }

  // the row's sum: over the warp, then over the row's warps
  for (int o = 16; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
  const int wpr = tpr >> 5;                  // warps per row
  if (wpr > 1) {
    const int warp = (threadIdx.y * tpr + tid) >> 5;
    if ((tid & 31) == 0) partial[warp] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int i = 0; i < wpr; ++i)
      ss = __fadd_rn(ss, partial[threadIdx.y * wpr + i]);
  }
  if (!live) return;
  const float var = __fdiv_rn(ss, static_cast<float>(d));
  const float inv = 1.0f / sqrtf(__fadd_rn(var, eps));

#pragma unroll
  for (int it = 0; it < kCache; ++it) {
    const int v = tid + it * tpr;
    if (v < nvec)
      scale_store<T, V>(orow + v * V, scale + v * V, cache[it], inv);
  }
  for (int v = tid + kCache * tpr; v < nvec; v += tpr) {
    float vals[V];
    load_vec<T, V>(xr + v * V, vals);
    scale_store<T, V>(orow + v * V, scale + v * V, vals, inv);
  }
}

template <typename T, int V>
int launch(const void* x, const float* scale, void* out, int R, int d,
           float eps, cudaStream_t stream) {
  const int nvec = d / V;
  int tpr = 32;
  while (tpr < kMaxTpr && tpr * kCache < nvec) tpr *= 2;
  const int rows = tpr >= kMinThreads ? 1 : kMinThreads / tpr;
  const dim3 block(tpr, rows);
  const int grid = (R + rows - 1) / rows;
  rmsnorm_kernel<T, V><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), R, d, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const float* scale, void* out,
                              int R, int d, float eps, int bf16, int device,
                              cudaStream_t stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned16(x) && aligned16(scale) && aligned16(out);
  if (bf16) {
    if (vec && d % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, scale, out, R, d, eps, stream);
    return launch<__nv_bfloat16, 1>(x, scale, out, R, d, eps, stream);
  }
  if (vec && d % 4 == 0)
    return launch<float, 4>(x, scale, out, R, d, eps, stream);
  return launch<float, 1>(x, scale, out, R, d, eps, stream);
}
