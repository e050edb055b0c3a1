// rmsnorm for Hopper (sm_90a): row RMS normalisation scaled by (1 + scale).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py (_rmsnorm_kernel at
// :16, rmsnorm_fwd at :23, pallas_call at :32).  It computes what that
// computes, and what the plain version repro_torch/kernels/ref.py::
// rmsnorm_ref computes, for x (R, d) in f32 or bf16 and scale (d,) in f32
// or bf16:
//
//   out[r, c] = x[r, c] * 1 / sqrt(mean_c(x[r, c]^2) + eps) * (1 + scale[c])
//
// with every step in f32 and the result rounded once to x's dtype.
//
// Bound on this card: bytes.  A launch reads x once and writes out once
// (2 R d times the element size, plus d of scale): at R = 4096, d = 5376
// in bf16, 88.1 MB, 26.3 us at 3.35 TB/s; its ~5 R d flops are nothing
// beside that.  At (7, 7168) the bound is 0.07 us and the launch is what
// takes the time.
//
// Design.  One launch per call: the scale is read in its own dtype (bf16
// to f32 is exact), so no cast runs beside the kernel.  A row belongs to
// tpr threads (a multiple of 32, at most 512) that hold its 16-byte
// vectors (8 bf16 or 4 f32) evenly, PER of them each (at most kCache; a
// template parameter, so a thread keeps only those registers): the
// launcher picks PER and tpr so that tpr * PER covers the row with the
// fewest idle slots (d = 5376 bf16: 224 threads of 3 vectors, where a
// power of two left the third vector to 160 of 256 threads).  Narrow rows
// share a block (256 / tpr rows a block).  The grid is persistent: as many
// blocks as the SMs hold at once, rows strided over them, so each thread
// reads (1 + scale) for its columns once, into registers, instead of once
// a row; a small R (7 rows) keeps one block a row.  Each block has its
// next row's loads in flight, in a second set of registers, while the
// current row reduces (warp shuffles, then the row's warps through shared
// memory, one barrier a row) and stores.  Loads of x stream (ld.global.cs:
// evict first) and so do the stores.  Vectors are used where d is a
// multiple of the vector width and x and out are 16-byte aligned, single
// elements otherwise (d = 7, views that start off alignment).  Rows longer
// than tpr * kCache vectors read the rest again in the second pass, with
// their scale, without the prefetch.
//
// The backward (rmsnorm_bwd_launch, below the forward) is the port's own:
// the reference differentiates its jnp rms_norm, and no TPU kernel has a
// backward.  Given dy, it recomputes r = 1 / sqrt(mean(x^2) + eps) per row
// rather than storing it and writes
//
//   g         = dy * (1 + scale)
//   dx        = r * g - x * (r * r * r * mean(g * x))
//   dscale[c] = sum over rows of dy * x * r
//
// (ref.py::rmsnorm_bwd_ref, the same formula written out), all in f32,
// dx rounded once to x's dtype and dscale once to the scale's.  One
// cooperative launch: each block takes rows blockIdx.x + k * gridDim.x and
// sums its rows' dscale terms for the columns each thread owns in shared
// memory; after a grid barrier the blocks' partial rows are summed column
// by column in block order.  No float atomics, so the result does not
// depend on timing: a recompute under remat or a resumed run gives the same
// bits.  Bound: bytes (x and dy read, dx written).
//
// Arithmetic: built with --fmad=false, never fast math.  The inverse root
// is 1.0f / sqrtf(var + eps): IEEE square root and division, each
// correctly rounded (the approximate rsqrtf is off by up to 2 ulp); each
// output is (x * inv) * (1 + s) in that order.  The sum of squares is
// taken in another order than the plain version's, and neither XLA's nor
// PyTorch's CUDA rsqrt is correctly rounded, so the kernel agrees with the
// plain version to a few ulp, not bit for bit (ref.py::rmsnorm_tolerance).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// V consecutive elements of x in their own dtype, as loaded: one 16-byte
// vector (V > 1) or one element
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

// vectors stream (evict first: x is read once, out written once); single
// elements (misaligned views, odd d) are plain accesses
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* p, Raw<T, V>& out) {
  if constexpr (V == 1) {
    out = *p;
  } else {
    out = __ldcs(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& in, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(in);
  } else {
    const T* e = reinterpret_cast<const T*>(&in);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_float(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_out(T* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = from_float<T>(in[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(in[i]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  }
}

// 1 + scale for V consecutive columns, scale in its own dtype (read once a
// thread on the persistent path, so single loads do)
template <typename S, int V>
__device__ __forceinline__ void load_scale(const S* p, float (&out)[V]) {
  // -- scale read
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = __fadd_rn(1.0f, to_float(p[i]));
  // -- end scale read
}

template <typename T, int V>
__device__ __forceinline__ float sum_squares(const Raw<T, V>& x, float ss) {
  float f[V];
  unpack<T, V>(x, f);
#pragma unroll
  for (int i = 0; i < V; ++i) ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
  return ss;
}

// y = (x * inv) * (1 + s), in the plain version's order
template <typename T, int V>
__device__ __forceinline__ void scale_store(T* o, const Raw<T, V>& x,
                                            const float (&w)[V], float inv) {
  float f[V], y[V];
  unpack<T, V>(x, f);
#pragma unroll
  for (int i = 0; i < V; ++i) y[i] = __fmul_rn(__fmul_rn(f[i], inv), w[i]);
  store_out<T, V>(o, y);
}

// blockDim = (tpr, rows a block); each thread holds PER <= kCache vectors
// of a row, v = tid + it * tpr (only those registers: the fewer a thread
// holds, the more blocks an SM takes); V elements a vector (16 bytes, or
// 1).  Rows r = blockIdx.x * rows + threadIdx.y, stepping by gridDim.x *
// rows; every thread walks the same number of steps (the barrier).
template <typename T, typename S, int V, int PER>
__global__ void __launch_bounds__(kMaxTpr)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int R, int d, float eps) {
  __shared__ float partial[2][kMaxTpr / 32];   // a warp's sum, two rows
  const int tpr = blockDim.x;
  const int tid = threadIdx.x;
  const int rows = blockDim.y;
  const int nvec = d / V;
  const int wpr = tpr >> 5;                    // warps a row
  const int warp = (threadIdx.y * tpr + tid) >> 5;
  const int step = gridDim.x * rows;

  // the first row's loads go out before the scale's, whose 1 + s would
  // otherwise hold them back by one memory round trip
  Raw<T, V> cur[PER], nxt[PER];
  int row = blockIdx.x * rows + threadIdx.y;
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int v = tid + it * tpr;
    if (row < R && v < nvec)
      load_x<T, V>(x + static_cast<size_t>(row) * d + v * V, cur[it]);
  }
  float w[PER][V];                             // 1 + scale, read once
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int v = tid + it * tpr;
    if (v < nvec) load_scale<S, V>(scale + v * V, w[it]);
  }

  for (int base = blockIdx.x * rows, parity = 0; base < R;
       base += step, parity ^= 1) {
    const bool live = row < R;
    const int next = row + step;
    // the next row's loads go out before this row's sum needs a barrier
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int v = tid + it * tpr;
      if (next < R && v < nvec)
        load_x<T, V>(x + static_cast<size_t>(next) * d + v * V, nxt[it]);
    }
    const T* xr = x + static_cast<size_t>(live ? row : 0) * d;
    T* orow = out + static_cast<size_t>(live ? row : 0) * d;

    float ss = 0.0f;
    if (live) {
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int v = tid + it * tpr;
        if (v < nvec) ss = sum_squares<T, V>(cur[it], ss);
      }
      for (int v = tid + PER * tpr; v < nvec; v += tpr) {
        Raw<T, V> rest;
        load_x<T, V>(xr + v * V, rest);
        ss = sum_squares<T, V>(rest, ss);
      }
    }

    // the row's sum: over the warp, then over the row's warps
    for (int o = 16; o > 0; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
    if (wpr > 1) {
      if ((tid & 31) == 0) partial[parity][warp] = ss;
      __syncthreads();
      ss = 0.0f;
      for (int i = 0; i < wpr; ++i)
        ss = __fadd_rn(ss, partial[parity][threadIdx.y * wpr + i]);
    }

    if (live) {
      const float var = __fdiv_rn(ss, static_cast<float>(d));
      const float inv = 1.0f / sqrtf(__fadd_rn(var, eps));
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int v = tid + it * tpr;
        if (v < nvec) scale_store<T, V>(orow + v * V, cur[it], w[it], inv);
      }
      for (int v = tid + PER * tpr; v < nvec; v += tpr) {
        Raw<T, V> rest;
        float ws[V];
        load_x<T, V>(xr + v * V, rest);
        load_scale<S, V>(scale + v * V, ws);
        scale_store<T, V>(orow + v * V, rest, ws, inv);
      }
    }
#pragma unroll
    for (int it = 0; it < PER; ++it) cur[it] = nxt[it];
    row = next;
  }
}

// The row's split: PER vectors a thread (1..kCache) and tpr threads (a
// multiple of 32, at most kMaxTpr) with the fewest idle vector slots, the
// larger PER on a tie; rows past kMaxTpr * kCache vectors take the widest.
void split_row(int nvec, int* per_out, int* tpr_out) {
  int best_per = kCache, best_tpr = kMaxTpr;
  long best_idle = -1;
  for (int per = 1; per <= kCache; ++per) {
    const int need = (nvec + per - 1) / per;
    const int tpr = (need + 31) / 32 * 32;
    if (tpr > kMaxTpr) continue;
    const long idle = static_cast<long>(tpr) * per - nvec;
    if (best_idle < 0 || idle <= best_idle) {
      best_idle = idle;
      best_per = per;
      best_tpr = tpr;
    }
  }
  *per_out = best_per;
  *tpr_out = best_tpr;
}

template <typename T, typename S, int V, int PER>
int launch_per(const void* x, const void* scale, void* out, int R, int d,
               int tpr, float eps, cudaStream_t stream) {
  const int rows = tpr >= kMinThreads ? 1 : kMinThreads / tpr;
  const dim3 block(tpr, rows);
  auto kernel = rmsnorm_kernel<T, S, V, PER>;
  int device, sms, resident;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        tpr * rows, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (R + rows - 1) / rows;
  const int grid = needed < sms * resident ? needed : sms * resident;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), R, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, int V>
int launch(const void* x, const void* scale, void* out, int R, int d,
           float eps, cudaStream_t stream) {
  int per, tpr;
  split_row(d / V, &per, &tpr);
  switch (per) {
    case 1:
      return launch_per<T, S, V, 1>(x, scale, out, R, d, tpr, eps, stream);
    case 2:
      return launch_per<T, S, V, 2>(x, scale, out, R, d, tpr, eps, stream);
    case 3:
      return launch_per<T, S, V, 3>(x, scale, out, R, d, tpr, eps, stream);
    default:
      return launch_per<T, S, V, kCache>(x, scale, out, R, d, tpr, eps,
                                         stream);
  }
}

template <typename T, typename S>
int launch_aligned(const void* x, const void* scale, void* out, int R, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec && d % kVec == 0)
    return launch<T, S, kVec>(x, scale, out, R, d, eps, stream);
  return launch<T, S, 1>(x, scale, out, R, d, eps, stream);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  Raw<T, V> raw;
  if constexpr (V == 1) {
    raw = *p;
  } else {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  unpack<T, V>(raw, out);
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

// the sum of two values over the block (kBwdThreads threads), the warps'
// sums added in warp order; `buf` alternates between calls (parity)
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*buf)[2][kBwdThreads / 32]) {
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(kFull, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(kFull, b, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    (*buf)[0][warp] = a;
    (*buf)[1][warp] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
  for (int i = 0; i < kBwdThreads / 32; ++i) {
    a = __fadd_rn(a, (*buf)[0][i]);
    b = __fadd_rn(b, (*buf)[1][i]);
  }
}

// grid: G co-resident blocks (a cooperative launch) of kBwdThreads; thread
// t owns the vectors v = t + k * kBwdThreads of every row (V elements a
// vector), and their dscale sums in shared memory (d floats), so no two
// threads touch one column.  partial: (G, d) f32.
template <typename T, typename S, int V>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   S* __restrict__ dscale, float* __restrict__ partial,
                   int R, int d, float eps) {
  extern __shared__ float acc[];               // d: this block's dscale sums
  __shared__ float red[2][2][kBwdThreads / 32];
  const int tid = threadIdx.x;
  const int nvec = d / V;
  for (int v = tid; v < nvec; v += kBwdThreads) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[v * V + i] = 0.0f;
  }
  int parity = 0;
  for (int row = blockIdx.x; row < R; row += gridDim.x, parity ^= 1) {
    const T* xr = x + static_cast<size_t>(row) * d;
    const T* gr = dy + static_cast<size_t>(row) * d;
    T* dr = dx + static_cast<size_t>(row) * d;
    float ss = 0.0f, dot = 0.0f;
    for (int v = tid; v < nvec; v += kBwdThreads) {
      float xv[V], gv[V], w[V];
      load_vec<T, V>(xr + v * V, xv);
      load_vec<T, V>(gr + v * V, gv);
      load_scale<S, V>(scale + v * V, w);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ss = __fadd_rn(ss, __fmul_rn(xv[i], xv[i]));
        dot = __fadd_rn(dot, __fmul_rn(__fmul_rn(gv[i], w[i]), xv[i]));
      }
    }
    block_sum2(ss, dot, &red[parity]);
    const float r = 1.0f / sqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)),
                                           eps));
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r),
                              __fdiv_rn(dot, static_cast<float>(d)));
    for (int v = tid; v < nvec; v += kBwdThreads) {
      float xv[V], gv[V], w[V], out[V];
      load_vec<T, V>(xr + v * V, xv);
      load_vec<T, V>(gr + v * V, gv);
      load_scale<S, V>(scale + v * V, w);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float g = __fmul_rn(gv[i], w[i]);
        out[i] = __fsub_rn(__fmul_rn(r, g), __fmul_rn(xv[i], c));
        acc[v * V + i] = __fadd_rn(acc[v * V + i],
                                   __fmul_rn(__fmul_rn(gv[i], xv[i]), r));
      }
      store_vec<T, V>(dr + v * V, out);
    }
  }
  for (int v = tid; v < nvec; v += kBwdThreads) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      partial[static_cast<size_t>(blockIdx.x) * d + v * V + i] = acc[v * V + i];
  }
  cooperative_groups::this_grid().sync();
  // each column's blocks summed in block order
  for (int c = blockIdx.x * kBwdThreads + tid; c < d;
       c += gridDim.x * kBwdThreads) {
    float s = 0.0f;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b)
      s = __fadd_rn(s, partial[static_cast<size_t>(b) * d + c]);
    dscale[c] = from_float<S>(s);
  }
}

template <typename T, typename S, int V>
int bwd_grid(int R, int d, int* grid, size_t* smem) {
  auto kernel = rmsnorm_bwd_kernel<T, S, V>;
  *smem = static_cast<size_t>(d) * sizeof(float);
  int device, sms, resident, max_smem;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*smem + sizeof(float) * 4 * (kBwdThreads / 32) >
      static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      kBwdThreads, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = R < sms * resident ? R : sms * resident;
  return 0;
}

template <typename T, typename S, int V>
int bwd_launch(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, float* partial, int R, int d, float eps,
               int grid, cudaStream_t stream) {
  int g;
  size_t smem;
  int err = bwd_grid<T, S, V>(R, d, &g, &smem);
  if (err != 0) return err;
  if (grid != g) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  S* dsp = static_cast<S*>(dscale);
  void* args[] = {&xp, &sp, &gp, &dxp, &dsp, &partial, &R, &d, &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, S, V>),
      dim3(grid), dim3(kBwdThreads), args, smem, stream));
}

// vectors where d is a multiple of the width and x, dy, dx are 16-byte
// aligned, single elements otherwise
template <typename T>
bool bwd_vectors(const void* x, const void* dy, const void* dx, int d) {
  constexpr int kVec = 16 / sizeof(T);
  return d % kVec == 0 &&
         ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
           reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
}

template <typename T, typename S>
int bwd_dispatch(const void* x, const void* scale, const void* dy, void* dx,
                 void* dscale, float* partial, int R, int d, float eps,
                 int grid, cudaStream_t stream, int* grid_out) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = bwd_vectors<T>(x, dy, dx, d);
  if (grid_out != nullptr) {
    size_t smem;
    return vec ? bwd_grid<T, S, kVec>(R, d, grid_out, &smem)
               : bwd_grid<T, S, 1>(R, d, grid_out, &smem);
  }
  return vec ? bwd_launch<T, S, kVec>(x, scale, dy, dx, dscale, partial, R, d,
                                      eps, grid, stream)
             : bwd_launch<T, S, 1>(x, scale, dy, dx, dscale, partial, R, d,
                                   eps, grid, stream);
}

int bwd_entry(const void* x, const void* scale, const void* dy, void* dx,
              void* dscale, float* partial, int R, int d, float eps, int bf16,
              int scale_bf16, int grid, int device, cudaStream_t stream,
              int* grid_out) {
  if (R < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16)
    return scale_bf16
        ? bwd_dispatch<__nv_bfloat16, __nv_bfloat16>(
              x, scale, dy, dx, dscale, partial, R, d, eps, grid, stream,
              grid_out)
        : bwd_dispatch<__nv_bfloat16, float>(x, scale, dy, dx, dscale,
                                             partial, R, d, eps, grid, stream,
                                             grid_out);
  return scale_bf16
      ? bwd_dispatch<float, __nv_bfloat16>(x, scale, dy, dx, dscale, partial,
                                           R, d, eps, grid, stream, grid_out)
      : bwd_dispatch<float, float>(x, scale, dy, dx, dscale, partial, R, d,
                                   eps, grid, stream, grid_out);
}

}  // namespace

// x (R, d) and out (R, d) contiguous, of one dtype (bf16 = 1: bf16, else
// f32); scale (d,) contiguous, bf16 (scale_bf16 = 1) or f32.  Returns a
// cudaError_t (0 on a good launch).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int R, int d, float eps, int bf16,
                              int scale_bf16, int device,
                              cudaStream_t stream) {
  if (R < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16)
    return scale_bf16
        ? launch_aligned<__nv_bfloat16, __nv_bfloat16>(x, scale, out, R, d,
                                                       eps, stream)
        : launch_aligned<__nv_bfloat16, float>(x, scale, out, R, d, eps,
                                               stream);
  return scale_bf16
      ? launch_aligned<float, __nv_bfloat16>(x, scale, out, R, d, eps, stream)
      : launch_aligned<float, float>(x, scale, out, R, d, eps, stream);
}

// The backward's grid for x, dy and dx at these addresses (the blocks that
// are resident at once, at most R): the rows of the (grid, d) f32 partial
// buffer that rmsnorm_bwd_launch needs.  Returns a cudaError_t.
extern "C" int rmsnorm_bwd_grid(const void* x, const void* dy,
                                const void* dx, int R, int d, int bf16,
                                int scale_bf16, int device, int* grid) {
  return bwd_entry(x, nullptr, dy, const_cast<void*>(dx), nullptr, nullptr, R,
                   d, 0.0f, bf16, scale_bf16, 0, device, nullptr, grid);
}

// x, dy, dx (R, d) contiguous, of one dtype (bf16 = 1: bf16, else f32);
// scale and dscale (d,) contiguous, bf16 (scale_bf16 = 1) or f32; partial
// (grid, d) f32 scratch, grid from rmsnorm_bwd_grid.  One cooperative
// launch.  Returns a cudaError_t (0 on a good launch).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  float* partial, int R, int d, float eps,
                                  int bf16, int scale_bf16, int grid,
                                  int device, cudaStream_t stream) {
  return bwd_entry(x, scale, dy, dx, dscale, partial, R, d, eps, bf16,
                   scale_bf16, grid, device, stream, nullptr);
}
