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
// dx rounded once to x's dtype and dscale once to the scale's.
//
// Bound on this card: bytes.  x and dy are read once and dx written once:
// at (8192, 1536) bf16, 75.5 MB, 22.5 us at 3.35 TB/s; at (8192, 7168)
// bf16 352 MB, 105 us; ~12 flops an element are nothing beside that.
// Design (for that bound).  Each row is read once: a row belongs to tpr
// threads that hold its 16-byte vectors of x and of dy in registers,
// PER each (the forward's split, with at most 256 threads a bf16 row and
// 448 an f32 one so the registers fit; only a row past tpr * kCache
// vectors reads its rest again, and keeps the rest's dscale sums in
// shared memory); the two row sums and then dx come from those
// registers.  Narrow rows share a block, and each block has its next
// row's loads in flight, in a second set of registers, while the current
// row reduces, as in the forward; x and dy are loaded streaming (evict
// first) and dx stored so.  (A ring of three stages in shared memory
// filled by cp.async, two rows ahead, measured slower on the card.)
// Each thread keeps 1 + scale and the dscale sums of its own columns in
// registers across all of its rows.  The grid is persistent, at most two
// blocks an SM (one cooperative launch of G blocks), so at the end each
// block adds its row slots in slot order into one row of a (G, d) f32
// partial buffer, a few hundred rows (G = 1: dscale itself).  After a
// grid barrier the whole grid sums the columns: for G >= 16, 16-column
// tiles over the blocks, in a tile 16 chunks (half-warps) each summing
// the partial rows b = k, k + 16, ... in order and then the chunks added
// in order; for G < 16 a thread a column, the rows in order.  So the
// order of every sum depends on (G, d) alone and no float atomic is
// used: two launches give the same bits, as a recompute under remat or a
// resumed run needs.
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
// multiple of 32, at most max_tpr) with the fewest idle vector slots, the
// larger PER on a tie; rows past max_tpr * kCache vectors take the widest.
void split_row(int nvec, int* per_out, int* tpr_out, int max_tpr = kMaxTpr) {
  int best_per = kCache, best_tpr = max_tpr;
  long best_idle = -1;
  for (int per = 1; per <= kCache; ++per) {
    const int need = (nvec + per - 1) / per;
    const int tpr = (need + 31) / 32 * 32;
    if (tpr > max_tpr) continue;
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
// threads a row at most, and so a block's: a bf16 thread holds per vector
// x, dy, the next row's x and dy (16 registers) and 1 + scale and dscale
// for 8 columns (16 more), so 256 leave it up to 255 registers; an f32
// thread half that, and 448 threads leave it 146 (d = 7168 in f32 is 1792
// vectors: 448 threads of 4)
template <typename T>
constexpr int kBwdMaxTpr = sizeof(T) == 2 ? 256 : 448;
constexpr int kBwdBlocksPerSm = 2;   // the persistent grid: at most 2 an SM
constexpr int kBwdMinThreads = 256;  // threads a block has at least
constexpr int kColTile = 16;         // the column pass: columns a tile
constexpr int kChunks = 16;          // and partial rows b = k mod kChunks

// V dscale sums of columns c.. to the block's partial row (f32, 16 bytes
// at a time where V allows), or, where the grid is one block, to dscale
template <typename S, int V>
__device__ __forceinline__ void store_sums(float* prow, S* dscale, int c,
                                           const float* a) {
  if (gridDim.x == 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) dscale[c + i] = from_float<S>(a[i]);
  } else if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(prow + c + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) prow[c + i] = a[i];
  }
}

// the two sums of a row for V of its columns: x^2 and (dy (1 + s)) x
template <typename T, int V>
__device__ __forceinline__ void row_sums(const Raw<T, V>& xr,
                                         const Raw<T, V>& gr,
                                         const float (&w)[V], float& ss,
                                         float& dot) {
  float xv[V], gv[V];
  unpack<T, V>(xr, xv);
  unpack<T, V>(gr, gv);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ss = __fadd_rn(ss, __fmul_rn(xv[i], xv[i]));
    dot = __fadd_rn(dot, __fmul_rn(__fmul_rn(gv[i], w[i]), xv[i]));
  }
}

// dx = r g - x c for V columns, stored (streaming); their dscale terms
// (dy x) r added to acc
template <typename T, int V>
__device__ __forceinline__ void row_grads(T* o, const Raw<T, V>& xr,
                                          const Raw<T, V>& gr,
                                          const float (&w)[V], float r,
                                          float c, float* acc) {
  float xv[V], gv[V], out[V];
  unpack<T, V>(xr, xv);
  unpack<T, V>(gr, gv);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float g = __fmul_rn(gv[i], w[i]);
    out[i] = __fsub_rn(__fmul_rn(r, g), __fmul_rn(xv[i], c));
    acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(gv[i], xv[i]), r));
  }
  store_out<T, V>(o, out);
}

// blockDim = (tpr, rows a block), as the forward's; each thread holds PER
// vectors v = tid + it * tpr of a row's x and dy (only those registers),
// the next row's in a second set, and 1 + scale and the dscale sums of
// those columns across all of its rows.  Vectors past PER * tpr (rows
// wider than kBwdMaxTpr * kCache vectors, one row a block) are read again
// and their dscale sums kept in shared memory.  A grid of G co-resident
// blocks (a cooperative launch); partial: (G, d) f32, a block's row of
// dscale sums, its row slots added in order; after the grid barrier the
// whole grid sums the columns (the column pass).
template <typename T, typename S, int V, int PER>
__global__ void __launch_bounds__(kBwdMaxTpr<T>)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   S* __restrict__ dscale, float* __restrict__ partial,
                   int R, int d, float eps) {
  // rows > 1: the block's dscale row; else the rest's dscale sums
  extern __shared__ float acc_s[];
  __shared__ float red[2][2][kMaxTpr / 32];    // two sums a warp, two rows
  __shared__ float chunk[kChunks][kColTile];
  const int tpr = blockDim.x;
  const int tid = threadIdx.x;
  const int rows = blockDim.y;
  const int nvec = d / V;
  const int cached = PER * tpr;
  const int wpr = tpr >> 5;
  const int warp = (threadIdx.y * tpr + tid) >> 5;
  const int step = gridDim.x * rows;
  const int nrows = R;                         // the rows walked

  Raw<T, V> cx[PER], cg[PER], nx[PER], ng[PER];
  int row = blockIdx.x * rows + threadIdx.y;
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int v = tid + it * tpr;
    if (row < nrows && v < nvec) {
      const size_t o = static_cast<size_t>(row) * d + v * V;
      load_x<T, V>(x + o, cx[it]);
      load_x<T, V>(dy + o, cg[it]);
    }
  }
  float w[PER][V], acc[PER][V];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int v = tid + it * tpr;
    if (v < nvec) load_scale<S, V>(scale + v * V, w[it]);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[it][i] = 0.0f;
  }
  for (int v = cached + tid; v < nvec; v += tpr) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc_s[(v - cached) * V + i] = 0.0f;
  }

  for (int base = blockIdx.x * rows, parity = 0; base < nrows;
       base += step, parity ^= 1) {
    const bool live = row < nrows;
    const int next = row + step;
    // the next row's loads go out before this row's sums need a barrier
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int v = tid + it * tpr;
      if (next < nrows && v < nvec) {
        const size_t o = static_cast<size_t>(next) * d + v * V;
        load_x<T, V>(x + o, nx[it]);
        load_x<T, V>(dy + o, ng[it]);
      }
    }
    const size_t off = static_cast<size_t>(live ? row : 0) * d;

    float ss = 0.0f, dot = 0.0f;
    if (live) {
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int v = tid + it * tpr;
        if (v < nvec) row_sums<T, V>(cx[it], cg[it], w[it], ss, dot);
      }
      for (int v = cached + tid; v < nvec; v += tpr) {
        Raw<T, V> xr, gr;
        float ws[V];
        load_x<T, V>(x + off + v * V, xr);
        load_x<T, V>(dy + off + v * V, gr);
        load_scale<S, V>(scale + v * V, ws);
        row_sums<T, V>(xr, gr, ws, ss, dot);
      }
    }

    // the row's two sums: over the warp, then over the row's warps
    for (int o = 16; o > 0; o >>= 1) {
      ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
      dot = __fadd_rn(dot, __shfl_xor_sync(kFull, dot, o));
    }
    if (wpr > 1) {
      if ((tid & 31) == 0) {
        red[parity][0][warp] = ss;
        red[parity][1][warp] = dot;
      }
      __syncthreads();
      ss = 0.0f;
      dot = 0.0f;
      for (int i = 0; i < wpr; ++i) {
        ss = __fadd_rn(ss, red[parity][0][threadIdx.y * wpr + i]);
        dot = __fadd_rn(dot, red[parity][1][threadIdx.y * wpr + i]);
      }
    }

    if (live) {
      const float r = 1.0f / sqrtf(__fadd_rn(
          __fdiv_rn(ss, static_cast<float>(d)), eps));
      const float c = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r),
                                __fdiv_rn(dot, static_cast<float>(d)));
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int v = tid + it * tpr;
        if (v < nvec)
          row_grads<T, V>(dx + off + v * V, cx[it], cg[it], w[it], r, c,
                          acc[it]);
      }
      for (int v = cached + tid; v < nvec; v += tpr) {
        Raw<T, V> xr, gr;
        float ws[V];
        load_x<T, V>(x + off + v * V, xr);
        load_x<T, V>(dy + off + v * V, gr);
        load_scale<S, V>(scale + v * V, ws);
        row_grads<T, V>(dx + off + v * V, xr, gr, ws, r, c,
                        acc_s + (v - cached) * V);
      }
    }
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      cx[it] = nx[it];
      cg[it] = ng[it];
    }
    row = next;
  }

  // the block's partial row: its row slots added in slot order through
  // shared memory (rows > 1 leaves no rest), the last slot storing
  float* prow = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int y = 0; y < rows; ++y) {
    if (threadIdx.y == y) {
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int v = tid + it * tpr;
        if (v >= nvec) continue;
        if (y > 0) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[it][i] = __fadd_rn(acc_s[v * V + i], acc[it][i]);
        }
        if (y + 1 < rows) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc_s[v * V + i] = acc[it][i];
        } else {
          store_sums<S, V>(prow, dscale, v * V, acc[it]);
        }
      }
    }
    if (y + 1 < rows) __syncthreads();
  }
  for (int v = cached + tid; v < nvec; v += tpr)
    store_sums<S, V>(prow, dscale, v * V, acc_s + (v - cached) * V);

  // -- column pass
  const int G = gridDim.x;
  if (G > 1) {
    cooperative_groups::this_grid().sync();
    const int threads = tpr * rows;
    const int me = threadIdx.y * tpr + tid;
    if (G < kChunks) {
      // a thread a column, the partial rows in order
      for (int c = blockIdx.x * threads + me; c < d; c += G * threads) {
        float s = 0.0f;
        for (int b = 0; b < G; ++b)
          s = __fadd_rn(s, __ldcg(partial + static_cast<size_t>(b) * d + c));
        dscale[c] = from_float<S>(s);
      }
    } else {
      // column tiles of kColTile over the blocks; in a tile, chunk k (a
      // half-warp) sums the partial rows b = k, k + kChunks, ... in
      // order, then the chunks are added in order
      const int lane = me & 31;
      const int col_in = lane & (kColTile - 1);
      const int warps = threads >> 5;
      for (int t = blockIdx.x; t * kColTile < d; t += G) {
        const int col = t * kColTile + col_in;
        for (int k = 2 * warp + (lane >> 4); k < kChunks; k += 2 * warps) {
          float s = 0.0f;
          if (col < d) {
#pragma unroll 8
            for (int b = k; b < G; b += kChunks)
              s = __fadd_rn(s, __ldcg(partial + static_cast<size_t>(b) * d +
                                      col));
          }
          chunk[k][col_in] = s;
        }
        __syncthreads();
        if (me < kColTile && t * kColTile + me < d) {
          float s = chunk[0][me];
#pragma unroll
          for (int k = 1; k < kChunks; ++k) s = __fadd_rn(s, chunk[k][me]);
          dscale[t * kColTile + me] = from_float<S>(s);
        }
        __syncthreads();
      }
    }
  }
  // -- end column pass
}

// The instantiation, block shape and dynamic shared memory for rows of d
// elements (V a vector), the forward's split with the backward's width
struct BwdShape {
  const void* fn;
  int tpr, rows;
  size_t smem;
};

template <typename T, typename S, int V>
BwdShape bwd_shape(int d) {
  int per, tpr;
  split_row(d / V, &per, &tpr, kBwdMaxTpr<T>);
  BwdShape s;
  switch (per) {
    case 1: s.fn = reinterpret_cast<const void*>(
        rmsnorm_bwd_kernel<T, S, V, 1>); break;
    case 2: s.fn = reinterpret_cast<const void*>(
        rmsnorm_bwd_kernel<T, S, V, 2>); break;
    case 3: s.fn = reinterpret_cast<const void*>(
        rmsnorm_bwd_kernel<T, S, V, 3>); break;
    default: s.fn = reinterpret_cast<const void*>(
        rmsnorm_bwd_kernel<T, S, V, kCache>); break;
  }
  s.tpr = tpr;
  s.rows = tpr >= kBwdMinThreads ? 1 : kBwdMinThreads / tpr;
  const int rest = d / V - per * tpr;           // > 0 only at one row a block
  s.smem = sizeof(float) * static_cast<size_t>(
      s.rows > 1 ? d : (rest > 0 ? rest * V : 0));
  return s;
}

template <typename T, typename S>
BwdShape bwd_shape_of(int vec, int d) {
  return vec ? bwd_shape<T, S, 16 / sizeof(T)>(d) : bwd_shape<T, S, 1>(d);
}

BwdShape bwd_shape_for(int bf16, int scale_bf16, int vec, int d) {
  if (bf16)
    return scale_bf16 ? bwd_shape_of<__nv_bfloat16, __nv_bfloat16>(vec, d)
                      : bwd_shape_of<__nv_bfloat16, float>(vec, d);
  return scale_bf16 ? bwd_shape_of<float, __nv_bfloat16>(vec, d)
                    : bwd_shape_of<float, float>(vec, d);
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

// The backward's plan for rows of d elements of one dtype (bf16 = 1: bf16,
// else f32), scale bf16 (scale_bf16 = 1) or f32, read as 16-byte vectors
// (vec = 1: d a multiple of the width and x, dy, dx 16-byte aligned) or
// single elements: *cap, the blocks the card holds at once (at most
// kBwdBlocksPerSm an SM), and *rows, the rows a block takes at a time.  A
// launch on R rows takes grid = min(cap, ceil(R / rows)) blocks and a
// (grid, d) f32 partial buffer.  Returns a cudaError_t.
extern "C" int rmsnorm_bwd_plan(int d, int bf16, int scale_bf16, int vec,
                                int device, int* cap, int* rows) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  const BwdShape s = bwd_shape_for(bf16, scale_bf16, vec, d);
  int sms, max_smem, resident;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, s.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.smem + attr.sharedSizeBytes > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  // the most any d can ask of this instantiation (several d share it)
  err = cudaFuncSetAttribute(
      s.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, s.fn, s.tpr * s.rows, s.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *cap = sms * (resident < kBwdBlocksPerSm ? resident : kBwdBlocksPerSm);
  *rows = s.rows;
  return 0;
}

// x, dy, dx (R, d) contiguous, of one dtype (bf16 = 1: bf16, else f32);
// scale and dscale (d,) contiguous, bf16 (scale_bf16 = 1) or f32; vec as
// for rmsnorm_bwd_plan (refused where x, dy or dx is not 16-byte aligned
// or d not a multiple of the width); partial (grid, d) f32 scratch, grid
// at most the plan's cap.  One cooperative launch, no query.  Returns a
// cudaError_t (0 on a good launch).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  float* partial, int R, int d, float eps,
                                  int bf16, int scale_bf16, int vec,
                                  int grid, int device, cudaStream_t stream) {
  if (R < 1 || d < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = bf16 ? 8 : 4;
  if (vec && (d % width != 0 ||
              ((reinterpret_cast<uintptr_t>(x) |
                reinterpret_cast<uintptr_t>(dy) |
                reinterpret_cast<uintptr_t>(dx)) & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdShape s = bwd_shape_for(bf16, scale_bf16, vec, d);
  void* args[] = {&x, &scale, &dy, &dx, &dscale, &partial, &R, &d, &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      s.fn, dim3(grid), dim3(s.tpr, s.rows), args, s.smem, stream));
}
