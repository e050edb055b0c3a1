// fleet_feasibility and link_cost for Hopper (sm_90a): the cross-node
// admission verdict of one request, without and with the wire cost of a
// referral.
//
// Replace the TPU kernels repro/kernels/fleet_feasibility.py
// (_fleet_feasibility_kernel, fleet_feasibility_fwd; pallas_call at :117)
// and repro/kernels/link_cost.py (_link_cost_kernel, link_cost_fwd;
// pallas_call at :132).  They compute what those compute, and what the
// plain versions repro_torch/kernels/ref.py::fleet_feasibility_ref and
// ::link_cost_ref compute, per node row k of the stacked (K, N) ledgers:
//
//   link_cost only: arrive[k] = fma(payload, inv_bw_row[k], t_src +
//                   lat_row[k]) and free = max(arrive[k], busy[k]);
//                   fleet_feasibility takes free = cpu_free[k];
//   both:           the masked counts cap_idx / e_hi (searchsorted on a
//                   sorted ledger), the last interior gap at or before
//                   e_hi, the straddle and front fallbacks for the slot j
//                   and the window's right edge cap, the prefix work
//                   pw_j, the verdict feasible = cap - (free + pw_j) >=
//                   ps - eps && cap > free && head + n < N, and load =
//                   sum(sizes).
//
// The geometry is fleet_row.cuh's (event_select.cu and event_scan.cu),
// evaluated by a whole block here instead of one warp.  fleet_feasibility
// is also the event heap's batched_feasible scorer
// (orchestration/router.py: one launch a forwarding decision, K = the
// candidates, N = the router's power-of-two ledger width, head = 0).
//
// Bound on this card: bytes.  A launch must read the three (K, N) f32
// ledgers once (12 K N bytes) plus a few (K,) vectors and scalars, and
// write 5 K bytes (9 K for link_cost): at K = 256, N = 1024 about 3.15 MB,
// 0.94 us at 3.35 TB/s; at the router's K = 2, N = 512 about 12 KB, under
// 0.01 us.  Both sit below one kernel launch, so what a design can win is
// the latency of one row.
//
// Design: one block a row (K blocks, 32 to 256 threads by N; up to eight
// blocks an SM, so K = 256 rows are all resident at once).  The block
// stages the row's three arrays into shared memory with cp.async in one
// sweep, every copy in flight at once: 16 bytes a copy where the row is
// 16-byte aligned, the misaligned head and tail (N not a multiple of 4) 4
// bytes a copy, each array shifted in shared memory so that its aligned
// body lands on 16-byte boundaries.
// The order-free passes then read shared memory with every warp: the
// counts (__reduce_add_sync, then one shared-memory step), the gap
// maximum (__reduce_max_sync, likewise), the slot and its edge.  One warp
// takes both sums.  A row longer than one staged chunk (kChunk slots) is
// streamed through shared memory chunk by chunk inside the same launch,
// once for the counts, once for the gap (only chunks that can hold it)
// and once for the sums; the slot's edge is then read from the row in
// global memory.
//
// Arithmetic matches the plain versions bit for bit: every add is an
// explicit IEEE round-to-nearest intrinsic in the plain version's
// association order (built with --fmad=false, never fast math), and the
// one multiply is the fused multiply-add of the arrival, as XLA makes it
// of the reference's jitted code and ref.py::fma32 computes it.  The sums
// pw_j and load keep fleet_row.cuh's association: each lane's partial
// sum runs in order over i = lane, lane + 32, ... (chunks start on
// multiples of 32, so a lane's order carries across them), then
// fleet::warp_sum's butterfly.  So they equal event_select's bit for bit
// on the same row, are exact whenever the sizes are integers or dyadic
// (the event heap's are integers), and otherwise differ from the plain
// version's masked sum by less than ref.py::sum_order_rtol
// (ref.py::lane_tree_sum is this association in PyTorch).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fleet_row.cuh"
#include "hopper.cuh"

namespace {

using fleet::kBig;
using fleet::kFull;

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunk = 2048;         // slots staged at once (a multiple of 32)

// The staged chunk of one array occupies `pad` floats: the chunk and the
// up to 3 floats its realignment shifts it by, rounded to 16 bytes.
__host__ __device__ constexpr int pad_of(int chunk) {
  return (chunk + 3) / 4 * 4 + 4;
}

// Starts the copy of g[0, len) into shared memory at s[mis, mis + len),
// mis = g's float offset from a 16-byte boundary: the aligned body by
// 16-byte cp.async, the head and tail by 4-byte ones.  Returns mis.
__device__ __forceinline__ int stage_array(const float* g, float* s, int len,
                                           int tid, int nthr) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  const int pre = min((4 - mis) & 3, len);
  const int nv = (len - pre) >> 2;
  const int tail0 = pre + 4 * nv;
  for (int v = tid; v < nv; v += nthr)
    hopper::cp_async<4>(s + mis + pre + 4 * v, g + pre + 4 * v, true);
  if (tid < pre) hopper::cp_async<1>(s + mis + tid, g + tid, true);
  if (tid < len - tail0)
    hopper::cp_async<1>(s + mis + tail0 + tid, g + tail0 + tid, true);
  return mis;
}

// One ledger row as the block reads it: slots [c0, c1) staged in shared
// memory, slot i of an array at r[i + o].
struct StagedRow {
  const float* st;                  // the row in global memory
  const float* en;
  const float* sz;
  float* sm;                        // 3 * pad floats of shared memory
  int pad;
  const float* r_st;
  const float* r_en;
  const float* r_sz;
  int o_st, o_en, o_sz;
  int c0, c1;

  // stage slots [a, b); every thread of the block calls it
  __device__ __forceinline__ void load(int a, int b) {
    const int tid = threadIdx.x, nthr = blockDim.x;
    // -- staged loads
    if (c1 > c0) __syncthreads();   // every thread done with the last chunk
    r_st = sm;
    r_en = sm + pad;
    r_sz = sm + 2 * pad;
    o_st = stage_array(st + a, sm, b - a, tid, nthr) - a;
    o_en = stage_array(en + a, sm + pad, b - a, tid, nthr) - a;
    o_sz = stage_array(sz + a, sm + 2 * pad, b - a, tid, nthr) - a;
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    // -- end staged loads
    c0 = a;
    c1 = b;
  }
  // stage [a, b) unless it is the staged chunk
  __device__ __forceinline__ void need(int a, int b) {
    if (a != c0 || b != c1) load(a, b);
  }
  __device__ __forceinline__ float start(int i) const { return r_st[i + o_st]; }
  __device__ __forceinline__ float end(int i) const { return r_en[i + o_en]; }
  __device__ __forceinline__ float size(int i) const { return r_sz[i + o_sz]; }
  // any slot of the row: staged if it is, else from global memory
  __device__ __forceinline__ float start_any(int i) const {
    return i >= c0 && i < c1 ? start(i) : st[i];
  }
  __device__ __forceinline__ float end_any(int i) const {
    return i >= c0 && i < c1 ? end(i) : en[i];
  }
};

struct Verdict {
  bool feasible;
  float load;
};

// The admission geometry of one row (fleet_row.cuh's, lo = 0, hi = N),
// evaluated by the whole block; thread 0 holds the result.
__device__ Verdict admit_row(const float* st, const float* en,
                             const float* sz, int N, int h, int nk, float d,
                             float ps, float free, float eps, float* sm,
                             int chunk) {
  __shared__ int red[3][kMaxWarps];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int tail = h + nk;
  StagedRow row{st, en, sz, sm, pad_of(chunk), sm, sm, sm, 0, 0, 0, 0, 0};

  // -- the counts: searchsorted as masked counts
  unsigned c_start = 0, c_end = 0;
  for (int a = 0; a < N; a += chunk) {
    const int b = min(a + chunk, N);
    row.need(a, b);
    for (int i = a + tid; i < b; i += nthr) {
      c_start += row.start(i) < d;
      c_end += row.end(i) < d;
    }
  }
  c_start = __reduce_add_sync(kFull, c_start);
  c_end = __reduce_add_sync(kFull, c_end);
  if (lane == 0) {
    red[0][warp] = static_cast<int>(c_start);
    red[1][warp] = static_cast<int>(c_end);
  }
  __syncthreads();
  int cap_idx = 0, e_hi = 0;
  for (int w = 0; w < nwarps; ++w) {
    cap_idx += red[0][w];
    e_hi += red[1][w];
  }

  // -- the last interior gap at or before e_hi (default: head); only
  // slots in [h + 1, min(tail, e_hi + 1)) can hold it
  const int g_lo = h + 1, g_hi = min(tail, e_hi + 1);
  int gap = h;
  for (int a = 0; a < N; a += chunk) {
    const int b = min(a + chunk, N);
    if (b <= g_lo || a >= g_hi) continue;
    row.need(a, b);
    for (int i = max(a, g_lo) + tid; i < min(b, g_hi); i += nthr) {
      const float prev = i == 0 ? -kBig : row.end_any(i - 1);
      if (row.start(i) > prev) gap = max(gap, i);
    }
  }
  gap = __reduce_max_sync(kFull, gap);
  if (lane == 0) red[2][warp] = gap;
  __syncthreads();
  int prev_gap = h;
  for (int w = 0; w < nwarps; ++w) prev_gap = max(prev_gap, red[2][w]);

  // -- the insertion slot and the window's right edge
  const bool no_straddle = e_hi >= cap_idx;
  int j = no_straddle ? e_hi : prev_gap;
  const float start_j = j < tail ? row.start_any(min(j, N - 1)) : kBig;
  float cap = no_straddle ? d : fminf(start_j, d);
  if (!no_straddle && prev_gap == h) {        // front fallback
    const float start_h = nk > 0 ? row.start_any(min(h, N - 1)) : kBig;
    cap = fminf(start_h, d);
    j = h;
  }

  // -- the row's load and the prefix work ahead of the slot, one warp,
  // in fleet_row.cuh's association
  const int jw = min(j, N);
  float load = 0.0f, pw = 0.0f;
  for (int a = 0; a < N; a += chunk) {
    const int b = min(a + chunk, N);
    row.need(a, b);
    if (warp == 0) {
      for (int i = a + lane; i < b; i += 32) {
        const float v = row.size(i);
        load = __fadd_rn(load, v);
        if (i < jw) pw = __fadd_rn(pw, v);
      }
    }
  }
  Verdict r;
  r.load = fleet::warp_sum(load);
  pw = fleet::warp_sum(pw);
  r.feasible =
      (__fsub_rn(cap, __fadd_rn(free, pw)) >= __fsub_rn(ps, eps)) &&
      (cap > free) && (tail < N);
  return r;
}

__global__ void __launch_bounds__(kMaxThreads)
fleet_feasibility_kernel(const float* __restrict__ starts,   // (K, N)
                         const float* __restrict__ ends,     // (K, N)
                         const float* __restrict__ sizes,    // (K, N)
                         const int* __restrict__ n,          // (K,)
                         const int* __restrict__ head,       // (K,)
                         const float* __restrict__ ps,       // (K,)
                         const float* __restrict__ cpu_free, // (K,)
                         const float* __restrict__ d,        // (1,)
                         bool* __restrict__ feas_out,
                         float* __restrict__ load_out, int N, float eps,
                         int chunk) {
  extern __shared__ __align__(16) float sm[];
  // -- body
  const int k = blockIdx.x;
  const size_t row = static_cast<size_t>(k) * N;
  const Verdict v = admit_row(starts + row, ends + row, sizes + row, N,
                              head[k], n[k], *d, ps[k], cpu_free[k], eps, sm,
                              chunk);
  if (threadIdx.x == 0) {
    feas_out[k] = v.feasible;
    load_out[k] = v.load;
  }
  // -- end body
}

__global__ void __launch_bounds__(kMaxThreads)
link_cost_kernel(const float* __restrict__ starts,      // (K, N)
                 const float* __restrict__ ends,        // (K, N)
                 const float* __restrict__ sizes,       // (K, N)
                 const int* __restrict__ n,             // (K,)
                 const int* __restrict__ head,          // (K,)
                 const float* __restrict__ ps,          // (K,)
                 const float* __restrict__ busy,        // (K,)
                 const float* __restrict__ lat_row,     // (K,)
                 const float* __restrict__ inv_bw_row,  // (K,)
                 const float* __restrict__ d,           // (1,)
                 const float* __restrict__ t_src,       // (1,)
                 const float* __restrict__ payload,     // (1,)
                 bool* __restrict__ feas_out, float* __restrict__ arrive_out,
                 float* __restrict__ load_out, int N, float eps, int chunk) {
  extern __shared__ __align__(16) float sm[];
  // -- body
  const int k = blockIdx.x;
  // the referral's wire cost delays the arrival; admission opens at the
  // later of the arrival and the CPU's free time
  const float arrive =
      __fmaf_rn(*payload, inv_bw_row[k], __fadd_rn(*t_src, lat_row[k]));
  const float free = fmaxf(arrive, busy[k]);
  const size_t row = static_cast<size_t>(k) * N;
  const Verdict v = admit_row(starts + row, ends + row, sizes + row, N,
                              head[k], n[k], *d, ps[k], free, eps, sm, chunk);
  if (threadIdx.x == 0) {
    feas_out[k] = v.feasible;
    arrive_out[k] = arrive;
    load_out[k] = v.load;
  }
  // -- end body
}

// The launch shape of a row of N slots: the chunk staged at once, the
// block's threads (a float4 of each array a thread, 32 to 256) and its
// shared memory.
struct Shape {
  int chunk, threads;
  size_t smem;
};

Shape shape_for(int N) {
  Shape s;
  s.chunk = N < kChunk ? N : kChunk;
  const int vec = (s.chunk + 3) / 4;
  s.threads = vec >= kMaxThreads ? kMaxThreads : (vec + 31) / 32 * 32;
  s.smem = 3 * sizeof(float) * static_cast<size_t>(pad_of(s.chunk));
  return s;
}

}  // namespace

// Both launchers select the tensors' device first: this library links its
// own CUDA runtime, whose current device is not PyTorch's.
extern "C" int fleet_feasibility_launch(
    const float* starts, const float* ends, const float* sizes, const int* n,
    const int* head, const float* ps, const float* cpu_free, const float* d,
    bool* feas_out, float* load_out, int K, int N, float eps, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s = shape_for(N);
  fleet_feasibility_kernel<<<K, s.threads, s.smem, stream>>>(
      starts, ends, sizes, n, head, ps, cpu_free, d, feas_out, load_out, N,
      eps, s.chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int link_cost_launch(
    const float* starts, const float* ends, const float* sizes, const int* n,
    const int* head, const float* ps, const float* busy, const float* lat_row,
    const float* inv_bw_row, const float* d, const float* t_src,
    const float* payload, bool* feas_out, float* arrive_out, float* load_out,
    int K, int N, float eps, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s = shape_for(N);
  link_cost_kernel<<<K, s.threads, s.smem, stream>>>(
      starts, ends, sizes, n, head, ps, busy, lat_row, inv_bw_row, d, t_src,
      payload, feas_out, arrive_out, load_out, N, eps, s.chunk);
  return static_cast<int>(cudaGetLastError());
}
