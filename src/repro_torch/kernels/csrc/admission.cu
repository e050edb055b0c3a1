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
// The geometry is fleet_row.cuh's, which event_select.cu and
// event_scan.cu share.  One source holds both kernels, so the build,
// which hashes the source and the headers it includes, never loads a
// stale library for either.
//
// Bound on this card: bytes.  A launch must read the three (K, N) f32
// ledgers once (12 K N bytes) plus a few (K,) vectors and scalars, and
// write 5 K bytes (9 K for link_cost): at K = 256, N = 1024 about 3.15 MB,
// 0.94 us at 3.35 TB/s; at the fleet simulator's K = 32, N = 512 about
// 197 KB, 0.06 us.  The work is a few comparisons and adds per element.
// Design: one warp per node row, four rows per block, rows past K masked
// (the TPU version pads K to its block of 8 instead); lanes stride the
// row with coalesced loads, warp shuffles reduce the counts, the max and
// the two sums, and the three passes over the row re-read it from L1.
// At K <= 32 a launch is one to eight blocks and costs its launch latency;
// at K = 256, 64 blocks leave half the card idle, which a later PR may
// trade for more warps per row.
//
// Arithmetic matches the plain versions bit for bit: every add is an
// explicit IEEE round-to-nearest intrinsic in the plain version's
// association order (built with --fmad=false, never fast math), and the
// one multiply is the fused multiply-add of the arrival, as XLA makes it
// of the reference's jitted code and ref.py::fma32 computes it.  The sums
// pw_j and load are taken in warp-tree order: exact whenever the sizes
// are integers or dyadic, and otherwise within a relative 1e-6 of the
// plain version's; they equal event_select's bit for bit on the same row.

#include <cuda_runtime.h>

#include "fleet_row.cuh"

namespace {

constexpr int kWarps = 4;                   // node rows per block

__global__ void __launch_bounds__(kWarps * 32)
fleet_feasibility_kernel(const float* __restrict__ starts,   // (K, N)
                         const float* __restrict__ ends,     // (K, N)
                         const float* __restrict__ sizes,    // (K, N)
                         const int* __restrict__ n,          // (K,)
                         const int* __restrict__ head,       // (K,)
                         const float* __restrict__ ps,       // (K,)
                         const float* __restrict__ cpu_free, // (K,)
                         const float* __restrict__ d,        // (1,)
                         bool* __restrict__ feas_out,
                         float* __restrict__ load_out, int K, int N,
                         float eps) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= K) return;
  const size_t row = static_cast<size_t>(k) * N;
  const fleet::Row r = fleet::fleet_row(starts + row, ends + row,
                                        sizes + row, N, head[k], n[k], *d,
                                        ps[k], cpu_free[k], eps, lane, 0, N);
  if (lane == 0) {
    feas_out[k] = r.feasible;
    load_out[k] = r.load;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
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
                 float* __restrict__ load_out, int K, int N, float eps) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= K) return;
  // the referral's wire cost delays the arrival; admission opens at the
  // later of the arrival and the CPU's free time
  const float arrive =
      __fmaf_rn(*payload, inv_bw_row[k], __fadd_rn(*t_src, lat_row[k]));
  const float free = fmaxf(arrive, busy[k]);
  const size_t row = static_cast<size_t>(k) * N;
  const fleet::Row r = fleet::fleet_row(starts + row, ends + row,
                                        sizes + row, N, head[k], n[k], *d,
                                        ps[k], free, eps, lane, 0, N);
  if (lane == 0) {
    feas_out[k] = r.feasible;
    arrive_out[k] = arrive;
    load_out[k] = r.load;
  }
}

int blocks_for(int K) { return (K + kWarps - 1) / kWarps; }

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
  fleet_feasibility_kernel<<<blocks_for(K), kWarps * 32, 0, stream>>>(
      starts, ends, sizes, n, head, ps, cpu_free, d, feas_out, load_out, K,
      N, eps);
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
  link_cost_kernel<<<blocks_for(K), kWarps * 32, 0, stream>>>(
      starts, ends, sizes, n, head, ps, busy, lat_row, inv_bw_row, d, t_src,
      payload, feas_out, arrive_out, load_out, K, N, eps);
  return static_cast<int>(cudaGetLastError());
}
