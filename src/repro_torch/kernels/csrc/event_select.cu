// event_select for Hopper (sm_90a): fused next-event merge + per-node
// referral scoring for the event-time fleet simulator.
//
// Replaces the TPU kernel repro/kernels/event_select.py
// (_event_select_kernel, event_select_fwd; pallas_call at :172).  It
// computes what that kernel computes, and what the plain version
// repro_torch/kernels/ref.py::event_select_ref computes:
//
//   1. the two-way merge of the next fresh arrival (a) and the head of the
//      re-arrival buffer (b); fresh wins ties;
//   2. the selected node's network row: arrive[k] = (t + lat[node, k])
//      + payload * inv_bw[node, k] — a direct indexed load here, where the
//      TPU took a one-hot masked sum to avoid dynamic addressing;
//   3. per node row k, over its (W,) live window: the masked counts
//      cap_idx / e_hi, the interior-gap max prev_gap, the straddle and
//      front fallbacks for (j, cap), the prefix work pw_j, the verdict
//      feasible = cap - (free + pw_j) >= ps - eps && cap > free &&
//      tail < W, and load = sum(sizes).
//
// No path of the simulator launches it any more: since the fleet loop
// became one event_scan.cu launch per run, it is the entry point
// repro_torch.kernels.ops.event_select only, the counterpart of
// repro.kernels.ops.event_select.
//
// Bound on this card: bytes.  Per launch it must read the three (K, W)
// windows once (12*K*W bytes), four (K,) per-node vectors, the selected
// (K,) latency / inverse-bandwidth rows and 48 bytes of candidate scalars,
// and write 17*K + 9 bytes: about 197 KB, 59 ns at 3.35 TB/s, for K=32,
// W=512.  Its arithmetic is a few comparisons and adds per element.  At
// such shapes the launch itself (a few microseconds) dominates, so the
// design is the simple one: one warp per node row, scored by
// fleet_row.cuh (the geometry every fleet kernel shares).  The merge
// scalars are recomputed by every warp, as every Pallas grid program
// does, and block 0 writes take_fresh, t and node.
//
// Arithmetic matches the plain version bit for bit: every add and divide
// is an explicit IEEE round-to-nearest intrinsic in the plain version's
// association order (built with --fmad=false, never fast math), and the
// one multiply is the fused multiply-add arrive = fma(payload, inv_bw,
// t + lat) — what XLA's CPU compiler makes of the reference simulator's
// jitted step, and what ref.py::fma32 computes.  The two sums pw_j and
// load are taken in warp-tree order; they are exact whenever the sizes
// are integers or dyadic (the paper's services are 20/44/180 UT), and
// otherwise agree to a relative 1e-6.

#include <cuda_runtime.h>

#include "fleet_row.cuh"

namespace {

constexpr int kWarps = 4;                   // node rows per block

__global__ void __launch_bounds__(kWarps * 32)
event_select_kernel(const float* __restrict__ fs,      // (8,) t,d,p,pay of a then b
                    const int* __restrict__ is,        // (4,) node_a,avail_a,node_b,avail_b
                    const float* __restrict__ starts,  // (K, W)
                    const float* __restrict__ ends,    // (K, W)
                    const float* __restrict__ sizes,   // (K, W)
                    const int* __restrict__ n,         // (K,)
                    const int* __restrict__ head,      // (K,)
                    const float* __restrict__ speeds,  // (K,)
                    const float* __restrict__ busy,    // (K,)
                    const float* __restrict__ lat,     // (K, K)
                    const float* __restrict__ inv_bw,  // (K, K)
                    bool* __restrict__ take_out, float* __restrict__ t_out,
                    int* __restrict__ node_out, bool* __restrict__ feas_out,
                    float* __restrict__ arrive_out, int* __restrict__ j_out,
                    float* __restrict__ cap_out, float* __restrict__ load_out,
                    int K, int W, float eps) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);

  // -- the merge (same scalars in every thread)
  const bool avail_a = is[1] != 0, avail_b = is[3] != 0;
  const bool take_a = avail_a && ((fs[0] <= fs[4]) || !avail_b);
  const float t = take_a ? fs[0] : fs[4];
  const int node = take_a ? is[0] : is[2];
  const float d = take_a ? fs[1] : fs[5];
  const float p = take_a ? fs[2] : fs[6];
  const float pay = take_a ? fs[3] : fs[7];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *take_out = take_a;
    *t_out = t;
    *node_out = node;
  }
  if (k >= K) return;

  const size_t row = static_cast<size_t>(k) * W;
  // a node id outside [0, K) selects an all-zero row, as the TPU's one-hot
  // sum does; the simulator never produces one
  const bool in_range = node >= 0 && node < K;
  const float lat_v = in_range ? lat[static_cast<size_t>(node) * K + k] : 0.0f;
  const float ibw_v = in_range ? inv_bw[static_cast<size_t>(node) * K + k] : 0.0f;
  const float arrive = __fmaf_rn(pay, ibw_v, __fadd_rn(t, lat_v));
  const fleet::Row r = fleet::fleet_row(
      starts + row, ends + row, sizes + row, W, head[k], n[k], d,
      __fdiv_rn(p, speeds[k]), fmaxf(arrive, busy[k]), eps, lane, 0, W);
  if (lane == 0) {
    feas_out[k] = r.feasible;
    arrive_out[k] = arrive;
    j_out[k] = r.j;
    cap_out[k] = r.cap;
    load_out[k] = r.load;
  }
}

}  // namespace

extern "C" int event_select_launch(
    const float* fs, const int* is, const float* starts, const float* ends,
    const float* sizes, const int* n, const int* head, const float* speeds,
    const float* busy, const float* lat, const float* inv_bw, bool* take_out,
    float* t_out, int* node_out, bool* feas_out, float* arrive_out,
    int* j_out, float* cap_out, float* load_out, int K, int W, float eps,
    int device, cudaStream_t stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (K + kWarps - 1) / kWarps;
  event_select_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      fs, is, starts, ends, sizes, n, head, speeds, busy, lat, inv_bw,
      take_out, t_out, node_out, feas_out, arrive_out, j_out, cap_out,
      load_out, K, W, eps);
  return static_cast<int>(cudaGetLastError());
}
