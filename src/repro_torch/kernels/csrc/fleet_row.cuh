// The admission geometry of one ledger row, shared by every fleet kernel:
// event_select.cu, admission.cu (fleet_feasibility, link_cost) and
// event_scan.cu call fleet_row() below, so all four score a row with the
// same instructions and agree bit for bit.
//
// For one (W,) row with head h and nk live blocks ([h, h + nk) live; the
// retired prefix holds -BIG / -BIG / 0, slots past the tail +BIG / +BIG /
// 0), a request of work ps at deadline d, on a CPU free from `free`:
//
//   cap_idx  = #(starts < d), e_hi = #(ends < d)   (searchsorted as counts)
//   prev_gap = the last interior gap i in (h, h + nk) with i <= e_hi and
//              starts[i] > ends[i - 1], else h
//   (j, cap) = (e_hi, d) without a straddle (e_hi >= cap_idx), else
//              (prev_gap, min(starts[prev_gap], d)), and the front fallback
//              (h, min(starts[h], d)) when prev_gap == h
//   pw_j     = sum(sizes[0 .. j))
//   feasible = cap - (free + pw_j) >= ps - eps && cap > free && h + nk < W
//   load     = sum(sizes)
//
// This is what repro_torch/kernels/ref.py::fleet_search_ref computes.
// Evaluated by a whole warp (lanes stride the row with coalesced loads,
// shuffles reduce); every lane gets the result.  The three passes re-read
// the row from L1.
//
// The passes read [lo, hi) of the row: the whole row (0, W) for any
// input, as event_select.cu and admission.cu pass it, or only the live
// blocks (h, h + nk) of a row that keeps the head-pointer layout above,
// as event_scan.cu does.  Below lo every slot holds -BIG and above hi
// +BIG, so each count gains lo (for a deadline between -BIG and +BIG,
// which every finite one is) and the sums nothing; load is then the live
// blocks' sum.  Every add is an explicit round-to-nearest intrinsic
// (the sources build with --fmad=false); the sums pw_j and load are taken
// in warp-tree order (each lane's strided partial sum, then a butterfly of
// shuffles), exact whenever the sizes are integers or dyadic.  The row
// pointers carry no __restrict__: event_scan.cu writes the ledgers it
// scores within the same kernel, so loads must stay coherent.

#pragma once

#include <cuda_runtime.h>

namespace fleet {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

struct Row {
  bool feasible;
  int j;        // insertion slot, relative to the row
  float cap;    // the window's right edge
  float load;   // sum of the row's sizes
};

__device__ __forceinline__ Row fleet_row(const float* st, const float* en,
                                         const float* sz, int W, int h,
                                         int nk, float d, float ps,
                                         float free, float eps, int lane,
                                         int lo, int hi) {
  const int tail = h + nk;

  // -- pass 1: searchsorted as masked counts, and the row's load
  unsigned c_start = 0, c_end = 0;
  float load = 0.0f;
  for (int i = lo + lane; i < hi; i += 32) {
    c_start += st[i] < d;
    c_end += en[i] < d;
    load = __fadd_rn(load, sz[i]);
  }
  const int cap_idx =
      lo + static_cast<int>(__reduce_add_sync(kFull, c_start));
  const int e_hi = lo + static_cast<int>(__reduce_add_sync(kFull, c_end));
  load = warp_sum(load);

  // -- pass 2: the last interior gap at or before e_hi (default: head)
  int gap = h;
  for (int i = lo + lane; i < hi; i += 32) {
    const float prev = i == 0 ? -kBig : en[i - 1];
    if (st[i] > prev && i >= h + 1 && i < tail && i <= e_hi) gap = max(gap, i);
  }
  const int prev_gap = __reduce_max_sync(kFull, gap);

  // -- the insertion slot and the window's right edge
  const bool no_straddle = e_hi >= cap_idx;
  int j = no_straddle ? e_hi : prev_gap;
  const float start_j = j < tail ? st[min(j, W - 1)] : kBig;
  float cap = no_straddle ? d : fminf(start_j, d);
  if (!no_straddle && prev_gap == h) {        // front fallback
    const float start_h = nk > 0 ? st[min(h, W - 1)] : kBig;
    cap = fminf(start_h, d);
    j = h;
  }

  // -- pass 3: prefix work ahead of the slot
  float pw = 0.0f;
  const int jw = min(j, hi);
  for (int i = lo + lane; i < jw; i += 32) pw = __fadd_rn(pw, sz[i]);
  pw = warp_sum(pw);

  Row r;
  r.feasible = (__fsub_rn(cap, __fadd_rn(free, pw)) >= __fsub_rn(ps, eps)) &&
               (cap > free) && (tail < W);
  r.j = j;
  r.cap = cap;
  r.load = load;
  return r;
}

}  // namespace fleet
