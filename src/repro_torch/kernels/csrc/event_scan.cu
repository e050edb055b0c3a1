// event_scan for Hopper (sm_90a): a whole event-time fleet simulation in
// one launch.
//
// Replaces the TPU kernel repro/kernels/event_select.py
// (_event_select_kernel at :43, event_select_fwd; pallas_call at :172)
// together with the loop around it, the reference's jax.lax.scan over
// _estep (repro/fleetsim/core.py:570), the threefry draws of its
// stochastic routing policies (_route_next, core.py:246-263, with the
// keys of :393 and :553), the carried half of its telemetry cube
// (core.py:472-489), and the jax.vmap of simulate_fn over sweep cells
// (core.py:729-777).  The eager loop of repro_torch/fleetsim/core.py
// (_estep) is its plain version: same events, same order, same
// arithmetic.  One block runs one run, a sweep cell: it owns the event
// loop and stops at the first step with no live event or after
// max_events steps, then drains the ledgers.  The grid is one block per
// cell; in a sweep (kSweep) a block offsets every buffer by its cell
// (for_cell), reading the request table and the network at a cell
// stride of 0 where the cells share them.  A single run launches the
// instantiation without the offsets, which reads every pointer from the
// launch's parameters: the offset pointers, held in registers, take a
// sweep's block from 56 to 64 registers a thread and each of its steps
// 2-4% longer.  Each step, in _estep's order:
//
//   merge    thread 0: the fresh arrival at the cursor against the head
//            of the re-arrival buffer; fresh wins ties.  The merge has
//            this one owner; every later stage reads the selected event.
//   retire   one thread per node pops its own chain of heads due strictly
//            before t (busy < t && nq > 0): the slot turns -BIG / -BIG /
//            0, completion[slot_rid] = busy + size, load -= size.  The
//            step's retire iterations are the most pops of any node.
//   score    batched_feasible: one warp per node row (rows round-robin
//            over the 32 warps) scores its live window [w0, w0 + W),
//            w0 = clamp(head, 0, N - W), from max(arrive, busy) with
//            arrive = fma(payload, inv_bw[cur, k], t + lat[cur, k]),
//            through fleet_row.cuh (event_select's geometry, shared),
//            reading only the live blocks [head, head + nq): the rest of
//            the window is -BIG below and +BIG above by construction.
//            The other policies score the event's node only, from
//            max(t, busy), as ref.py::fleet_search_ref does.
//   decide   warp 0: forward while hops < max_forwards and the node has
//            neighbours, else discard or force; route (trace: max(row[
//            min(hop, M - 1)], 0); round_robin: the first neighbour from
//            the pointer, advanced only on a forward; least_loaded and
//            batched_feasible: argmin of load, ties to the lowest id;
//            random and power_of_two: lane 0 draws from JAX's threefry,
//            bit for bit (threefry.cuh), the key fold_in(fold_in(
//            PRNGKey(seed), rid), hop): random takes neighbours[cur,
//            min(int(u * deg), deg - 1)]; power_of_two splits the key,
//            draws a second index over deg - 1 shifted past the first,
//            and takes the less loaded of the two (ties to the first;
//            deg <= 1: neighbours[cur, 0]).  The draws are a few hundred
//            integer operations on one lane for each event that may
//            forward (hops < max_forwards), then one __fmul_rn and a
//            truncation per index);
//            push the re-arrival at t + fma(payload, inv_bw, lat) (t when
//            unpriced) by a stable sorted insert at #(keys <= key), or
//            count it into ev_dropped when the buffer is full; write the
//            terminal record and the event node's nq / load / busy; with
//            telemetry (the kTel instantiation; the other is the code
//            without it), lane 0 bins the event, b = (int) fminf(fmaxf(
//            __fmul_rn(t, 1 / w), 0), NB - 1) (the compiled reference's
//            t / w: XLA multiplies by the f32 reciprocal of the constant
//            width), adds its five kinds (fresh arrival, re-arrival,
//            forward, discard or overflow, admission) at [cur, b] and
//            maxes occupancy[b] with the ring's live count after the
//            push.
//   insert   all threads, when the request queues at a busy node: the
//            closed-form cascade of core/torch_queue.py::insert_at.  A
//            feasible insert right-aligns the block at cap and moves each
//            earlier live block i to end at min(end_i, new_start -
//            between_i), between_i the work between it and the slot; the
//            blocks from the slot to the tail shift right by one.  A
//            forced request appends at the tail.  An idle CPU starts the
//            request at t + ps without entering the ledger.
//
// State: the per-node scalars (head, nq, busy, load, speed, degree, the
// step's verdict, slot and edge) and the selected event live in shared
// memory; so does the re-arrival buffer, a ring of (time, rid, meta),
// where it fits beside them (12 B bytes), else in global scratch.  The
// (K, N) ledgers, slot_rid, completion, reqinfo and transfer live in
// global memory and stay L2-resident at the simulator's sizes (<= 0.5 MB
// a cell for K = 32, N = 1024; 32 cells of K = 3, N = 4096 hold 6.4 MB of
// the 50 MB L2), as does the telemetry cube (K x NB x 5 counters and NB
// high-water marks a cell).
//
// Bound on this card: bytes per step, and the chain between steps.  A
// batched_feasible step must read every node's live blocks (12 bytes a
// block; counts[5] sums them over the run), the per-node vectors and the
// event node's network and adjacency rows (29 K bytes) and the request's
// row, and write a few words: at most 197 KB, 59 ns at 3.35 TB/s, at
// K = 32, W = 512, and far less at the simulator's loads.  But step s + 1
// reads what step s wrote (the ledgers, the buffer, the per-node
// scalars), so the steps form one serial chain: each pays its barriers
// (4 to 6 __syncthreads) and its dependent L2 round trips, which no
// bandwidth removes.  The design therefore keeps every scalar of the
// chain in shared memory, reads a request's row as one 16-byte vector,
// scores only live blocks, gives the wide stages (scoring, the cascade,
// the retire) the whole block, and leaves the narrow ones (merge, route,
// push, the telemetry update) to one warp or thread without a barrier.
// No chain crosses cells, so a sweep's cells run side by side, one block
// an SM (56-64 registers a thread leave room for one 1,024-thread
// block): a launch of C <= 132 cells takes about as long as its longest
// cell.
//
// Arithmetic matches the eager loop bit for bit on the simulator's runs:
// each operation is the eager step's, as an explicit round-to-nearest
// intrinsic (built with --fmad=false): ps = p / speed (__fdiv_rn); the
// wire delay one fused multiply-add fma(payload, inv_bw, lat) (ref.py::
// fma32, as XLA contracts the reference), then t + delay; busy + size in
// pop order; c_now = t + ps; the f32 -1e30 sentinels (torch_queue.BIG).
// Three sums are taken in another order than PyTorch's: pw_j and load in
// fleet_row.cuh's warp-tree order, and the cascade's between_i as a block
// scan from the slot down (per warp a shuffle scan, then the warps'
// totals); all three are exact, and so equal, whenever the sizes are
// integers or dyadic, as in every golden run.

#include <cuda_runtime.h>

#include <climits>

#include <math_constants.h>

#include "fleet_row.cuh"
#include "threefry.cuh"

// A launch, as event_scan.py's _ScanArgs lays it out field for field: the
// pointers are cell 0's, and every output holds C cells back to back.
struct ScanArgs {
  // the run (read only)
  const float* cols;     // (R, 4) arrival, d_abs, proc, payload
  const int* origin;     // (R,)
  const int* targets;    // (R, M) recorded choices (trace)
  const bool* adj;       // (K, K)
  const int* degree;     // (K,)
  const float* speeds;   // (K,)
  const float* lat;      // (K, K), zeros for an unpriced run
  const float* inv_bw;   // (K, K)
  const int* neighbors;  // (K, D) ascending, padded with the own id
  // the final EventState (written whole by the kernel)
  float* starts;         // (K, N)
  float* ends;           // (K, N)
  float* sizes;          // (K, N)
  int* slot_rid;         // (K, N)
  int* head;             // (K,)
  int* nq;               // (K,)
  float* busy;           // (K,)
  float* load;           // (K,)
  int* rr;               // (1,)
  float* ev_time;        // (B,) sorted, +BIG past ev_n
  int* ev_rid;           // (B,)
  int* ev_meta;          // (B,)
  int* ev_n;             // (1,)
  int* ev_dropped;       // (1,)
  int* sat_events;       // (1,)
  float* completion;     // (R + 1,)
  int* reqinfo;          // (R,)
  float* transfer;       // (R,)
  long long* counts;     // (6,) events, retire iterations, unprocessed,
                         //      cursor, error, live blocks scored
  // the re-arrival ring when it does not fit in shared memory, else null
  float* ring_time;      // (B,)
  int* ring_rid;         // (B,)
  int* ring_meta;        // (B,)
  // the carried telemetry cube (the kTel instantiation), else null
  int* tel_counts;       // (K, NB, 5) event kinds per node and bucket
  int* tel_occ;          // (NB,) the ring's live-count high water
  const unsigned* seeds; // (C,) each cell's PRNGKey seed (random,
                         //      power_of_two)
  long long cols_cell;   // cols' cell stride: R * 4, or 0 (shared)
  long long net_cell;    // lat's and inv_bw's: K * K, or 0 (shared)
  int R, K, N, W, B, M, D, E;
  int max_forwards, hop_bits, policy, discard, priced, ring_in_shared;
  int NB;                // telemetry buckets
  float eps;
  float tel_inv_w;       // f32(1 / telemetry bucket width)
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = fleet::kBig;
constexpr unsigned kFull = fleet::kFull;

// routing policies, as event_scan.py numbers them (0: least_loaded)
constexpr int kRoundRobin = 1, kBatched = 2, kTrace = 3, kRandom = 4,
              kPowerOfTwo = 5;
// the packed terminal record (fleetsim/core.py)
constexpr int kInfoDisc = 1 << 8, kInfoOvf = 1 << 9, kInfoServed = 10;
// counts[]: what the host reads after the launch
constexpr int kEvents = 0, kRetire = 1, kUnprocessed = 2, kCursor = 3,
              kError = 4, kScored = 5, kCounts = 6;
// telemetry event kinds (telemetry/timeline.py); a cube cell is 5 ints
constexpr int kKinds = 5;
// errors: a node id outside [0, K) (an origin; a forwarding target)
constexpr int kBadOrigin = 1, kBadTarget = 2;

// the selected event and the loop's scalars (thread 0 / lane 0 write)
struct Loop {
  int live, fresh, rid, cur, hops;
  float t, d, p, pay;
  int cursor, ring_head, ring_n, rr, dropped, sat, events, retire, error;
  int max_pops;
  unsigned seed;         // the cell's PRNGKey seed
};

// what the cascade at the event's node needs (warp 0 writes)
struct Insert {
  int queue_it, feasible, rid, hrel, jj, tail;
  long long base;        // cur * N + w0
  float new_start, right, ps;
};

struct Shared {          // the per-node arrays, carved from dynamic memory
  int *head, *nq, *degree, *j;
  float *busy, *load, *speed, *cap;
  unsigned char* feas;
  float* ring_time;
  int *ring_rid, *ring_meta;
};

__device__ __forceinline__ int ring_at(int head, int l, int B) {
  const int p = head + l;
  return p >= B ? p - B : p;
}

// Pop every head due strictly before t (the drain passes +inf); each
// node's chain is its own thread's.  max_pops collects the step's retire
// iterations.
__device__ __forceinline__ void retire(const ScanArgs& a, const Shared& s,
                                       float t, int* max_pops) {
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    int h = s.head[k], q = s.nq[k], pops = 0;
    float b = s.busy[k], l = s.load[k];
    const long long row = static_cast<long long>(k) * a.N;
    while (b < t && q > 0) {
      const long long f = row + min(h, a.N - 1);
      const float hs = a.sizes[f];
      b = __fadd_rn(b, hs);
      a.completion[a.slot_rid[f]] = b;
      a.starts[f] = -kBig;
      a.ends[f] = -kBig;
      a.sizes[f] = 0.0f;
      ++h;
      --q;
      l = __fsub_rn(l, hs);
      ++pops;
    }
    if (pops > 0) {
      s.head[k] = h;
      s.nq[k] = q;
      s.busy[k] = b;
      s.load[k] = l;
      atomicMax(max_pops, pops);
    }
  }
}

// Row k scored over its live window from `free`, by one warp; the
// verdict, slot and edge go to shared memory, and lane 0 adds the live
// blocks it read to *scored.
__device__ __forceinline__ void score_row(const ScanArgs& a, const Shared& s,
                                          const Loop& ev, int k, float free,
                                          long long* scored) {
  const int lane = threadIdx.x & 31;
  const int h = s.head[k];
  const int w0 = min(max(h, 0), a.N - a.W);
  const long long row = static_cast<long long>(k) * a.N + w0;
  const int hrel = h - w0, tail = hrel + s.nq[k];
  const fleet::Row r = fleet::fleet_row(
      a.starts + row, a.ends + row, a.sizes + row, a.W, hrel, s.nq[k], ev.d,
      __fdiv_rn(ev.p, s.speed[k]), free, a.eps, lane, hrel, tail);
  if (lane == 0) {
    s.feas[k] = r.feasible;
    s.j[k] = r.j;
    s.cap[k] = r.cap;
    *scored += s.nq[k];
  }
}

// batched_feasible: every row, one warp per row (rows round-robin over
// the warps), each node from max(arrive, busy) at the event's wire-delayed
// arrival; the other policies: the event node's row, by warp 0, from
// max(t, busy).
__device__ __forceinline__ void score(const ScanArgs& a, const Shared& s,
                                      const Loop& ev, long long* scored) {
  const int warp = threadIdx.x >> 5;
  if (a.policy != kBatched) {
    if (warp == 0)
      score_row(a, s, ev, ev.cur, fmaxf(ev.t, s.busy[ev.cur]), scored);
    return;
  }
  for (int k = warp; k < a.K; k += kWarps) {
    const long long nk = static_cast<long long>(ev.cur) * a.K + k;
    const float arrive = __fmaf_rn(ev.pay, a.inv_bw[nk],
                                   __fadd_rn(ev.t, a.lat[nk]));
    score_row(a, s, ev, k, fmaxf(arrive, s.busy[k]), scored);
  }
}

// argmin over k < K of (take(k) ? load[k] : inf), ties to the lowest id,
// as torch.argmin; every lane of the warp gets it.
template <typename Take>
__device__ __forceinline__ int warp_argmin(const Shared& s, int K,
                                           Take take) {
  const int lane = threadIdx.x & 31;
  float v = CUDART_INF_F;
  int idx = INT_MAX;
  for (int k = lane; k < K; k += 32) {
    const float x = take(k) ? s.load[k] : CUDART_INF_F;
    if (idx == INT_MAX || x < v) {
      v = x;
      idx = k;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov < v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  return idx;
}

// random / power_of_two: the reference's draw for the event (one thread).
__device__ __forceinline__ int draw(const ScanArgs& a, const Shared& s,
                                    const Loop& ev) {
  using namespace threefry;
  const int deg = s.degree[ev.cur];
  const int* nb = a.neighbors + static_cast<long long>(ev.cur) * a.D;
  const Key kh = fold_in(fold_in(prng_key(ev.seed), ev.rid), ev.hops);
  if (a.policy == kRandom) return nb[scaled_index(uniform(kh), deg)];
  if (deg <= 1) return nb[0];
  Key k1, k2;
  split(kh, &k1, &k2);
  const int i1 = scaled_index(uniform(k1), deg);
  int i2 = scaled_index(uniform(k2), deg - 1);
  if (i2 >= i1) ++i2;                     // sampling without replacement
  const int x = nb[i1], y = nb[min(i2, deg - 1)];
  return s.load[x] <= s.load[y] ? x : y;
}

// The forwarding target of the event at node cur (warp 0, every lane);
// *rr_adv is the round-robin pointer after a forward.
__device__ __forceinline__ int route(const ScanArgs& a, const Shared& s,
                                     const Loop& ev, int* rr_adv) {
  const int lane = threadIdx.x & 31;
  const int K = a.K, cur = ev.cur;
  const bool* adj = a.adj + static_cast<long long>(cur) * K;
  *rr_adv = ev.rr;
  if (a.policy == kTrace) {
    const int m = min(ev.hops, a.M - 1);
    return max(a.targets[static_cast<long long>(ev.rid) * a.M + m], 0);
  }
  if (a.policy == kRandom || a.policy == kPowerOfTwo) {
    int nxt = 0;
    if (lane == 0) nxt = draw(a, s, ev);
    return __shfl_sync(kFull, nxt, 0);
  }
  if (a.policy == kRoundRobin) {
    // probe rr, rr + 1, ... (mod K); the first neighbour wins (none: rr)
    int off = 0;
    for (int base = 0; base < K; base += 32) {
      const int i = base + lane;
      const unsigned hit =
          __ballot_sync(kFull, i < K && adj[(ev.rr + i) % K]);
      if (hit) {
        off = base + __ffs(hit) - 1;
        break;
      }
    }
    *rr_adv = (ev.rr + off + 1) % K;
    return (ev.rr + off) % K;
  }
  if (a.policy == kBatched) {
    // the least-loaded neighbour that can still admit, else the least
    // loaded neighbour
    bool any = false;
    for (int base = 0; base < K && !any; base += 32) {
      const int k = base + lane;
      any = __any_sync(kFull, k < K && adj[k] && s.feas[k]);
    }
    if (any)
      return warp_argmin(s, K, [&](int k) { return adj[k] && s.feas[k]; });
  }
  return warp_argmin(s, K, [&](int k) { return adj[k]; });
}

// Stable sorted insert of (key, rid, meta) at #(live keys <= key) (warp
// 0, every lane); a full ring counts the push as dropped.
__device__ __forceinline__ void push(const Shared& s, Loop& ev, int B,
                                     float key, int rid, int meta) {
  const int lane = threadIdx.x & 31;
  const int n = ev.ring_n, h = ev.ring_head;
  if (n >= B) {
    if (lane == 0) ++ev.dropped;
    return;
  }
  int pos = 0;
  if (lane == 0) {                  // the live keys are sorted: upper bound
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.ring_time[ring_at(h, mid, B)] <= key) lo = mid + 1;
      else hi = mid;
    }
    pos = lo;
  }
  pos = __shfl_sync(kFull, pos, 0);
  // move [pos, n) up by one, 32 entries at a time from the top
  for (int top = n - 1; top >= pos; top -= 32) {
    const int l = top - lane;
    float tv = 0.0f;
    int rv = 0, mv = 0;
    if (l >= pos) {
      const int p = ring_at(h, l, B);
      tv = s.ring_time[p];
      rv = s.ring_rid[p];
      mv = s.ring_meta[p];
    }
    __syncwarp();
    if (l >= pos) {
      const int p = ring_at(h, l + 1, B);
      s.ring_time[p] = tv;
      s.ring_rid[p] = rv;
      s.ring_meta[p] = mv;
    }
    __syncwarp();
  }
  if (lane == 0) {
    const int p = ring_at(h, pos, B);
    s.ring_time[p] = key;
    s.ring_rid[p] = rid;
    s.ring_meta[p] = meta;
    ev.ring_n = n + 1;
  }
  __syncwarp();
}

// The carried telemetry of one event (one thread, after the push): its
// five kinds at [cur, bucket of t], and the ring's live count into the
// bucket's high water.
__device__ __forceinline__ void record(const ScanArgs& a, const Loop& ev,
                                       bool fwd, bool drop, bool admitted) {
  const float x = fminf(fmaxf(__fmul_rn(ev.t, a.tel_inv_w), 0.0f),
                        static_cast<float>(a.NB - 1));
  const int b = static_cast<int>(x);
  int* c = a.tel_counts + (static_cast<long long>(ev.cur) * a.NB + b) *
                              kKinds;
  c[0] += ev.fresh;
  c[1] += !ev.fresh;
  c[2] += fwd;
  c[3] += drop;
  c[4] += admitted;
  a.tel_occ[b] = max(a.tel_occ[b], ev.ring_n);
}

// decide, route, push, and the event node's bookkeeping (warp 0)
template <bool kTel>
__device__ __forceinline__ void decide(const ScanArgs& a, const Shared& s,
                                       Loop& ev, Insert& ins) {
  const int lane = threadIdx.x & 31;
  const int cur = ev.cur, rid = ev.rid, hops = ev.hops, K = a.K;
  const float t = ev.t;
  const bool ok = s.feas[cur];
  const float busy_c = s.busy[cur];
  const float cpu_free = fmaxf(t, busy_c);
  const float ps = __fdiv_rn(ev.p, s.speed[cur]);
  const bool fwd_path = hops < a.max_forwards && s.degree[cur] > 0;
  const bool fwd = fwd_path && !ok;
  const bool disc = !fwd_path && a.discard && !ok;
  const bool forced = !fwd_path && !a.discard && !ok;

  if (fwd_path) {
    int rr_adv;
    const int nxt = route(a, s, ev, &rr_adv);
    if (nxt < 0 || nxt >= K) {            // a target off the fleet
      if (lane == 0) ev.error = kBadTarget;
      return;
    }
    const long long cn = static_cast<long long>(cur) * K + nxt;
    float delay = 0.0f, key = t;
    if (a.priced) {
      delay = __fmaf_rn(ev.pay, a.inv_bw[cn], a.lat[cn]);
      key = __fadd_rn(t, delay);
    }
    __syncwarp();
    if (fwd) push(s, ev, a.B, key, rid, (nxt << a.hop_bits) | (hops + 1));
    if (lane == 0) {
      if (a.priced)
        a.transfer[rid] = __fadd_rn(a.transfer[rid], fwd ? delay : 0.0f);
      if (a.policy == kRoundRobin && fwd) ev.rr = rr_adv;
    }
  }
  if (lane != 0) return;

  // -- admission at cur, within its window (torch_queue.insert_at)
  const int h = s.head[cur], q = s.nq[cur];
  const int w0 = min(max(h, 0), a.N - a.W);
  const int hrel = h - w0, tail = hrel + q;
  const bool room = tail < a.W;
  const bool forced_ok = forced && room;
  const bool admitted = ok || forced_ok;
  const bool idle = busy_c < t;
  const long long base = static_cast<long long>(cur) * a.N + w0;
  const float tail_end =
      q > 0 ? a.ends[base + min(max(tail - 1, 0), a.W - 1)] : cpu_free;
  const float right = ok ? s.cap[cur] : __fadd_rn(tail_end, ps);
  const bool queue_it = admitted && !idle, start_now = admitted && idle;
  const float c_now = __fadd_rn(t, ps);
  ins.queue_it = queue_it;
  ins.feasible = ok;
  ins.rid = rid;
  ins.hrel = hrel;
  ins.jj = ok ? s.j[cur] : tail;
  ins.tail = tail;
  ins.base = base;
  ins.new_start = __fsub_rn(right, ps);
  ins.right = right;
  ins.ps = ps;

  // -- the packed terminal record and the per-node / per-request writes
  bool terminal = admitted;
  int info = (admitted ? (cur + 1) << kInfoServed : 0) + hops;
  if (disc) {
    terminal = true;
    info += kInfoDisc;
  }
  if (forced && !room) {
    terminal = true;
    info += kInfoOvf;
  }
  if (terminal) a.reqinfo[rid] = info;
  if (start_now) a.completion[rid] = c_now;
  s.nq[cur] = q + queue_it;
  s.load[cur] = __fadd_rn(s.load[cur], queue_it ? ps : 0.0f);
  s.busy[cur] = start_now ? c_now : busy_c;
  ev.sat += tail >= a.W;
  if (kTel) record(a, ev, fwd, disc || (forced && !room), admitted);
}

// The cascade at the event's node (all threads; ins.queue_it).  Chunks of
// the block walk [hrel, tail] from the top, so the right shift reads
// element i - 1 before any thread writes it, and the scan's carry (the
// work above the chunk, below the slot) flows down.
__device__ __forceinline__ void insert(const ScanArgs& a, const Insert& ins,
                                       float* warp_tot, float* warp_excl,
                                       float* chunk_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* st = a.starts + ins.base;
  float* en = a.ends + ins.base;
  float* sz = a.sizes + ins.base;
  int* sr = a.slot_rid + ins.base;
  if (!ins.feasible) {            // forced: append after the tail
    if (tid == 0) {
      st[ins.tail] = ins.new_start;
      en[ins.tail] = ins.right;
      sz[ins.tail] = ins.ps;
      sr[ins.tail] = ins.rid;
    }
    return;
  }
  const int jj = ins.jj;
  float carry = 0.0f;
  for (int hi = ins.tail; hi >= ins.hrel; hi -= kThreads) {
    const int i = hi - tid;
    const bool act = i >= ins.hrel;
    const bool before = act && i < jj, shifted = act && i > jj;
    float ei = 0.0f, zv = 0.0f, sv = 0.0f;
    int rv = 0;
    if (before) {
      ei = en[i];
      zv = sz[i];
    } else if (shifted) {
      sv = st[i - 1];
      ei = en[i - 1];
      zv = sz[i - 1];
      rv = sr[i - 1];
    }
    // between_i: the sizes strictly between i and the slot, an exclusive
    // scan in thread order (thread 0 holds the chunk's top)
    const float x = before ? zv : 0.0f;
    float incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, y);
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const float w = lane < kWarps ? warp_tot[lane] : 0.0f;
      float wi = w;
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi = __fadd_rn(wi, y);
      }
      const float we = __shfl_up_sync(kFull, wi, 1);
      warp_excl[lane] = lane == 0 ? 0.0f : we;
      if (lane == 31) *chunk_tot = wi;
    }
    __syncthreads();
    if (before) {
      const float between = __fadd_rn(carry, __fadd_rn(warp_excl[warp], excl));
      const float bound = __fsub_rn(ins.new_start, between);
      const float ne = fminf(ei, bound);
      en[i] = ne;
      st[i] = __fsub_rn(ne, zv);
    } else if (act && i == jj) {
      st[i] = ins.new_start;
      en[i] = ins.right;
      sz[i] = ins.ps;
      sr[i] = ins.rid;
    } else if (shifted) {
      st[i] = sv;
      en[i] = ei;
      sz[i] = zv;
      sr[i] = rv;
    }
    carry = __fadd_rn(carry, *chunk_tot);
  }
}

// The launch's arguments moved to cell c: each output by its cell's
// extent, cols and the network by their cell strides (0 when shared).
__device__ __forceinline__ ScanArgs for_cell(ScanArgs a, int c) {
  const long long K = a.K, KN = K * a.N, B = a.B, R = a.R;
  a.cols += c * a.cols_cell;
  a.lat += c * a.net_cell;
  a.inv_bw += c * a.net_cell;
  a.starts += c * KN;
  a.ends += c * KN;
  a.sizes += c * KN;
  a.slot_rid += c * KN;
  a.head += c * K;
  a.nq += c * K;
  a.busy += c * K;
  a.load += c * K;
  a.rr += c;
  a.ev_time += c * B;
  a.ev_rid += c * B;
  a.ev_meta += c * B;
  a.ev_n += c;
  a.ev_dropped += c;
  a.sat_events += c;
  a.completion += c * (R + 1);
  a.reqinfo += c * R;
  a.transfer += c * R;
  a.counts += c * kCounts;
  if (!a.ring_in_shared) {
    a.ring_time += c * B;
    a.ring_rid += c * B;
    a.ring_meta += c * B;
  }
  if (a.tel_counts != nullptr) {
    a.tel_counts += c * K * a.NB * kKinds;
    a.tel_occ += c * static_cast<long long>(a.NB);
  }
  return a;
}

template <bool kTel, bool kSweep>
__global__ void __launch_bounds__(kThreads, 1)
event_scan_kernel(const ScanArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Loop ev;
  __shared__ Insert ins;
  __shared__ float warp_tot[kWarps], warp_excl[32], chunk_tot;

  const ScanArgs a = kSweep ? for_cell(args, blockIdx.x) : args;
  const int tid = threadIdx.x;
  const int K = a.K, B = a.B, R = a.R;
  Shared s;
  unsigned char* p = smem;
  s.head = reinterpret_cast<int*>(p);
  s.nq = s.head + K;
  s.degree = s.nq + K;
  s.j = s.degree + K;
  s.busy = reinterpret_cast<float*>(s.j + K);
  s.load = s.busy + K;
  s.speed = s.load + K;
  s.cap = s.speed + K;
  s.feas = reinterpret_cast<unsigned char*>(s.cap + K);
  p = s.feas + ((K + 3) & ~3);
  if (a.ring_in_shared) {
    s.ring_time = reinterpret_cast<float*>(p);
    s.ring_rid = reinterpret_cast<int*>(s.ring_time + B);
    s.ring_meta = s.ring_rid + B;
  } else {
    s.ring_time = a.ring_time;
    s.ring_rid = a.ring_rid;
    s.ring_meta = a.ring_meta;
  }

  // -- the initial state: empty ledgers, idle nodes, nothing recorded
  const long long KN = static_cast<long long>(K) * a.N;
  for (long long i = tid; i < KN; i += blockDim.x) {
    a.starts[i] = kBig;
    a.ends[i] = kBig;
    a.sizes[i] = 0.0f;
    a.slot_rid[i] = 0;
  }
  for (int i = tid; i <= R; i += blockDim.x) a.completion[i] = 0.0f;
  for (int i = tid; i < R; i += blockDim.x) {
    a.reqinfo[i] = 0;
    a.transfer[i] = 0.0f;
  }
  for (int k = tid; k < K; k += blockDim.x) {
    s.head[k] = 0;
    s.nq[k] = 0;
    s.degree[k] = a.degree[k];
    s.busy[k] = 0.0f;
    s.load[k] = 0.0f;
    s.speed[k] = a.speeds[k];
  }
  if (kTel) {
    const long long cube = static_cast<long long>(K) * a.NB * kKinds;
    for (long long i = tid; i < cube; i += blockDim.x) a.tel_counts[i] = 0;
    for (int i = tid; i < a.NB; i += blockDim.x) a.tel_occ[i] = 0;
  }
  if (tid == 0) {
    ev.cursor = ev.ring_head = ev.ring_n = ev.rr = 0;
    ev.dropped = ev.sat = ev.events = ev.retire = ev.error = 0;
    ev.seed = a.seeds[blockIdx.x];
    a.counts[kScored] = 0;
  }
  long long scored = 0;     // live blocks this warp's lane 0 has scored
  __syncthreads();

  const int hop_mask = (1 << a.hop_bits) - 1;
  for (int step = 0; step < a.E; ++step) {
    // -- merge (thread 0): the next fresh arrival vs the ring's head
    if (tid == 0) {
      const int ci = ev.cursor;
      const bool avail_a = ci < R, avail_b = ev.ring_n > 0;
      ev.live = avail_a || avail_b;
      if (ev.live) {
        // a request's row (arrival, d_abs, proc, payload) in one load
        const float4* rows = reinterpret_cast<const float4*>(a.cols);
        const int rh = ev.ring_head;
        const float t_b = avail_b ? s.ring_time[rh] : kBig;
        const float4 fa = avail_a ? rows[ci] : make_float4(0, 0, 0, 0);
        const bool take = avail_a && (fa.x <= t_b || !avail_b);
        float4 row;
        ev.fresh = take;
        if (take) {
          row = fa;
          ev.rid = ci;
          ev.cur = a.origin[ci];
          ev.hops = 0;
          ev.t = fa.x;
          ev.cursor = ci + 1;
        } else {
          const int meta = s.ring_meta[rh];
          ev.rid = s.ring_rid[rh];
          row = rows[ev.rid];
          ev.cur = meta >> a.hop_bits;
          ev.hops = meta & hop_mask;
          ev.t = t_b;
          ev.ring_head = rh + 1 == B ? 0 : rh + 1;
          ev.ring_n -= 1;
        }
        ev.d = row.y;
        ev.p = row.z;
        ev.pay = row.w;
        ev.max_pops = 0;
        ev.events += 1;
        if (ev.cur < 0 || ev.cur >= K) {
          ev.error = kBadOrigin;
          ev.live = 0;
        }
      }
    }
    __syncthreads();
    if (!ev.live) break;

    // -- retire, then score on the post-retire ledgers
    retire(a, s, ev.t, &ev.max_pops);
    __syncthreads();
    score(a, s, ev, &scored);
    __syncthreads();

    // -- decide, route, push, record (warp 0)
    if (tid < 32) {
      decide<kTel>(a, s, ev, ins);
      if (tid == 0) ev.retire += ev.max_pops;
    }
    __syncthreads();
    if (ev.error) break;

    // -- the cascade, when the request queues
    if (ins.queue_it) insert(a, ins, warp_tot, warp_excl, &chunk_tot);
  }
  __syncthreads();

  // -- events left at max_events, then the drain
  if (tid == 0) {
    a.counts[kUnprocessed] = (R - ev.cursor) + ev.ring_n;
    ev.max_pops = 0;
  }
  __syncthreads();
  if (!ev.error) retire(a, s, CUDART_INF_F, &ev.max_pops);
  if ((tid & 31) == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counts + kScored),
              static_cast<unsigned long long>(scored));
  __syncthreads();

  // -- the final EventState, the ring laid out from its head
  for (int k = tid; k < K; k += blockDim.x) {
    a.head[k] = s.head[k];
    a.nq[k] = s.nq[k];
    a.busy[k] = s.busy[k];
    a.load[k] = s.load[k];
  }
  for (int l = tid; l < B; l += blockDim.x) {
    const bool live = l < ev.ring_n;
    const int q = ring_at(ev.ring_head, live ? l : 0, B);
    a.ev_time[l] = live ? s.ring_time[q] : kBig;
    a.ev_rid[l] = live ? s.ring_rid[q] : 0;
    a.ev_meta[l] = live ? s.ring_meta[q] : 0;
  }
  if (tid == 0) {
    *a.rr = ev.rr;
    *a.ev_n = ev.ring_n;
    *a.ev_dropped = ev.dropped;
    *a.sat_events = ev.sat;
    a.counts[kEvents] = ev.events;
    a.counts[kRetire] = ev.retire + ev.max_pops;
    a.counts[kCursor] = ev.cursor;
    a.counts[kError] = ev.error;
  }
}

// The dynamic shared memory of a launch over K nodes (nine (K,) arrays)
// with a ring of B entries held there or not (event_scan.py::shared_bytes).
int shared_bytes(int K, int B, bool ring_in_shared) {
  return 32 * K + ((K + 3) & ~3) + (ring_in_shared ? 12 * B : 0);
}

// One block per cell, with or without the telemetry carry and the
// per-cell offsets.
template <bool kTel, bool kSweep>
int launch(const ScanArgs& args, int cells, cudaStream_t stream) {
  const int bytes = shared_bytes(args.K, args.B, args.ring_in_shared);
  cudaError_t err = cudaFuncSetAttribute(
      event_scan_kernel<kTel, kSweep>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  event_scan_kernel<kTel, kSweep><<<cells, kThreads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Selects the tensors' device first: this library links its own CUDA
// runtime, whose current device is not PyTorch's.  telemetry picks the
// instantiation that carries the cube.
extern "C" int event_scan_launch(const ScanArgs* args, int cells,
                                 int telemetry, int device,
                                 cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cells > 1)
    return telemetry ? launch<true, true>(*args, cells, stream)
                     : launch<false, true>(*args, cells, stream);
  return telemetry ? launch<true, false>(*args, cells, stream)
                   : launch<false, false>(*args, cells, stream);
}
