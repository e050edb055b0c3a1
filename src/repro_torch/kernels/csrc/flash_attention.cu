// flash_attention for Hopper (sm_90a): forward online-softmax attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_fa_kernel,
// flash_attention_fwd; pallas_call at :105) together with its wrapper
// repro/kernels/ops.py::flash_attention, which folds batch and heads,
// repeats the KV heads for GQA and pads D to 128 lanes.  It computes what
// those compute, and what the plain version
// repro_torch/kernels/ref.py::flash_attention_ref computes:
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * D^-0.5) v[b, j, g]
//
// with g = h / (H / KV), over the keys the causal / sliding-window masks
// allow, where a masked score is the finite -1e30 (never -inf).  The
// running max m, sum l and accumulator acc are f32; each tile's
// probabilities p = exp(s - m_new) are rounded to v's dtype before the PV
// product (l sums them unrounded), and the result is acc / max(l, 1e-30)
// cast to q's dtype last.  A key tile that is fully masked for a row
// gives p = exp(0) = 1 there until a later valid tile wipes it with
// alpha = exp(-1e30 - m) = 0, exactly as in the Pallas kernel.
//
// The key band.  Each kernel walks only the key tiles that some row of its
// query rows [q_lo, q_hi] (q_hi < S) can see (key_band below;
// flash_attention.py::key_tile_band states the same bounds): under a
// causal mask none past the tile of key q_hi, under a window none before
// the tile of key max(0, q_lo - window + 1).  Skipping the rest is exact.
// A tile past the diagonal comes after every live tile of every row, and
// there it adds nothing: m is unchanged, alpha = exp(0) = 1 and p =
// exp(-1e30 - m) = 0.  A tile before the window comes before every live
// tile, and the first live tile wipes whatever it added (alpha =
// exp(-1e30 - m) = 0).  So the output equals, bit for bit, a walk over
// every tile, which is what the Pallas kernel does (its key axis is a
// sequential grid axis); at Granite's 32k causal prefill the band is
// 131,328 of 262,144 tile products a head, and under Gemma-3's window of
// 1,024 at most 17 key tiles of a query tile's 512.
//
// Design.  The TPU kernel walks a sequential grid axis over KV blocks and
// keeps (m, l, acc) in VMEM scratch between grid steps.  Here a CTA owns
// (batch*head, query tile) work and loops over the KV tiles itself;
// blocks are independent and run in any order.  Tensors are read and
// written in their (B, S, H, D) / (B, S, KV, D) layouts: the GQA head
// mapping is an index, no repeat is materialised, and no transpose or pad
// copy runs around the kernel; the tail tile of a ragged S is masked by
// k_pos < S.  Three kernels; the wrapper (flash_attention.py::variant)
// picks one before the launch from dtype, D and alignment, never as a
// fallback:
//
//   * tma_wgmma (bf16, D = 64, 72, 80 or 128, q, k, v 16-byte aligned;
//     the serving path: DeiT-B's heads are 64 wide, ViT-H/14's 80, DiT-XL/
//     2's 72).  Q, K and V come in through 4-D tensor maps, boxes of (64 d,
//     1 head, 64 rows, 1 batch) with 128-byte swizzle and zero fill past
//     S.  A block is two consumer warpgroups and a producer warp, of
//     which one thread loads the Q tile(s) and keeps a 3-stage K / V ring
//     full (full / empty mbarriers per stage).  A consumer warpgroup
//     computes S = Q K^T for its 64 query rows and a 64-key tile by wgmma
//     m64n64k16 (Q and K from shared memory, both K-major over d), the
//     online softmax in registers (the wgmma C layout gives each warp 16
//     rows, a thread rows g and g + 8: the row max and sum run over the
//     four lanes of a quad), and acc += P V by wgmma with P from registers
//     (the C layout of S is the register A layout, so the bf16-rounded p
//     never leaves registers) and V from shared memory as an MN-major B
//     (no transposed copy).  Heads 72, 80 and 128 wide (one block an SM)
//     issue a tile's P V after the next tile's Q K^T and wait for Q K^T
//     alone, so P V runs under that tile's softmax (FlashAttention-3's
//     intra-warpgroup overlap, arXiv:2407.08608 3.2); at D = 64 (two
//     blocks an SM, 96 registers a thread: no room for a second product
//     in flight, which ptxas would serialise) each product is waited for
//     at once, and the SM's other three warpgroups fill the softmax's
//     gap.  Only a tile that some mask
//     reaches (the tail of S, keys past the diagonal or outside the window
//     of a row of the tile) is masked element by element.  Where one
//     warpgroup per 64-row query tile would fill less than two waves of
//     SMs (flash_attention.py::split_keys; DeiT-B at B <= 2), both
//     warpgroups take the same query tile and alternate its key tiles,
//     and warpgroup 1 hands its (m, l, acc) to warpgroup 0 through shared
//     memory: m = max(m_a, m_b), each half scaled by exp(m_half - m), so a
//     half whose tiles were all masked for a row (m = -1e30) is wiped as a
//     later valid tile wipes it in the sequential loop.  Otherwise the two
//     warpgroups take two neighbouring query tiles and share every K / V
//     tile, which halves the K / V traffic from L2.  Two blocks fit an SM
//     at D = 64 (96 registers a thread, 82 KB of shared memory each).
//     Heads 72 and 80 wide (which the mma_sync kernel pads to 128): the
//     tile in shared memory stays two 64-wide boxes (DP = 128), but the
//     tensor maps' innermost extent is the true D, so TMA
//     zero-fills d in [D, 128) and the global row stride is H * D * 2
//     bytes (a multiple of 16 as D % 8 == 0).  Q K^T runs ceil(D / 16) =
//     5 k-steps, not 8 (the zeros past D add exact zeros); P V is one
//     wgmma m64nDk16 (m64n80k16 / m64n72k16, 40 / 36 accumulators a
//     thread) whose MN-major B reads the first box whole and the first
//     D - 64 columns of the second; the store writes D columns.  So the
//     products do D / 128 of the padded work and the accumulators hold D
//     columns.  Both widths keep the D = 128 kernel's layout, one block an
//     SM with a 3-stage ring of 32 KB stages: two blocks of 9 warps an SM
//     leave 96 registers a thread (5 warps on some of the SM's 4
//     register-file partitions), too few at D = 80 (40 accumulators, 32
//     scores, 16 of P: ptxas spilled and the kernel took 2.2x as long;
//     PERF.md).
//   * mma_sync (other bf16 inputs: D < 64 or any D outside 64 / 72 / 80 /
//     128, misaligned views, B * H > 65535): one CTA per (batch*head,
//     64-row query tile), 4 warps of 16 rows, Q and each K / V tile
//     staged in shared memory by the threads,
//     zero-filled past S and past D (padded to 32 / 64 / 128), both
//     products by mma.sync.m16n8k16 (bf16 in, f32 accumulation: the
//     products of bf16 values are exact in f32, as in the reference's f32
//     dot), V stored transposed so its B fragments are 32-bit loads;
//     output rows staged through the Q tile for coalesced stores.
//   * f32_regtile (f32, every shape and alignment): register tiles on the
//     FMA pipes (the tensor cores would round f32 inputs to TF32).  A
//     block of 128 threads owns 64 query rows of one (batch, head); Q is
//     staged once in shared memory, and K / V tiles of 64 keys (32 at D =
//     128) come in through cp.async (16 bytes a copy, 4 where D % 4 != 0
//     or a view is off alignment; zero-filled past S and D) as two groups
//     in flight: the next K tile loads while this tile's P V runs, the
//     next V tile while the next Q K^T and softmax run.  Each thread
//     holds a 4 x 8 micro-tile of S (4 x 4 at D = 128): per 4-deep d step,
//     4 Q and 8 K float4 reads feed 128 FMAs, where the scalar kernel it
//     replaces read one float4 of K for every 4 FMAs and stalled on its
//     loads, which no computation overlapped.  Each score stays one fmaf
//     chain over d in ascending order.  The row max and sum go over the 8
//     lanes that share a row by shuffles, P goes to shared memory once a
//     tile, and O is a 4-row x D/8-column register tile accumulated from
//     P and V (p unrounded: v is f32).  Only a tile that a mask reaches is
//     masked element by element.  One K and one V buffer (68 KB of shared
//     memory at D = 64, 75 KB at D = 128) and at most 170 registers a
//     thread (__launch_bounds__) let three blocks share an SM at D = 64.
//
// Bound on this card, at the serving path's shape (B=8, S=578, H=KV=12,
// D=64, bf16): 4*B*H*S^2*D = 8.21 GFLOP, 8.3 us at the 989 TFLOP/s bf16
// tensor-core peak; q, k, v and out are 7.1 MB each, 28.4 MB in all, 8.5
// us at 3.35 TB/s.  So about 8.5 us, bytes by a hair.  The tma_wgmma
// kernel's products take a small share of its time: the softmax's
// instructions between the two products and the wgmma latency within a
// warpgroup hold it; PERF.md has the measurements.  A 64 x 64 tile's softmax takes 4,096
// ex2 on the SFUs, 16 a cycle an SM: 256 cycles, as long as its two
// products at D = 64 on the tensor cores (2 x 64^3 multiply-adds, ~245
// cycles at the bf16 peak), so at D = 64 the softmax costs as much as
// the products even when it overlaps them.  Causal at Granite-3.0 MoE's
// 32k prefill (1, 32768, 24 / 8 heads, D = 64): the band holds 3.30
// TFLOP, 3.34 ms at the peak (q, k, v, out: 268 MB, 0.08 ms): operations.
// At ViT-H/14's served shape (B=8, S=730, H=KV=16, D=80, bf16): 21.83
// GFLOP, 22.1 us at 989 TFLOP/s, against 59.8 MB, 17.9 us at 3.35 TB/s:
// operations.  At (8, 578, 16, 80): 13.68 GFLOP, 13.8 us, against 47.3
// MB, 14.13 us: bytes.  At
// DiT-XL/2's (8, 1024, 16, 72): 38.65 GFLOP, 39.1 us (75.5 MB, 22.5
// us): operations.  The exponentials alone, ex2 on the SFUs at 16 a
// cycle an SM, take ~20 us at (8, 730, 16, 80), so the softmax again
// sets the pace there.  In f32 the same 8.21 GFLOP at 67 TFLOP/s
// outside the tensor cores take 122.5 us (operations; the 56.8 MB take
// 17.0 us); f32_regtile computes 640 x 640 padded scores a (batch, head)
// where 578 x 578 are needed, 1.23x the work.
//
// Arithmetic.  Built with --fmad=false like every kernel of the port:
// the f32 dot products are explicit fmaf chains over d in ascending
// order; the divisions are the IEEE-accurate forms (no fast math).  The
// f32_regtile and mma_sync kernels use the accurate expf; tma_wgmma
// computes exp through ex2.approx (relative error ~2^-22, far below the
// bf16 rounding of p).  The summation order differs from XLA's, so the
// kernels agree with the plain version to rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;   // the reference's finite mask value

// The key tiles [lo, hi] of `keys` keys that some query row in [q_lo,
// q_hi] sees (the header's band); none (lo > hi) if q_lo >= S, rows that
// are never stored
__host__ __device__ __forceinline__ void key_band(int q_lo, int q_hi, int S,
                                                  int causal, int window,
                                                  int keys, int& lo,
                                                  int& hi) {
  if (q_lo >= S) {
    lo = 0;
    hi = -1;
    return;
  }
  hi = (causal ? (q_hi < S - 1 ? q_hi : S - 1) : S - 1) / keys;
  lo = window > 0 && q_lo - window + 1 > 0 ? (q_lo - window + 1) / keys : 0;
}

// ---------------------------------------------------------------------------
// f32 (f32_regtile): register tiles on the FMA pipes, cp.async ring of 2
// ---------------------------------------------------------------------------
namespace rt {

constexpr int kRows = 64;        // query rows a block
constexpr int kThreads = 128;    // 16 row groups x 8 key / column groups

template <int DP>
struct Tiles {
  static constexpr int kKeys = DP <= 64 ? 64 : 32;   // keys a K / V tile
  static constexpr int kKpt = kKeys / 8;             // keys a thread scores
  static constexpr int kGroups = DP / 32;            // float4 columns of O
  static constexpr int kLd = DP + 4;       // floats between rows of Q, K, V
  static constexpr int kPLd = kRows + 4;   // floats between keys of P
  static constexpr int kTile = kKeys * kLd;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kRows) * kLd + 2 * kTile + kKeys * kPLd) *
      sizeof(float);
};

// N rows from row r0 of one head of a (B, S, heads, D) tensor (src: the
// head's row 0, rows `stride` floats apart) into a tile of DP-float rows
// kLd apart, zero past S and past D; VEC floats a copy
template <int VEC, int DP, int N>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int r0, int S,
                                          int D) {
  constexpr int kChunks = DP / VEC;
#pragma unroll 4
  for (int e = threadIdx.x; e < N * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * VEC;
    const bool in = r0 + r < S && c < D;
    hopper::cp_async<VEC>(
        dst + r * Tiles<DP>::kLd + c,
        in ? src + static_cast<size_t>(r0 + r) * stride + c : src, in);
  }
}

// A block owns 64 query rows of one (batch, head); thread (rg, kg) of the
// 16 x 8 owns rows rg + 16 i (i < 4), scores keys kg + 8 j of each tile
// and accumulates output columns g * 32 + kg * 4 + e.  Those strides keep
// every shared-memory read of a warp to distinct banks or broadcasts.
template <int DP, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int H, int KV, int D, float scale,
                           int causal, int window) {
  using L = Tiles<DP>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // kRows x kLd
  float* ks = qs + kRows * L::kLd;        // kKeys x kLd
  float* vs = ks + L::kTile;              // kKeys x kLd
  float* ps = vs + L::kTile;              // p[key][rg * 4 + i], kPLd a key

  const int kg = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kRows;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const float* qh = q + (static_cast<size_t>(b) * S * H + h) * D;
  const float* kh = k + (static_cast<size_t>(b) * S * KV + kvh) * D;
  const float* vh = v + (static_cast<size_t>(b) * S * KV + kvh) * D;

  // the key band (q0 < S: never empty); two cp.async groups in flight: K
  // of a tile loads while the previous tile's P V runs, V while this
  // tile's Q K^T and softmax run
  int t_lo, t_hi;
  key_band(q0, q0 + kRows - 1, S, causal, window, L::kKeys, t_lo, t_hi);
  load_tile<VEC, DP, kRows>(qs, qh, static_cast<size_t>(H) * D, q0, S, D);
  load_tile<VEC, DP, L::kKeys>(ks, kh, kv_stride, t_lo * L::kKeys, S, D);
  hopper::cp_async_commit();
  load_tile<VEC, DP, L::kKeys>(vs, vh, kv_stride, t_lo * L::kKeys, S, D);
  hopper::cp_async_commit();

  float acc[4][4 * L::kGroups];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * L::kGroups; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * L::kKeys;
    const int k_next = k0 + L::kKeys;
    hopper::cp_async_wait<1>();
    __syncthreads();   // K of tile t is in; P is free

    // each score one fmaf chain over d in ascending order
    float sc[4][L::kKpt];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < L::kKpt; ++j) sc[i][j] = 0.0f;
    // -- Q K^T products
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * L::kLd +
                                                d);
#pragma unroll
      for (int j = 0; j < L::kKpt; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(ks + (kg + 8 * j) * L::kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = sc[i][j];
          s = fmaf(a[i].x, kk.x, s);
          s = fmaf(a[i].y, kk.y, s);
          s = fmaf(a[i].z, kk.z, s);
          s = fmaf(a[i].w, kk.w, s);
          sc[i][j] = s;
        }
      }
    }
    // -- end Q K^T

    // scale, mask, online softmax; a row's scores lie with the 8 lanes of
    // its row group, which reduce by shuffles.  Masks element by element
    // only where one reaches the tile: its keys past S, or past the
    // diagonal or outside the window of a row of the block (rows past S
    // are never stored, so they need no mask of their own)
    const bool whole = k0 + L::kKeys <= S &&
                       (!causal || k0 + L::kKeys - 1 <= q0) &&
                       (window <= 0 || q0 + kRows - 1 - k0 < window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + rg + 16 * i;
      float m_cur = kNeg;
#pragma unroll
      for (int j = 0; j < L::kKpt; ++j) {
        if (whole) {
          sc[i][j] *= scale;
        } else {
          const int kp = k0 + kg + 8 * j;
          bool ok = qp < S && kp < S;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && qp - kp < window;
          sc[i][j] = ok ? sc[i][j] * scale : kNeg;
        }
        m_cur = fmaxf(m_cur, sc[i][j]);
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, x));
      const float m_new = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < L::kKpt; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);   // v is f32: p needs no rounding
        psum += sc[i][j];
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, x);
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int c = 0; c < 4 * L::kGroups; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < L::kKpt; ++j)
      *reinterpret_cast<float4*>(ps + (kg + 8 * j) * L::kPLd + rg * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    hopper::cp_async_wait<0>();
    __syncthreads();   // P is complete, V of tile t is in, K is free
    if (t < t_hi) {
      load_tile<VEC, DP, L::kKeys>(ks, kh, kv_stride, k_next, S, D);
      hopper::cp_async_commit();
    }

    // -- P V products
#pragma unroll 4
    for (int j = 0; j < L::kKeys; ++j) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(ps + j * L::kPLd + rg * 4);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + j * L::kLd + g * 32 + kg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g] = fmaf(p[i], vv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
    // -- end P V
    __syncthreads();   // V and P are free
    if (t < t_hi) {
      load_tile<VEC, DP, L::kKeys>(vs, vh, kv_stride, k_next, S, D);
      hopper::cp_async_commit();
    }
  }

  // acc / max(l, 1e-30), IEEE division, straight from registers: 8 lanes
  // store 128 contiguous bytes of a row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g) {
      const int c = g * 32 + kg * 4;
      if constexpr (VEC == 4) {
        if (c < D)
          *reinterpret_cast<float4*>(orow + c) = make_float4(
              acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
              acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < D) orow[c + e] = acc[i][4 * g + e] / denom;
      }
    }
  }
}

template <int DP, int VEC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int D, float scale, int causal, int window,
           cudaStream_t stream) {
  auto kernel = flash_attention_f32_kernel<DP, VEC>;
  const size_t smem = Tiles<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, D,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// D padded to 32 / 64 / 128; 16-byte copies and stores where D % 4 == 0
// and every tensor is 16-byte aligned, 4-byte ones otherwise
template <int DP>
int launch_vec(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int D, float scale, int causal,
               int window, cudaStream_t stream) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (D % 4 == 0 && ptrs % 16 == 0)
    return launch<DP, 4>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                         stream);
  return launch<DP, 1>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                       stream);
}

int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int D, float scale, int causal, int window,
             cudaStream_t stream) {
  if (D <= 32)
    return launch_vec<32>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                          stream);
  if (D <= 64)
    return launch_vec<64>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                          stream);
  return launch_vec<128>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                         stream);
}

}  // namespace rt

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16 (f32 accumulation)
// ---------------------------------------------------------------------------
constexpr int kMQ = 64;          // query rows per CTA: 4 warps x 16 rows
constexpr int kMK = 64;          // keys per KV tile
constexpr int kMThreads = 128;

template <int DP>
constexpr size_t mma_smem_bytes() {
  // Q tile and K tile (rows padded by 8 bf16 against bank conflicts), V^T
  return (static_cast<size_t>(kMQ) * (DP + 8) + kMK * (DP + 8) +
          DP * (kMK + 8)) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (lo) in bits 0..15
  return *reinterpret_cast<uint32_t*>(&h);
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

template <int DP>
__global__ void __launch_bounds__(kMThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int S, int H,
                           int KV, int D, float scale, int causal,
                           int window, bool vec) {
  constexpr int QS = DP + 8;             // row stride of the Q and K tiles
  constexpr int VS = kMK + 8;            // row stride of the V^T tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMQ * QS;
  __nv_bfloat16* vt = ks + kMK * QS;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;     // mma fragment row / column pair
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kMQ;
  const int row0 = q0 + warp * 16 + g;       // this thread's two rows
  const int row1 = row0 + 8;

  // vec: every row starts 16-byte aligned, so copy 8 values a thread
  // (uint4); otherwise one at a time
  if (vec) {
    for (int e = tid; e < kMQ * DP / 8; e += kMThreads) {
      const int r = e / (DP / 8), c = (e - r * (DP / 8)) * 8;
      const int s = q0 + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (s < S && c < D)
        x = *reinterpret_cast<const uint4*>(
            q + ((static_cast<size_t>(b) * S + s) * H + h) * D + c);
      *reinterpret_cast<uint4*>(qs + r * QS + c) = x;
    }
  } else {
    for (int e = tid; e < kMQ * DP; e += kMThreads) {
      const int r = e / DP, c = e - r * DP;
      const int s = q0 + r;
      qs[r * QS + c] = (s < S && c < D)
          ? q[((static_cast<size_t>(b) * S + s) * H + h) * D + c] : zero;
    }
  }
  __syncthreads();
  uint32_t qa[DP / 16][4];                   // this warp's Q rows as A
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* base = qs + (warp * 16 + g) * QS + kk * 16 + t * 2;
    qa[kk][0] = ld32(base);
    qa[kk][1] = ld32(base + 8 * QS);
    qa[kk][2] = ld32(base + 8);
    qa[kk][3] = ld32(base + 8 * QS + 8);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;   // l: this thread's part

  int t_lo, t_hi;                    // the key band (q0 < S: never empty)
  key_band(q0, q0 + kMQ - 1, S, causal, window, kMK, t_lo, t_hi);
  for (int k0 = t_lo * kMK; k0 <= t_hi * kMK; k0 += kMK) {
    __syncthreads();                 // the previous K, V tiles are consumed
    if (vec) {
      for (int e = tid; e < kMK * DP / 8; e += kMThreads) {
        const int r = e / (DP / 8), c = (e - r * (DP / 8)) * 8;
        const int s = k0 + r;
        uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
        if (s < S && c < D) {
          const size_t off =
              ((static_cast<size_t>(b) * S + s) * KV + kvh) * D + c;
          kx = *reinterpret_cast<const uint4*>(k + off);
          vx = *reinterpret_cast<const uint4*>(v + off);
        }
        *reinterpret_cast<uint4*>(ks + r * QS + c) = kx;
        const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
        for (int i = 0; i < 8; ++i) vt[(c + i) * VS + r] = vv[i];
      }
    } else {
      for (int e = tid; e < kMK * DP; e += kMThreads) {
        const int r = e / DP, c = e - r * DP;
        const int s = k0 + r;
        __nv_bfloat16 kx = zero, vx = zero;
        if (s < S && c < D) {
          const size_t off =
              ((static_cast<size_t>(b) * S + s) * KV + kvh) * D + c;
          kx = k[off];
          vx = v[off];
        }
        ks[r * QS + c] = kx;
        vt[c * VS + r] = vx;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[kMK / 8][4];
#pragma unroll
    for (int n = 0; n < kMK / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* base = ks + (n * 8 + g) * QS + kk * 16 + t * 2;
        mma_bf16(sc[n], qa[kk], ld32(base), ld32(base + 8));
      }
    }

    // scale, mask, row max over the quad that shares a row
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int n = 0; n < kMK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = i < 2 ? row0 : row1;
        const int kp = k0 + n * 8 + t * 2 + (i & 1);
        bool ok = qp < S && kp < S;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        sc[n][i] = ok ? sc[n][i] * scale : kNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);

    // p = exp(s - m_new): summed unrounded into l, rounded to bf16 into the
    // A fragments of the PV product (the C layout of S is the A layout)
    uint32_t pa[kMK / 16][4];
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kMK / 8; ++n) {
      const float p0 = expf(sc[n][0] - mn0), p1 = expf(sc[n][1] - mn0);
      const float p2 = expf(sc[n][2] - mn1), p3 = expf(sc[n][3] - mn1);
      ls0 += p0;
      ls0 += p1;
      ls1 += p2;
      ls1 += p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int kk = 0; kk < kMK / 16; ++kk) {
        const __nv_bfloat16* base = vt + (n * 8 + g) * VS + kk * 16 + t * 2;
        mma_bf16(acc[n], pa[kk], ld32(base), ld32(base + 8));
      }
    }
    m0 = mn0;
    m1 = mn1;
  }

  // l over the quad, normalise into this warp's own rows of the Q tile
  // (only this warp reads them), then store them coalesced
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* orow = qs + (warp * 16 + g) * QS + t * 2;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    orow[n * 8] = __float2bfloat16_rn(acc[n][0] / d0);
    orow[n * 8 + 1] = __float2bfloat16_rn(acc[n][1] / d0);
    orow[8 * QS + n * 8] = __float2bfloat16_rn(acc[n][2] / d1);
    orow[8 * QS + n * 8 + 1] = __float2bfloat16_rn(acc[n][3] / d1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e - r * D;
    const int s = q0 + warp * 16 + r;
    if (s < S)
      o[((static_cast<size_t>(b) * S + s) * H + h) * D + c] =
          qs[(warp * 16 + r) * QS + c];
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int D, float scale, int causal,
               int window, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<DP>;
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kMQ - 1) / kMQ);
  const bool vec = D % 8 == 0 && (reinterpret_cast<uintptr_t>(q) |
                                  reinterpret_cast<uintptr_t>(k) |
                                  reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  kernel<<<grid, kMThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, KV, D, scale, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int D, float scale, int causal,
                int window, cudaStream_t stream) {
  if (D <= 32)
    return launch_mma<32>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                          stream);
  if (D <= 64)
    return launch_mma<64>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                          stream);
  return launch_mma<128>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                         stream);
}

// ---------------------------------------------------------------------------
// bf16, TMA + wgmma (D = 64, 72, 80 or 128)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kRows = 64;               // query rows of one consumer warpgroup
constexpr int kKeys = 64;               // keys of one K / V tile
constexpr int kStages = 3;              // K / V ring
constexpr int kThreads = 2 * 128 + 32;  // two consumer warpgroups, a producer
constexpr int kBox = 64 * 128;          // a (64 rows, 64 d) box: 8 KB

// DP: the width of a tile in shared memory, one or two 64-wide boxes; D:
// the head width, D <= DP (TMA zero-fills d in [D, DP)).  A head 72 or 80
// wide takes D = 128's layout, one block an SM: two blocks of 9 warps
// leave 96 registers a thread, where D = 80 spills (PERF.md).
template <int DP, int D>
struct Layout {
  static constexpr int kTile = kBox * (DP / 64);     // 64 rows of Q, K or V
  static constexpr int kRing = 2 * kTile;            // after two Q tiles
  static constexpr int kStage = 2 * kTile;           // K, then V
  static constexpr int kMerge = kRing + kStages * kStage;
  static constexpr int kBars = kMerge + (kRows * D + 2 * kRows) * 4;
  static constexpr size_t kSmem = 1024 + kBars + (2 * kStages + 1) * 8;
};

// exp(x) = 2^(x log2 e) through the SFU's ex2.approx (relative error of
// ~2^-22, plus one rounding of the product: far below the bf16 rounding of
// p); exp(0) = 1 and exp(-1e30 - m) = 0, as the masking needs
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float exp_ex2(float x) {
  return ex2(x * 1.4426950408889634f);
}

// p = exp(s - m) of a thread's 32 scores (rows g and g + 8 of its warp,
// m = mn0 / mn1), in place, summed unrounded into ls0 / ls1.  kRaw: the
// scores are unscaled (an unmasked tile) and p = 2^(s (scale log2 e) - m
// log2 e), one fused multiply-add; else they are scaled or the mask's
// -1e30, and p = exp_ex2(s - m), which keeps exp(-1e30 - (-1e30)) = 1
template <bool kRaw>
__device__ __forceinline__ void probs(float (&sc)[kKeys / 2], float mn0,
                                      float mn1, float scale, float& ls0,
                                      float& ls1) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float c = scale * kLog2e;
  const float b0 = -mn0 * kLog2e, b1 = -mn1 * kLog2e;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    const bool hi = (i & 2) != 0;            // row g + 8
    sc[i] = kRaw ? ex2(__fmaf_rn(sc[i], c, hi ? b1 : b0))
                 : exp_ex2(sc[i] - (hi ? mn1 : mn0));
  }
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    ls0 += sc[4 * n];
    ls0 += sc[4 * n + 1];
    ls1 += sc[4 * n + 2];
    ls1 += sc[4 * n + 3];
  }
}

// p rounded to bf16 into the A fragments pa of the P V product (the C
// layout of S is the register A layout of wgmma)
__device__ __forceinline__ void pack_p(const float (&p)[kKeys / 2],
                                       uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    pa[n / 2][(n & 1) * 2] = pack_bf16(p[4 * n], p[4 * n + 1]);
    pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[4 * n + 2], p[4 * n + 3]);
  }
}

// acc += P V, committed as one group: V MN-major (d contiguous), 16 keys
// (rows) a step, an N = D product (the d of the next box kBox further), P
// from registers
template <int N>
__device__ __forceinline__ void pv_product(float (&acc)[N],
                                           const uint32_t (&pa)[kKeys / 16][4],
                                           const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    hopper::wgmma_rs<1>(acc, pa[kk],
                        hopper::desc_mn_major(vs + kk * 16 * 128, kBox), 1);
  hopper::wgmma_commit();
}

// as hopper::fence_regs, for the P fragments
__device__ __forceinline__ void fence_frags(uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e]) :: "memory");
}

// the largest of a thread's 16 scores of row g (mx0) and of row g + 8
// (mx1), as a tree: fmaxf is exact, so any order gives the same maximum,
// and the tree's depth is 4 where a chain's is 16
__device__ __forceinline__ void row_max(const float (&sc)[kKeys / 2],
                                        float& mx0, float& mx1) {
  float a[kKeys / 8], b[kKeys / 8];
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    a[n] = fmaxf(sc[4 * n], sc[4 * n + 1]);
    b[n] = fmaxf(sc[4 * n + 2], sc[4 * n + 3]);
  }
#pragma unroll
  for (int w = kKeys / 16; w > 0; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) {
      a[n] = fmaxf(a[n], a[n + w]);
      b[n] = fmaxf(b[n], b[n + w]);
    }
  mx0 = a[0];
  mx1 = b[0];
}

// S = Q K^T into sc, committed as one group: both K-major over d, 16 deep
// a step (32 bytes into the 128-byte rows of a box, the next box every 4
// steps), ceil(D / 16) steps: past D both tiles hold TMA's zeros
template <int D>
__device__ __forceinline__ void qk_product(float (&sc)[kKeys / 2],
                                           const unsigned char* qs,
                                           const unsigned char* ks) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 32;
    hopper::wgmma_ss<0>(sc, hopper::desc_k_major(qs + off),
                        hopper::desc_k_major(ks + off), kk > 0);
  }
  hopper::wgmma_commit();
}

// The online softmax of one key tile (keys k0...) for a thread's rows
// row0 and row1 of the query tile whose first row is q_lo: sc becomes p =
// exp(s - m_new), l = l alpha + sum p (p unrounded), m = m_new; alpha0 /
// alpha1 are the factors for acc.  Masked element by element only where
// a mask reaches the tile: the tail of S, or keys past the diagonal or
// outside the window of some row of the query tile (rows past S are never
// stored).  An unmasked tile stays unscaled until the exponent: rounding
// is monotonic, so max(s * scale) = max(s) * scale.  The row max and sum
// run over the four lanes (t) of a quad.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kKeys / 2], int k0, int q_lo, int row0, int row1, int t,
    int S, int causal, int window, float scale, float& m0, float& m1,
    float& l0, float& l1, float& alpha0, float& alpha1) {
  // -- softmax
  const bool masked = k0 + kKeys > S ||
                      (causal && k0 + kKeys - 1 > q_lo) ||
                      (window > 0 && q_lo + kRows - 1 - k0 >= window);
  if (masked) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = e < 2 ? row0 : row1;
        const int kp = k0 + n * 8 + t * 2 + (e & 1);
        bool ok = kp < S;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        sc[4 * n + e] = ok ? sc[4 * n + e] * scale : kNeg;
      }
  }
  float mx0, mx1;
  row_max(sc, mx0, mx1);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  if (!masked) {
    mx0 *= scale;
    mx1 *= scale;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  alpha0 = exp_ex2(m0 - mn0);
  alpha1 = exp_ex2(m1 - mn1);
  float ls0 = 0.0f, ls1 = 0.0f;
  if (masked)
    probs<false>(sc, mn0, mn1, scale, ls0, ls1);
  else
    probs<true>(sc, mn0, mn1, scale, ls0, ls1);
  l0 = l0 * alpha0 + ls0;
  l1 = l1 * alpha1 + ls1;
  m0 = mn0;
  m1 = mn1;
  // -- end softmax
}

// acc rows g (the even pairs) by alpha0 and g + 8 by alpha1
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    acc[4 * n] *= alpha0;
    acc[4 * n + 1] *= alpha0;
    acc[4 * n + 2] *= alpha1;
    acc[4 * n + 3] *= alpha1;
  }
}

// grid (query-tile groups, B * H); split: both consumer warpgroups on
// query tile j, warpgroup w taking the key tiles i of the band with i % 2
// == w; else warpgroup w on query tile 2 j + w, both through one ring of
// the block's band (the union of theirs), a warpgroup only releasing the
// tiles outside its own.  Causal, group j = gridDim.x - 1 - blockIdx.x:
// blocks are issued in order of blockIdx.x, so the heaviest (the longest
// band) go first and the light ones fill the last wave (0.7-1.4% off
// Granite's 32k prefill on an H100, medians of ten sweeps against index
// order, tools/kernel_ablation.py flash_causal); the heads stay in
// the order of blockIdx.y, so the query heads of one KV head run together
// and share its K / V tiles in L2.  kBand: a causal mask or a window may
// cut the key loop (the launcher picks the instantiation from the
// inputs); without either every tile is live for every row and the band
// is known at compile time: computed at run time, ptxas kept the
// producer's tile index out of the uniform registers, which cost the
// non-causal shapes up to 4.5% (DeiT-B, ViT-H/14, DiT-XL/2) on an H100
template <int DP, int D, bool kBand>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             __nv_bfloat16* __restrict__ o, int S, int H,
                             int KV, float scale, int causal, int window,
                             int split) {
  using L = Layout<DP, D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  if constexpr (!kBand) {
    causal = 0;
    window = 0;
  }
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int n_q = split ? 1 : 2;               // query tiles of the block
  const int qt0 = n_q * (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  const int wgi = threadIdx.x / 128;
  int lo, hi;                                  // the block's band
  key_band(qt0 * kRows, (qt0 + n_q) * kRows - 1, S, causal, window, kKeys,
           lo, hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // -- producer: the Q tile(s), then the band's K / V tiles through the
    // ring
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(qbar, n_q * L::kTile);
      for (int qi = 0; qi < n_q; ++qi)
        for (int x = 0; x < DP / 64; ++x)
          hopper::tma_load_4d(smem + qi * L::kTile + x * kBox, &tmq, qbar,
                              64 * x, h, (qt0 + qi) * kRows, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = lo; i <= hi; ++i) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + L::kRing + stage * L::kStage;
        hopper::mbar_arrive_expect_tx(&full[stage], L::kStage);
        for (int x = 0; x < DP / 64; ++x) {
          hopper::tma_load_4d(st + x * kBox, &tmk, &full[stage], 64 * x, kvh,
                              i * kKeys, b);
          hopper::tma_load_4d(st + L::kTile + x * kBox, &tmv, &full[stage],
                              64 * x, kvh, i * kKeys, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -- consumers
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;     // C-fragment row / column pair
  const int qt = split ? qt0 : qt0 + wgi;
  const unsigned char* qs = smem + (split ? 0 : wgi * L::kTile);
  const int row0 = qt * kRows + warp * 16 + g;   // this thread's two rows
  const int row1 = row0 + 8;
  // this warpgroup's band [my_lo, my_hi]: in the full grid it differs
  // from the block's by at most the first or the last tile (the two query
  // tiles are one key tile apart); the tiles of the block's band outside it
  // are only released, in loops of their own before and after, so the loop
  // over the band tests no more than the split's parity (a band test in
  // it cost the one-block-an-SM layout 3-4% on an H100, at ViT-H/14's and
  // DiT-XL/2's shapes)
  int my_lo, my_hi;
  key_band(qt * kRows, qt * kRows + kRows - 1, S, causal, window, kKeys,
           my_lo, my_hi);

  float acc[D / 2], sc[kKeys / 2];
  uint32_t pa[kKeys / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kKeys / 16; ++i)
    pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0u;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;  // l: this thread's part
  float alpha0, alpha1;
  const int q_lo = qt * kRows;

  hopper::mbar_wait(qbar, 0);
  const bool leader = threadIdx.x % 128 == 0;
  // a key tile of this warpgroup's band is its own but, split, for the
  // other warpgroup's parity
  auto own = [&](int i) { return !split || (i & 1) == wgi; };
  int stage = 0, i = lo;
  uint32_t phase = 0;
  auto next = [&]() {
    ++i;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  // the block's tiles up to (not including) tile `stop`, released unread
  auto release_to = [&](int stop) {
    for (; i < stop; next()) {
      hopper::mbar_wait(&full[stage], phase);
      if (leader) hopper::mbar_arrive(&empty[stage]);
    }
  };
  release_to(my_lo);
  const int end = my_hi + 1;
  if constexpr (DP == 128 && kBand) {
    // One block an SM (heads 72, 80, 128 wide) under a mask: a tile's P V
    // is issued after the next tile's Q K^T, and the wait takes Q K^T
    // alone (groups end in order), so P V runs on the tensor cores under
    // that tile's softmax (FlashAttention-3's intra-warpgroup overlap).
    // The first own tile has no P V before it, so its loop is peeled off:
    // a wgmma in a branch of its own makes ptxas serialise them all.
    // Without the band the loop below measured faster at heads 72 and 80
    // (tools/kernel_ablation.py flash_causal)
    int pending = -1;        // the stage whose p waits in pa
    const unsigned char* vs = qs;
    for (bool first = true; first && i < end; next()) {
      hopper::mbar_wait(&full[stage], phase);
      if (!own(i)) {
        if (leader) hopper::mbar_arrive(&empty[stage]);
        continue;
      }
      const unsigned char* ks = smem + L::kRing + stage * L::kStage;
      qk_product<D>(sc, qs, ks);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      softmax_tile(sc, i * kKeys, q_lo, row0, row1, t, S, causal, window,
                   scale, m0, m1, l0, l1, alpha0, alpha1);
      pack_p(sc, pa);                  // acc is still 0: nothing to rescale
      pending = stage;
      vs = ks + L::kTile;
      first = false;
    }
    for (; i < end; next()) {
      hopper::mbar_wait(&full[stage], phase);
      if (!own(i)) {
        if (leader) hopper::mbar_arrive(&empty[stage]);
        continue;
      }
      const unsigned char* ks = smem + L::kRing + stage * L::kStage;
      qk_product<D>(sc, qs, ks);
      pv_product(acc, pa, vs);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      softmax_tile(sc, i * kKeys, q_lo, row0, row1, t, S, causal, window,
                   scale, m0, m1, l0, l1, alpha0, alpha1);
      hopper::wgmma_wait<0>();         // the pending P V: its stage is free
      hopper::fence_regs(acc);
      fence_frags(pa);
      if (leader) hopper::mbar_arrive(&empty[pending]);
      rescale(acc, alpha0, alpha1);
      pack_p(sc, pa);
      pending = stage;
      vs = ks + L::kTile;
    }
    // the last own tile's P V (zeros on the Q tile if there was none)
    hopper::wgmma_fence();
    pv_product(acc, pa, vs);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (pending >= 0 && leader) hopper::mbar_arrive(&empty[pending]);
  } else {
    // Each product waited for at once and the stage released after P V.
    // D = 64, two blocks an SM at 96 registers a thread, has no room for
    // a second accumulator in flight (ptxas would serialise the wgmma):
    // the SM's other three warpgroups fill the softmax's gap
    for (; i < end; next()) {
      hopper::mbar_wait(&full[stage], phase);
      if (own(i)) {
        const unsigned char* ks = smem + L::kRing + stage * L::kStage;
        qk_product<D>(sc, qs, ks);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        softmax_tile(sc, i * kKeys, q_lo, row0, row1, t, S, causal, window,
                     scale, m0, m1, l0, l1, alpha0, alpha1);
        rescale(acc, alpha0, alpha1);
        pack_p(sc, pa);
        hopper::wgmma_fence();
        pv_product(acc, pa, ks + L::kTile);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      if (leader) hopper::mbar_arrive(&empty[stage]);
    }
  }
  release_to(hi + 1);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  if (split) {
    // warpgroup 1 hands its (m, l, acc) to warpgroup 0, which merges:
    // m = max(m_a, m_b), each half scaled by exp(m_half - m), so a half
    // whose tiles were all masked for a row (m = -1e30) is wiped as a
    // later valid tile wipes it in the sequential loop
    float* macc = reinterpret_cast<float*>(smem + L::kMerge);
    float* mm = macc + kRows * D;
    float* ml = mm + kRows;
    const int r = warp * 16 + g;
    if (wgi == 1) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + t * 2;
        macc[r * D + c] = acc[4 * n];
        macc[r * D + c + 1] = acc[4 * n + 1];
        macc[(r + 8) * D + c] = acc[4 * n + 2];
        macc[(r + 8) * D + c + 1] = acc[4 * n + 3];
      }
      if (t == 0) {
        mm[r] = m0;
        mm[r + 8] = m1;
        ml[r] = l0;
        ml[r + 8] = l1;
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wgi == 1) return;
    const float mb0 = mm[r], mb1 = mm[r + 8];
    const float mt0 = fmaxf(m0, mb0), mt1 = fmaxf(m1, mb1);
    const float a0 = expf(m0 - mt0), b0 = expf(mb0 - mt0);
    const float a1 = expf(m1 - mt1), b1 = expf(mb1 - mt1);
    l0 = l0 * a0 + ml[r] * b0;
    l1 = l1 * a1 + ml[r + 8] * b1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + t * 2;
      acc[4 * n] = acc[4 * n] * a0 + macc[r * D + c] * b0;
      acc[4 * n + 1] = acc[4 * n + 1] * a0 + macc[r * D + c + 1] * b0;
      acc[4 * n + 2] = acc[4 * n + 2] * a1 + macc[(r + 8) * D + c] * b1;
      acc[4 * n + 3] = acc[4 * n + 3] * a1 + macc[(r + 8) * D + c + 1] * b1;
    }
  }

  // normalise and store the D columns: a quad writes 16 contiguous bytes
  // of a row
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((static_cast<size_t>(b) * S + row0) * H + h) * D + c) =
          __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((static_cast<size_t>(b) * S + row1) * H + h) * D + c) =
          __floats2bfloat162_rn(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
  }
}

// tensor maps over (B, S, heads, D) bf16 (sizes innermost first), boxes
// of (64 d, 1 head, 64 rows, 1 batch); a box reaching past D (the second
// box of a head 72 or 80 wide) is zero-filled there
int encode_bshd(CUtensorMap* map, const void* base, int B, int S, int heads,
                int D) {
  const cuuint64_t size[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(D) * 2,
                                static_cast<cuuint64_t>(heads) * D * 2,
                                static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  return hopper::encode_bf16(map, base, 4, size, stride, box);
}

template <int DP, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, float scale, int causal, int window,
           int split, cudaStream_t stream) {
  CUtensorMap tmq, tmk, tmv;
  int code = encode_bshd(&tmq, q, B, S, H, D);
  if (code == 0) code = encode_bshd(&tmk, k, B, S, KV, D);
  if (code == 0) code = encode_bshd(&tmv, v, B, S, KV, D);
  if (code != 0) return code;
  auto kernel = causal || window > 0
                    ? flash_attention_wgmma_kernel<DP, D, true>
                    : flash_attention_wgmma_kernel<DP, D, false>;
  const size_t smem = Layout<DP, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (S + kRows - 1) / kRows;
  const dim3 grid(split ? q_tiles : (q_tiles + 1) / 2, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      tmq, tmk, tmv, static_cast<__nv_bfloat16*>(o), S, H, KV, scale, causal,
      window, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// q (B, S, H, D), k and v (B, S, KV, D), out (B, S, H, D), all contiguous
// and of one dtype: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).  window <= 0
// means no sliding window.  Returns a cudaError_t (0 on a good launch).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int D, float scale,
                                      int causal, int window, int is_bf16,
                                      int device, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > 128 || (S + rt::kRows - 1) / rt::kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_bf16)
    return launch_bf16(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                       stream);
  return rt::launch_d(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                      stream);
}

// The TMA / wgmma bf16 kernel: D = 64, 72, 80 or 128, q, k, v 16-byte
// aligned (the wrapper, flash_attention.py::variant, sends every other
// input to flash_attention_launch).  split != 0 splits each query tile's
// key tiles between the block's two consumer warpgroups
// (flash_attention.py::split_keys).  Returns 0, a cudaError_t, or
// hopper::kEncodeError plus the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int S, int H, int KV, int D,
                                            float scale, int causal,
                                            int window, int split, int device,
                                            cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 ||
      (D != 64 && D != 72 && D != 80 && D != 128) || ptrs % 16 != 0 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (D) {
    case 64:
      return wg::launch<64, 64>(q, k, v, o, B, S, H, KV, scale, causal,
                                window, split, stream);
    case 72:
      return wg::launch<128, 72>(q, k, v, o, B, S, H, KV, scale, causal,
                                 window, split, stream);
    case 80:
      return wg::launch<128, 80>(q, k, v, o, B, S, H, KV, scale, causal,
                                 window, split, stream);
    default:
      return wg::launch<128, 128>(q, k, v, o, B, S, H, KV, scale, causal,
                                  window, split, stream);
  }
}
