"""Where the time of the port's redesigned kernels goes, on one NVIDIA GPU.

    python3 tools/kernel_ablation.py [--root CHECKOUT] [--only GROUP ...]

Builds versions of the kernel sources from patched copies of
``src/repro_torch/kernels/csrc`` (under ``build/ablation/``) and times
each with CUDA events around launches replayed from one CUDA graph.
``--root`` takes the sources and the wrappers from another checkout (an
unpacked older commit, to measure the kernels it had).  Seven groups:

- ``wgmma``: the TMA / ``wgmma`` kernels of ``moe_gemm`` (Granite-3.0 MoE
  gate/up and down, bf16) and ``flash_attention`` (DeiT-B's attention at
  384 px: S=578, 12 heads, D=64, bf16, B=1 with split keys and B=8), as
  built, without the products (no wgmma issued: what remains is the
  loads, the pipeline's waits and, for flash_attention, the softmax),
  without the loads (the producer arrives on each stage without a TMA
  copy: products on stale tiles), and without either; beside
  ``torch.bmm`` and ``scaled_dot_product_attention``;
- ``flash_f32``: the f32 ``flash_attention`` kernel at the same shape in
  f32, B=1 and B=8, as built, without its products (neither Q K^T nor
  P V), without its K / V loads (the tiles in shared memory stay
  stale), and without either; beside SDPA in f32;
- ``flash_wide``: the bf16 ``flash_attention`` kernel of heads 80 wide
  (ViT-H/14's 16 heads at B = 8 and S = 578, and at its own 730 tokens at
  B = 1, 2 and 8) and 72 wide (DiT-XL/2's 16 at B = 8, S = 1024): as
  built (``tma_wgmma``), without the products and without the loads (as
  in ``wgmma``); and the ``mma_sync`` kernel on the same aligned inputs
  (called through its C launcher: the wrapper sends these to
  ``tma_wgmma``), the kernel these heads took before;
- ``flash_causal``: the bf16 ``tma_wgmma`` ``flash_attention`` kernel at
  Granite-3.0 MoE's 32k causal prefill, (1, 32768, 24 query / 8 KV heads,
  D=64), and at DiT-XL/2's ``gen_1024``, (4, 4096, 16 / 16, 72),
  non-causal: as built, without the products, without the softmax (p taken
  as the raw scores, no max, exponential, sum or rescale), and with launch
  bounds of one block an SM (the registers of D = 128's layout at D = 64);
  the causal grid issued in index order (the lightest query tiles first)
  at Granite's, StarCoder2-7B's (1, 32768, 36 / 4, 128) and Gemma-3 27B's
  local (1, 32768, 32 / 16, 128, window 1,024) causal shapes; every key
  tile walked (the band widened to the whole sequence) at Granite's; each
  product waited for at once at every width and mask at the three 32k
  causal shapes; the banded instantiation at every mask (the band computed
  at run time where no mask cuts it) and P V left running under the next
  tile's softmax at heads 72-128 wide without a mask too, at the served
  non-causal shapes (DeiT-B's (B, 578, 12, 64) at B = 1, 2, 3, 5, 8,
  ViT-H/14's (8, 578 / 730, 16, 80), DiT-XL/2's ``gen_fast`` (16, 1024,
  16, 72) and ``gen_1024``); the exact versions' outputs held to the
  as-built one's bit for bit; with ``--baseline CHECKOUT`` (an unpacked
  older commit) also that checkout's ``flash_attention.cu`` through the
  same wrapper, its output held to this one's bit for bit, and both timed
  at every shape (the ones above, and Granite's prefill non-causal); every
  version timed in turns (forward, then backward through the list, five
  times over: the best and the median of the ten, and in how many of the
  ten sweeps the as-built kernel beat each other version, with the median
  of its ratios), beside SDPA, each version's ``ptxas`` lines for the
  kernel (registers, and whether it serialised the ``wgmma``) and its SASS
  (``cuobjdump``, kept beside the version's patched sources under
  ``build/ablation/``; the instructions of each ``tma_wgmma``
  instantiation printed);
- ``rmsnorm``: ``rmsnorm`` at (4096, 5376), (4096, 1536) and (7, 7168),
  bf16 and f32, as built (the wrapper called as a user calls it, scale
  in x's dtype), with the scale cast to f32 outside the timed call, and
  with every read of the scale replaced by a constant; beside
  ``F.rms_norm`` with its weight built outside the timed call;
- ``admission``: ``fleet_feasibility`` and ``link_cost`` at the entry
  points' shapes (K, N) = (256, 1024), (32, 512), (3, 1024), (6, 1024)
  and the event heap router's (2, 256), (2, 512), (2, 1024), (5, 256):
  as built, the rows read in place (no staging in shared memory), with
  empty kernel bodies (the launch floor at the same grid), and, with
  ``--baseline CHECKOUT`` (an unpacked older commit, e.g. PR 13's to PR
  21's one-warp-a-row design), that checkout's ``admission.cu`` through
  the same wrappers; every version timed in turns (forward, then
  backward through the list; the better of the two);
- ``rmsnorm_bwd``: the ``rmsnorm`` backward kernel at the LM train
  steps' rows, (8192, d) for d = 1,536 (Granite-3.0 MoE at B = 2 x
  4,096), 4,608 (StarCoder2-7B), 5,376 (Gemma-3 27B) and 7,168
  (Kimi-K2), (4096, 1536) and (3, 1536), bf16 and f32: as built, without
  the column pass (no grid barrier, dscale left as the blocks' partial
  rows), the column pass alone (no row walked), with a persistent grid of
  one block an SM, with blocks of 128 threads (narrow rows two a block)
  four an SM, and, with ``--baseline CHECKOUT``, that checkout's
  ``rmsnorm.cu`` through its own wrapper; every version timed in turns
  (forward, then backward; the better of the two) graph-replayed with
  the same inputs every call (L2 warm where they fit) and with L2 cold
  (each call on the next of as many input copies as exceed the L2 twice
  over); the real versions also in
  an eager loop (the wrapper's host work included); beside the one
  PyTorch call for the same function, ``aten._fused_rms_norm_backward``
  (graph-replayed, warm and cold), and ``F.rms_norm``'s autograd
  backward (eager); the real versions' dx and dscale held to
  ``ref.rmsnorm_bwd_ref`` at ``ref.rmsnorm_bwd_tolerance``.

The patched kernels compute garbage; only their times mean anything.
Prints one JSON object per line, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# A cut is, per source, a list of alternatives, each a list of (pattern,
# replacement); the first alternative whose patterns all match is applied
# (one per kernel design a checkout may hold).
WGMMA_PRODUCTS = {
    "moe_gemm": [[(r"hopper::wgmma_ss<1>\(.*?kb > 0 \|\| kk > 0\);", "")]],
    "flash_attention": [[
        (r"hopper::wgmma_ss<0>\(sc,.*?kk > 0\);", ""),
        (r"hopper::wgmma_rs<1>\(acc, pa\[kk\],.*?1\);", "")]],
}
WGMMA_LOADS = {
    "moe_gemm": [[
        (r"hopper::mbar_arrive_expect_tx\(&full\[stage\], kStageBytes\);",
         "hopper::mbar_arrive(&full[stage]);"),
        (r"hopper::tma_load_3d\(st, &tmx.*?kb \* kBK, e\);", "")]],
    "flash_attention": [[
        (r"hopper::mbar_arrive_expect_tx\(&full\[stage\], L::kStage\);",
         "hopper::mbar_arrive(&full[stage]);"),
        (r"hopper::tma_load_4d\(st \+ x \* kBox, &tmk.*?i \* kKeys, b\);", ""),
        (r"hopper::tma_load_4d\(st \+ L::kTile.*?i \* kKeys, b\);", "")]],
}
F32_PRODUCTS = {"flash_attention": [
    # register tiles: the two products are marked blocks
    [(r"// -- Q K\^T products\n.*?// -- end Q K\^T\n", ""),
     (r"// -- P V products\n.*?// -- end P V\n", "")],
    # one thread per query row
    [(r"#pragma unroll 2\n    for \(int d = 0; d < DP; d \+= 4\) \{\n"
      r"      const float a0.*?sc\[j\] = t;\n      \}\n    \}\n", ""),
     (r"#pragma unroll 2\n    for \(int j = 0; j < kBK; \+\+j\) \{\n"
      r"      const float p = prow\[j\];.*?acc\[d \+ 3\]\);\n      \}\n"
      r"    \}\n", "")],
]}
F32_LOADS = {"flash_attention": [
    [(r"load_tile<VEC, DP, L::kKeys>\(ks[^;]*;\n", ""),
     (r"load_tile<VEC, DP, L::kKeys>\(vs[^;]*;\n", "")],
    [(r"kx = k\[off\];\n        vx = v\[off\];",
      "kx = 1.0f;\n        vx = 1.0f;")],
]}
CONST_SCALE = {"rmsnorm": [
    [(r"// -- scale read\n.*?// -- end scale read\n",
      "for (int i = 0; i < V; ++i) out[i] = 1.1f;\n")],
    [(r"load_scale<V>\(s_ptr, s\);",
      "for (int i = 0; i < V; ++i) s[i] = 0.1f;")],
]}
# flash_attention.cu (tma_wgmma): p taken as the raw scores (packed to
# bf16 as they are), with no mask, max, exponential or sum (acc rescaled
# by 1)
NO_SOFTMAX = {"flash_attention": [[
    (r"// -- softmax\n.*?// -- end softmax\n", "alpha0 = alpha1 = 1.0f;\n")]]}
# flash_attention.cu (tma_wgmma): one block an SM at every head width
ONE_BLOCK = {"flash_attention": [[
    (r"__launch_bounds__\(kThreads, DP == 64 \? 2 : 1\)",
     "__launch_bounds__(kThreads, 1)")]]}
# flash_attention.cu (tma_wgmma): the causal grid's query-tile groups in
# index order, the lightest first (exact)
INDEX_ORDER = {"flash_attention": [[
    (r"const int qt0 = n_q \* \(causal \? gridDim\.x - 1 - blockIdx\.x "
     r": blockIdx\.x\);", "const int qt0 = n_q * blockIdx.x;")]]}
# flash_attention.cu: every key tile walked, the band widened to the whole
# sequence (exact: the walk the Pallas kernel makes)
FULL_WALK = {"flash_attention": [[
    (r"  hi = \(causal \? .*?\n  lo = window > 0 .*?;\n",
     "  hi = (S - 1) / keys;\n  lo = 0;\n")]]}
# flash_attention.cu (tma_wgmma): the banded instantiation at every mask,
# the band computed at run time where no mask cuts it (exact)
BANDED = {"flash_attention": [[
    (r"causal \|\| window > 0\s*\? (flash_attention_wgmma_kernel<DP, D, true>)"
     r"\s*: flash_attention_wgmma_kernel<DP, D, false>", r"\1")]]}
# flash_attention.cu (tma_wgmma): each product waited for at once and the
# stage released after P V at every head width and mask, or P V left
# running under the next tile's softmax at heads 72-128 wide without a
# mask too (exact)
WAITED = {"flash_attention": [[
    (r"if constexpr \(DP == 128 && kBand\) \{", "if constexpr (false) {")]]}
OVERLAPPED = {"flash_attention": [[
    (r"if constexpr \(DP == 128 && kBand\) \{",
     "if constexpr (DP == 128) {")]]}
# rmsnorm.cu's backward: no grid barrier and no column pass (dscale left
# as the blocks' partial rows), or no row walked (the column pass alone)
NO_COLUMN_PASS = {"rmsnorm": [
    [(r"  // -- column pass\n.*?// -- end column pass\n", "")],
    [(r"  cooperative_groups::this_grid\(\)\.sync\(\);\n.*?"
      r"dscale\[c\] = from_float<S>\(s\);\n  \}\n", "")]]}
COLUMN_PASS_ALONE = {"rmsnorm": [
    [(r"const int nrows = R;", "const int nrows = 0;")],
    [(r"row < R; row \+= gridDim\.x, parity \^= 1\)",
      "row < 0; row += gridDim.x, parity ^= 1)")]]}
# rmsnorm.cu's backward: a persistent grid of one block an SM, or of
# blocks of 128 threads (narrow rows two a block), four an SM
BWD_ONE_BLOCK = {"rmsnorm": [[
    (r"kBwdBlocksPerSm = \d+;", "kBwdBlocksPerSm = 1;")]]}
BWD_SMALL_BLOCKS = {"rmsnorm": [[
    (r"kBwdBlocksPerSm = \d+;", "kBwdBlocksPerSm = 4;"),
    (r"kBwdMinThreads = \d+;", "kBwdMinThreads = 128;")]]}
# admission.cu: the passes read the row where it lies in global memory
IN_PLACE = {"admission": [[
    (r"// -- staged loads\n.*?// -- end staged loads\n",
     "r_st = st; r_en = en; r_sz = sz;\n    o_st = o_en = o_sz = 0;\n")]]}
# admission.cu: kernels that return at once (the same launch shape)
EMPTY_BODY = {"admission": [[(r"// -- body\n.*?// -- end body\n", "")]]}


def merge(*cuts):
    out = {}
    for cut in cuts:
        for source, alts in cut.items():
            out.setdefault(source, []).append(alts)
    return out


VERSIONS = {
    "as built": {},
    "no products": merge(WGMMA_PRODUCTS, F32_PRODUCTS),
    "no loads": merge(WGMMA_LOADS, F32_LOADS),
    "neither": merge(WGMMA_PRODUCTS, F32_PRODUCTS, WGMMA_LOADS, F32_LOADS),
    "constant scale": merge(CONST_SCALE),
    "rows in place": merge(IN_PLACE),
    "empty kernel": merge(EMPTY_BODY),
    "no softmax": merge(NO_SOFTMAX),
    "one block an SM": merge(ONE_BLOCK),
    "index order": merge(INDEX_ORDER),
    "full walk": merge(FULL_WALK),
    "banded at every mask": merge(BANDED),
    "products waited at once": merge(WAITED),
    "P V overlapped at every mask": merge(OVERLAPPED),
    "no column pass": merge(NO_COLUMN_PASS),
    "column pass alone": merge(COLUMN_PASS_ALONE),
    "one block an SM (bwd)": merge(BWD_ONE_BLOCK),
    "blocks of 128 threads": merge(BWD_SMALL_BLOCKS),
}
GROUP_VERSIONS = {
    "wgmma": ("as built", "no products", "no loads", "neither"),
    "flash_f32": ("as built", "no products", "no loads", "neither"),
    "flash_wide": ("as built", "no products", "no loads"),
    "rmsnorm": ("as built", "constant scale"),
    "admission": ("as built", "rows in place", "empty kernel", "baseline"),
    "flash_causal": ("as built", "no products", "no softmax",
                     "one block an SM", "index order", "full walk",
                     "banded at every mask",
                     "products waited at once",
                     "P V overlapped at every mask", "baseline"),
    "rmsnorm_bwd": ("as built", "no column pass", "column pass alone",
                    "one block an SM (bwd)", "blocks of 128 threads",
                    "baseline"),
}
# flash_causal's shapes, (B, S, H, KV, D, causal, window)
CAUSAL_SHAPES = {"granite_prefill_32k": (1, 32768, 24, 8, 64, True, None),
                 "dit_gen_1024": (4, 4096, 16, 16, 72, False, None)}
SERVED_SHAPES = {**{f"deit_b_{B}": (B, 578, 12, 12, 64, False, None)
                    for B in (1, 2, 3, 5, 8)},
                 "vit_h14_578": (8, 578, 16, 16, 80, False, None),
                 "vit_h14_730": (8, 730, 16, 16, 80, False, None),
                 "dit_gen_fast": (16, 1024, 16, 16, 72, False, None)}
LM_SHAPES = {"granite_prefill_32k_full": (1, 32768, 24, 8, 64, False, None),
             "starcoder2_32k": (1, 32768, 36, 4, 128, True, None),
             "gemma3_local_32k": (1, 32768, 32, 16, 128, True, 1024)}
# the shapes each version is timed at (as built and the baseline: all)
VERSION_SHAPES = {
    "no products": tuple(CAUSAL_SHAPES),
    "no softmax": tuple(CAUSAL_SHAPES),
    "one block an SM": tuple(CAUSAL_SHAPES),
    "index order": ("granite_prefill_32k", "starcoder2_32k",
                    "gemma3_local_32k"),
    "full walk": ("granite_prefill_32k",),
    "banded at every mask": ("dit_gen_1024", *SERVED_SHAPES),
    "products waited at once": ("granite_prefill_32k", "starcoder2_32k",
                                "gemma3_local_32k"),
    "P V overlapped at every mask": ("dit_gen_1024", *SERVED_SHAPES)}
# passes in turns (each a forward and a backward sweep of the versions)
CAUSAL_PAIRS = 5
# the versions whose output equals the as-built kernel's bit for bit (at
# the shapes they are timed at)
EXACT = ("index order", "full walk", "banded at every mask",
         "products waited at once", "P V overlapped at every mask",
         "baseline")
ADMISSION_SHAPES = ((256, 1024), (32, 512), (3, 1024), (6, 1024),
                    (2, 256), (2, 512), (2, 1024), (5, 256))
# rmsnorm_bwd's rows (R, d): the LM train steps' (B S, d) at B S = 8,192,
# Granite's at B = 1, and a row count under the grid
RMSNORM_BWD_SHAPES = ((8192, 1536), (4096, 1536), (8192, 4608),
                      (8192, 5376), (8192, 7168), (3, 1536))
# the versions that compute the backward (timed eagerly too, and checked)
RMSNORM_BWD_REAL = ("as built", "baseline")
L2_BYTES = 50e6                    # H100 SXM L2 cache


def admission_inputs(gen, K, N, dev):
    """``ops.fleet_feasibility`` and ``ops.link_cost`` arguments: K rows of
    N slots, the first half of each row live blocks of sizes 20 to 180 on
    a 0.5 grid with gaps, the rest padding; head 0; a deadline inside the
    rows."""
    import torch
    live = N // 2
    size = (torch.randint(1, 10, (K, live), generator=gen, device=dev)
            * 20.0)
    gap = torch.randint(0, 3, (K, live), generator=gen, device=dev) * 0.5
    ends = torch.cumsum(size + gap, 1)
    pad = lambda a, v: torch.cat([a, torch.full((K, N - live), v,
                                                device=dev)], 1)
    starts, ends = pad(ends - size, 1e30), pad(ends, 1e30)
    sizes = pad(size, 0.0)
    n = torch.full((K,), live, dtype=torch.int32, device=dev)
    head = torch.zeros(K, dtype=torch.int32, device=dev)
    ps = torch.full((K,), 44.0, device=dev)
    free = torch.zeros(K, device=dev)
    d = ends[:, live // 2].max().reshape(1)
    t = torch.zeros(1, device=dev)
    ff = (starts, ends, sizes, n, ps, d, free, head)
    lc = (*ff, t, torch.full((K,), 5.0, device=dev),
          torch.full((K,), 0.8, device=dev), torch.full((1,), 24.8832,
                                                        device=dev))
    return ff, lc


def patched_csrc(csrc: Path, name: str, cuts) -> Path:
    """A copy of ``csrc`` with ``cuts`` applied, under build/ablation."""
    out = ROOT / "build" / "ablation" / re.sub(r"\W+", "_", name) / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    for source, cut_list in cuts.items():
        path = out / f"{source}.cu"
        text = path.read_text()
        for alts in cut_list:
            for alt in alts:
                if all(re.search(p, text, flags=re.DOTALL) for p, _ in alt):
                    for pattern, repl in alt:
                        text = re.sub(pattern, repl, text, flags=re.DOTALL)
                    break
            else:
                raise SystemExit(f"kernel_ablation: no cut of {name!r} "
                                 f"matches {source}.cu")
        path.write_text(text)
    return out


def graph_ms(fn, reps: int) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cold_ms(fn, inputs) -> float:
    """Device time per call with L2 cold for the inputs: one call on each
    of as many copies of ``inputs`` as exceed twice the L2, captured in
    one CUDA graph in turn and replayed under CUDA events."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    n = max(2, -(-int(2 * L2_BYTES) // nbytes))
    copies = [tuple(t.clone() for t in inputs) for _ in range(n)]
    it = iter(copies * 2)          # the warm-up call, then the n captured
    return graph_ms(lambda: fn(*next(it)), n)


def timed_ms(fn, reps: int) -> float:
    """Device time per call of an eager loop: CUDA events around
    ``reps`` calls, the host's work between launches included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def flash_causal(dirs, gen, dev) -> None:
    """The ``flash_causal`` group: each version of ``dirs`` it names built
    and timed in turns at its shapes; the exact versions' outputs held to
    the as-built kernel's bit for bit."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    inputs = {}
    order = [v for v in dirs if v in GROUP_VERSIONS["flash_causal"]]
    every = dict(CAUSAL_SHAPES, **SERVED_SHAPES, **LM_SHAPES)
    wanted = set(CAUSAL_SHAPES) | (set(every) if "baseline" in order else
                                   {n for v in order
                                    for n in VERSION_SHAPES.get(v, ())})
    shapes = {n: s for n, s in every.items() if n in wanted}
    for name, (B, S, H, KV, D, causal, window) in shapes.items():
        if name == "granite_prefill_32k_full":    # the causal inputs
            inputs[name] = (*inputs["granite_prefill_32k"][:3], causal,
                            window)
        else:
            inputs[name] = tuple(
                torch.randn(B, S, h, D, generator=gen, device=dev)
                .bfloat16() for h in (H, KV, KV)) + (causal, window)
        if window is not None:      # SDPA takes no window but as a mask
            continue
        q, k, v, _, _ = inputs[name]
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        emit(flash_causal=name, library="sdpa", causal=causal,
             ms=graph_ms(lambda: sdpa(qt, kt, vt, is_causal=causal),
                         5 if S * B > 20000 else 100))
        del qt, kt, vt
    times, outs = {}, {}
    # in turns: forward, then backward through the list, CAUSAL_PAIRS times
    for turn, version in enumerate((order + order[::-1]) * CAUSAL_PAIRS):
        build.CSRC = dirs[version]
        build._loaded.clear()
        build.load("flash_attention")
        if turn < len(order):        # the tma_wgmma kernels' lines, once
            lines, mine = [], False
            for line in build.ptxas_report("flash_attention").splitlines():
                if "Compiling" in line or "Potential" in line:
                    mine = "wgmma" in line
                if mine and "Function properties" not in line:
                    lines.append(line.strip())
            emit(flash_causal="ptxas", version=version, lines=lines)
            sass = subprocess.run(
                [str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
                 str(build._library("flash_attention"))],
                capture_output=True, text=True).stdout
            (dirs[version].parent / "flash_attention.sass").write_text(sass)
            counts = {}
            for part in sass.split("Function : ")[1:]:
                m = re.match(r"\S*wgmma_kernelILi(\d+)ELi(\d+)E(?:Lb(\d))?",
                             part)
                if m:
                    counts[f"D={m[2]}" + (" banded" if m[3] == "1" else
                                          "")] = len(re.findall(
                        r"^\s+/\*[0-9a-f]{4,}\*/\s", part, flags=re.MULTILINE))
            emit(flash_causal="sass", version=version, instructions=counts)
        for name, (q, k, v, causal, window) in inputs.items():
            if version in VERSION_SHAPES and \
                    name not in VERSION_SHAPES[version]:
                continue
            assert fa.variant(q, k, v) == "tma_wgmma"
            fn = lambda: fa.flash_attention(q, k, v, causal=causal,
                                            window=window)
            if (version == "as built" or version in EXACT) and \
                    (version, name) not in outs:
                outs[version, name] = fn()
            times.setdefault((name, version), []).append(
                graph_ms(fn, 5 if q.shape[0] * q.shape[1] > 20000 else 100))
    for (name, version), ms in times.items():
        emit(flash_causal=name, version=version, ms=min(ms),
             median_ms=statistics.median(ms), n=len(ms))
        # each version against the as-built kernel timed in the same pass
        if version != "as built":
            ratios = [a / b for a, b in zip(times[name, "as built"], ms)]
            emit(flash_causal=name, version=version,
                 as_built_faster_in=sum(r < 1.0 for r in ratios),
                 of=len(ratios), median_as_built_ratio=statistics.median(
                     ratios))
    for (version, name), b in outs.items():
        if version == "as built":
            continue
        a = outs["as built", name]
        emit(flash_causal=name, version=version,
             bit_equal_to_as_built=bool(torch.equal(
                 a.view(torch.int16), b.view(torch.int16))),
             values_equal=bool(torch.equal(a, b)),
             max_abs_diff=float((a.float() - b.float()).abs().max()))


def bwd_reps(x) -> int:
    """Calls a graph replays: ~0.5 GB of x, dy and dx, 10 to 200."""
    return max(10, min(200, int(5e8 // (3 * x.numel() * x.element_size()))))


def rmsnorm_bwd(dirs, baseline, gen, dev) -> None:
    """The ``rmsnorm_bwd`` group: each version of ``dirs`` it names
    built and timed in turns at ``RMSNORM_BWD_SHAPES``, bf16 and f32,
    beside the library's backward; the real versions checked against the
    plain version.  ``baseline``: the older checkout's wrapper module."""
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rmsnorm as rn
    order = [v for v in dirs if v in GROUP_VERSIONS["rmsnorm_bwd"]]
    inputs = {}
    for R, d in RMSNORM_BWD_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(R, d, generator=gen, device=dev).to(dt)
            s = (torch.randn(d, generator=gen, device=dev) * 0.1).to(dt)
            dy = torch.randn(R, d, generator=gen, device=dev).to(dt)
            inputs[R, d, dt] = (x, s, dy)
    fused = torch.ops.aten._fused_rms_norm_backward
    for (R, d, dt), (x, s, dy) in inputs.items():
        w = (1.0 + s.float()).to(dt)
        rstd = torch.ops.aten._fused_rms_norm(x, [d], w, rn.EPS)[1]
        lib = lambda x, w, dy: fused(dy, x, [d], rstd, w, [True, True])
        reps = bwd_reps(x)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = torch.nn.functional.rms_norm(xl, (d,), weight=wl, eps=rn.EPS)
        emit(rmsnorm_bwd=[R, d], dtype=str(dt)[6:],
             library="aten._fused_rms_norm_backward",
             ms=graph_ms(lambda: lib(x, w, dy), reps),
             cold_ms=cold_ms(lib, (x, w, dy)),
             autograd_eager_ms=timed_ms(lambda: torch.autograd.grad(
                 y, (xl, wl), dy, retain_graph=True), reps))
        del y, xl, wl
    best = {}
    for version in order + order[::-1]:          # in turns
        build.CSRC = dirs[version]
        build._loaded.clear()
        call = baseline.rmsnorm_bwd if version == "baseline" \
            else rn.rmsnorm_bwd
        for (R, d, dt), (x, s, dy) in inputs.items():
            key = (R, d, str(dt)[6:], version)
            reps = bwd_reps(x)
            row = dict(ms=graph_ms(lambda: call(x, s, dy), reps),
                       cold_ms=cold_ms(call, (x, s, dy)))
            if version in RMSNORM_BWD_REAL:
                row["eager_ms"] = timed_ms(lambda: call(x, s, dy), reps)
                if key not in best:
                    dx, ds = call(x, s, dy)
                    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy)
                    tol = ref.rmsnorm_bwd_tolerance(x, s, dy)
                    row.update(
                        dx_ok=bool(torch.allclose(dx.float(), want_dx.float(),
                                                  **tol["dx"])),
                        dscale_ok=bool(torch.allclose(
                            ds.float(), want_ds.float(), **tol["dscale"])),
                        max_abs_err=max(
                            float((dx.float() - want_dx.float()).abs().max()),
                            float((ds.float() - want_ds.float()).abs().max())))
            old = best.get(key)
            best[key] = row if old is None else dict(old, **{
                k: min(v, old[k]) for k, v in row.items()
                if k.endswith("ms")})
    for (R, d, dt, version), row in best.items():
        emit(rmsnorm_bwd=[R, d], dtype=dt, version=version, **row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose kernels and wrappers to measure")
    ap.add_argument("--only", nargs="+", choices=sorted(GROUP_VERSIONS),
                    default=sorted(GROUP_VERSIONS))
    ap.add_argument("--baseline", type=Path, default=None,
                    help="checkout whose admission.cu (admission group), "
                         "flash_attention.cu (flash_causal group) or "
                         "rmsnorm.cu (rmsnorm_bwd group) is timed beside "
                         "this one's")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import rmsnorm as rn

    if not torch.cuda.is_available():
        print("kernel_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit(card=card, root=str(args.root), groups=args.only)
    csrc = build.CSRC
    wanted = [v for v in VERSIONS
              if any(v in GROUP_VERSIONS[g] for g in args.only)]
    dirs = {v: patched_csrc(csrc, v, VERSIONS[v]) for v in wanted}
    if args.baseline is not None and {"admission", "flash_causal",
                                      "rmsnorm_bwd"} & set(args.only):
        dirs["baseline"] = patched_csrc(
            args.baseline / "src" / "repro_torch" / "kernels" / "csrc",
            "baseline", {})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rms = torch.nn.functional.rms_norm

    moe = {"gate_up": (40, 1024, 1536, 512), "down": (40, 1024, 512, 1536)}
    moe_in = {k: tuple((torch.randn(*s, generator=gen, device=dev) * 0.1)
                       .to(torch.bfloat16) for s in ((E, C, d), (E, d, f)))
              for k, (E, C, d, f) in moe.items()}
    fl_in = {B: tuple(torch.randn(B, 578, 12, 64, generator=gen, device=dev)
                      for _ in range(3)) for B in (1, 8)}
    wide_in = {(B, S, D): tuple(
        torch.randn(B, S, 16, D, generator=gen, device=dev).bfloat16()
        for _ in range(3)) for B, S, D in ((8, 578, 80), (1, 730, 80),
                                           (2, 730, 80), (8, 730, 80),
                                           (8, 1024, 72))}
    rn_in = {(R, d, dt): ((torch.randn(R, d, generator=gen, device=dev))
                          .to(dt), (torch.randn(d, generator=gen, device=dev)
                                    * 0.1).to(dt))
             for R, d in ((4096, 5376), (4096, 1536), (7, 7168))
             for dt in (torch.bfloat16, torch.float32)}

    if "wgmma" in args.only:
        for k, (x, w) in moe_in.items():
            emit(moe_gemm=k, library="torch.bmm",
                 ms=graph_ms(lambda: torch.bmm(x, w), 20))
        for B, t in fl_in.items():
            qt, kt, vt = (a.bfloat16().transpose(1, 2).contiguous()
                          for a in t)
            emit(flash_attention=B, dtype="bfloat16", library="sdpa",
                 ms=graph_ms(lambda: sdpa(qt, kt, vt), 100))
    if "flash_f32" in args.only:
        for B, t in fl_in.items():
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in t)
            emit(flash_attention=B, dtype="float32", library="sdpa",
                 ms=graph_ms(lambda: sdpa(qt, kt, vt), 20))
    if "flash_wide" in args.only:
        for key, t in wide_in.items():
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in t)
            emit(flash_attention=key, dtype="bfloat16", library="sdpa",
                 ms=graph_ms(lambda: sdpa(qt, kt, vt), 50))
    if "rmsnorm" in args.only:
        for (R, d, dt), (x, s) in rn_in.items():
            weight = (1.0 + s.float()).to(dt)
            emit(rmsnorm=[R, d], dtype=str(dt)[6:], library="F.rms_norm",
                 ms=graph_ms(lambda: rms(x, (d,), weight=weight,
                                         eps=rn.EPS), 200))

    if "flash_causal" in args.only:
        flash_causal(dirs, gen, dev)
        dirs = {v: p for v, p in dirs.items()
                if v not in GROUP_VERSIONS["flash_causal"] or any(
                    v in GROUP_VERSIONS[g] for g in args.only
                    if g != "flash_causal")}

    if "rmsnorm_bwd" in args.only:
        baseline = None
        if "baseline" in dirs:      # the older wrapper, on this build module
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "baseline_rmsnorm", args.baseline / "src" / "repro_torch"
                / "kernels" / "rmsnorm.py")
            baseline = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(baseline)
        rmsnorm_bwd(dirs, baseline, gen, dev)
        dirs = {v: p for v, p in dirs.items()
                if v not in GROUP_VERSIONS["rmsnorm_bwd"] or any(
                    v in GROUP_VERSIONS[g] for g in args.only
                    if g != "rmsnorm_bwd")}

    if "admission" in args.only:
        adm_in = {KN: admission_inputs(gen, *KN, dev)
                  for KN in ADMISSION_SHAPES}
        order = [v for v in dirs if v in GROUP_VERSIONS["admission"]]
        best = {}
        for version in order + order[::-1]:      # in turns
            build.CSRC = dirs[version]
            build._loaded.clear()
            for (K, N), (ff, lc) in adm_in.items():
                for kernel, a in (("fleet_feasibility", ff),
                                  ("link_cost", lc)):
                    fn = getattr(ops, kernel)
                    ms = graph_ms(lambda: fn(*a), 1000)
                    key = (kernel, K, N, version)
                    best[key] = min(best.get(key, ms), ms)
        for (kernel, K, N, version), ms in best.items():
            emit(admission=kernel, K=K, N=N, version=version, ms=ms)
        dirs = {v: p for v, p in dirs.items()
                if v not in GROUP_VERSIONS["admission"] or any(
                    v in GROUP_VERSIONS[g] for g in args.only
                    if g != "admission")}

    for version, path in dirs.items():       # each version built anew
        build.CSRC = path
        build._loaded.clear()
        if "wgmma" in args.only and version in GROUP_VERSIONS["wgmma"]:
            for k, (x, w) in moe_in.items():
                assert mg.variant(x, w) == "tma_wgmma"
                emit(moe_gemm=k, version=version,
                     ms=graph_ms(lambda: mg.moe_gemm(x, w), 20))
            for B, t in fl_in.items():
                q, kk, v = (a.bfloat16() for a in t)
                assert fa.variant(q, kk, v) == "tma_wgmma"
                emit(flash_attention=B, dtype="bfloat16", version=version,
                     ms=graph_ms(lambda: fa.flash_attention(
                         q, kk, v, causal=False), 100))
        if "flash_wide" in args.only and \
                version in GROUP_VERSIONS["flash_wide"]:
            for (B, S, D), (q, kk, v) in wide_in.items():
                assert fa.variant(q, kk, v) == "tma_wgmma"
                emit(flash_attention=[B, S, D], dtype="bfloat16",
                     version=version, ms=graph_ms(lambda: fa.flash_attention(
                         q, kk, v, causal=False), 50))
                if version == "as built":
                    out = torch.empty_like(q)
                    mma = fa._lib("flash_attention_launch")

                    def mma_sync():
                        index, stream = build.stream_of(dev)
                        build.raise_on("flash_attention (mma_sync)", mma(
                            q.data_ptr(), kk.data_ptr(), v.data_ptr(),
                            out.data_ptr(), B, S, 16, 16, D, D ** -0.5, 0,
                            0, 1, index, stream))
                    emit(flash_attention=[B, S, D], dtype="bfloat16",
                         version="mma_sync", ms=graph_ms(mma_sync, 10))
        if "flash_f32" in args.only and version in GROUP_VERSIONS["flash_f32"]:
            for B, (q, kk, v) in fl_in.items():
                emit(flash_attention=B, dtype="float32", version=version,
                     variant=fa.variant(q, kk, v),
                     ms=graph_ms(lambda: fa.flash_attention(
                         q, kk, v, causal=False), 20))
        if "rmsnorm" in args.only and version in GROUP_VERSIONS["rmsnorm"]:
            for (R, d, dt), (x, s) in rn_in.items():
                emit(rmsnorm=[R, d], dtype=str(dt)[6:], version=version,
                     ms=graph_ms(lambda: rn.rmsnorm(x, s), 200))
                if version == "as built" and dt == torch.bfloat16:
                    s32 = s.float()
                    emit(rmsnorm=[R, d], dtype="bfloat16",
                         version="scale cast outside",
                         ms=graph_ms(lambda: rn.rmsnorm(x, s32), 200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
