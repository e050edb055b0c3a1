"""Where the time of the port's redesigned kernels goes, on one NVIDIA GPU.

    python3 tools/kernel_ablation.py [--root CHECKOUT] [--only GROUP ...]

Builds versions of the kernel sources from patched copies of
``src/repro_torch/kernels/csrc`` (under ``build/ablation/``) and times
each with CUDA events around launches replayed from one CUDA graph.
``--root`` takes the sources and the wrappers from another checkout (an
unpacked older commit, to measure the kernels it had).  Five groups:

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
  backward through the list; the better of the two).

The patched kernels compute garbage; only their times mean anything.
Prints one JSON object per line, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
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
}
GROUP_VERSIONS = {
    "wgmma": ("as built", "no products", "no loads", "neither"),
    "flash_f32": ("as built", "no products", "no loads", "neither"),
    "flash_wide": ("as built", "no products", "no loads"),
    "rmsnorm": ("as built", "constant scale"),
    "admission": ("as built", "rows in place", "empty kernel", "baseline"),
}
ADMISSION_SHAPES = ((256, 1024), (32, 512), (3, 1024), (6, 1024),
                    (2, 256), (2, 512), (2, 1024), (5, 256))


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
    out = ROOT / "build" / "ablation" / name.replace(" ", "_") / "csrc"
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


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose kernels and wrappers to measure")
    ap.add_argument("--only", nargs="+", choices=sorted(GROUP_VERSIONS),
                    default=sorted(GROUP_VERSIONS))
    ap.add_argument("--baseline", type=Path, default=None,
                    help="checkout whose admission.cu the admission group "
                         "times beside this one's")
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
    if "admission" in args.only and args.baseline is not None:
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
