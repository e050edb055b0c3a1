"""Where the time of the two TMA / wgmma kernels goes, on one NVIDIA GPU.

    python3 tools/kernel_ablation.py

Builds four versions of ``moe_gemm.cu`` and ``flash_attention.cu`` from
patched copies of ``src/repro_torch/kernels/csrc`` (under
``build/ablation/``): as they are, without the products (no wgmma is
issued: what remains is the loads, the pipeline's waits and, for
flash_attention, the softmax), without the loads (the producer arrives on
each stage without a TMA copy: products on stale tiles), and without
either.  Times each with CUDA events around launches replayed from one
CUDA graph, at the Granite-3.0 MoE gate/up and down products (bf16) and
at DeiT-B's attention at 384 px (S=578, 12 heads, D=64, bf16) for B=1
(split keys) and B=8, beside ``torch.bmm`` and
``scaled_dot_product_attention``.  The patched kernels compute garbage;
only their times mean anything.  Prints one JSON object per line.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402

# (pattern, replacement) per source: the products, then the loads
PRODUCTS = {
    "moe_gemm": [(r"hopper::wgmma_ss<1>\(.*?kb > 0 \|\| kk > 0\);", "")],
    "flash_attention": [
        (r"hopper::wgmma_ss<0>\(sc,.*?kk > 0\);", ""),
        (r"hopper::wgmma_rs<1>\(acc, pa\[kk\],.*?1\);", "")],
}
LOADS = {
    "moe_gemm": [
        (r"hopper::mbar_arrive_expect_tx\(&full\[stage\], kStageBytes\);",
         "hopper::mbar_arrive(&full[stage]);"),
        (r"hopper::tma_load_3d\(st, &tmx.*?kb \* kBK, e\);", "")],
    "flash_attention": [
        (r"hopper::mbar_arrive_expect_tx\(&full\[stage\], L::kStage\);",
         "hopper::mbar_arrive(&full[stage]);"),
        (r"hopper::tma_load_4d\(st \+ x \* kBox, &tmk.*?i \* kKeys, b\);", ""),
        (r"hopper::tma_load_4d\(st \+ L::kTile.*?i \* kKeys, b\);", "")],
}
VERSIONS = {"as built": (), "no products": (PRODUCTS,), "no loads": (LOADS,),
            "neither": (PRODUCTS, LOADS)}


def patched_csrc(name: str, cuts) -> Path:
    out = ROOT / "build" / "ablation" / name.replace(" ", "_") / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(build.CSRC, out)
    for source in ("moe_gemm", "flash_attention"):
        path = out / f"{source}.cu"
        text = path.read_text()
        for cut in cuts:
            for pattern, repl in cut[source]:
                text, n = re.subn(pattern, repl, text, flags=re.DOTALL)
                if n == 0:
                    raise SystemExit(f"kernel_ablation: {pattern!r} not "
                                     f"found in {source}.cu")
        path.write_text(text)
    return out


def graph_ms(fn, reps: int) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    dirs = {v: patched_csrc(v, cuts) for v, cuts in VERSIONS.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    moe = {"gate_up": (40, 1024, 1536, 512), "down": (40, 1024, 512, 1536)}
    moe_in = {k: ((torch.randn(E, C, d, generator=gen, device=dev) * 0.1).to(
        torch.bfloat16), (torch.randn(E, d, f, generator=gen, device=dev)
                          * 0.1).to(torch.bfloat16))
        for k, (E, C, d, f) in moe.items()}
    fl_in = {B: tuple(torch.randn(B, 578, 12, 64, generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(3)) for B in (1, 8)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for k, (x, w) in moe_in.items():
        print(json.dumps({"moe_gemm": k, "library": "torch.bmm",
                          "ms": graph_ms(lambda: torch.bmm(x, w), 20)}),
              flush=True)
    for B, (q, kk, v) in fl_in.items():
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kk, v))
        print(json.dumps({"flash_attention": B, "library": "sdpa",
                          "ms": graph_ms(lambda: sdpa(qt, kt, vt), 100)}),
              flush=True)
    for version, path in dirs.items():       # each version built anew
        build.CSRC = path
        build._loaded.clear()
        for k, (x, w) in moe_in.items():
            assert mg.variant(x, w) == "tma_wgmma"
            print(json.dumps({"moe_gemm": k, "version": version,
                              "ms": graph_ms(lambda: mg.moe_gemm(x, w), 20)}),
                  flush=True)
        for B, (q, kk, v) in fl_in.items():
            assert fa.variant(q, kk, v) == "tma_wgmma"
            print(json.dumps({"flash_attention": B, "version": version,
                              "ms": graph_ms(lambda: fa.flash_attention(
                                  q, kk, v, causal=False), 100)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
