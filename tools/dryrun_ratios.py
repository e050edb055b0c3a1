"""The port's dry run against the JAX reference's, pair by pair: the
ratio port / reference of per-chip FLOPs, bytes moved and collective
bytes for every (cell, mesh) pair, as one markdown table (a row an
architecture, a column each of its family's four shapes).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --device cpu --out build/dryrun
    python3 tools/dryrun_ratios.py [--out build/dryrun]

Reads the port's result files in ``--out`` and the reference's numbers
from ``tests/data/torch_dryrun_golden.json``.  Each table cell reads
``F a/b · B a/b · C a/b``: FLOPs, bytes and collective bytes, ``a`` on
the 16x16 mesh and ``b`` on the 2x16x16; a FLOP ratio outside [0.98,
1.02] is marked ``*``; a skipped cell is ``skip``, a pair whose result
is missing or not ``ok`` shows its status.  The last line counts the
``ok`` pairs.
"""
from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_dryrun_golden.json")
KEYS = (("F", "flops_per_chip"), ("B", "hbm_bytes_per_chip"),
        ("C", "collective_bytes_per_chip"))
FAMILIES = (
    (("kimi-k2-1t-a32b", "granite-moe-3b-a800m", "starcoder2-7b",
      "gemma3-27b"), ("train_4k", "prefill_32k", "decode_32k", "long_500k")),
    (("vit-l16", "vit-h14", "deit-b", "resnet-50"),
     ("cls_224", "cls_384", "serve_b1", "serve_b128")),
    (("dit-xl2", "unet-sd15"),
     ("train_256", "train_1024", "gen_fast", "gen_1024")),
)


def fmt(got, want, flops=False) -> str:
    if not want:
        return "—" if not got else "∞"
    r = got / want
    mark = "*" if flops and not 0.98 <= r <= 1.02 else ""
    return f"{r:.3g}{mark}" if r < 10 else f"{r:.0f}{mark}"


def cell_text(out, pairs, arch, shape, counts) -> str:
    if f"{arch}:{shape}:single" not in pairs:
        return "skip"
    parts = {name: [] for name, _ in KEYS}
    for mesh in ("single", "multi"):
        path = os.path.join(out, f"{arch}__{shape}__{mesh}.json")
        res = json.load(open(path)) if os.path.exists(path) else {}
        if res.get("status") != "ok":
            return res.get("status", "missing")
        counts[0] += 1
        want = pairs[f"{arch}:{shape}:{mesh}"]
        for name, key in KEYS:
            parts[name].append(fmt(res[key], want[key], name == "F"))
    return " · ".join(f"{name} {'/'.join(v)}" for name, v in parts.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "dryrun"))
    args = ap.parse_args(argv)
    with open(GOLDEN) as f:
        pairs = json.load(f)["pairs"]
    counts = [0]
    print("| arch | shapes 1–4 (LM: `train_4k`, `prefill_32k`, `decode_32k`, "
          "`long_500k`; vision: `cls_224`, `cls_384`, `serve_b1`, "
          "`serve_b128`; diffusion: `train_256`, `train_1024`, `gen_fast`, "
          "`gen_1024`) | | | |")
    print("| --- | --- | --- | --- | --- |")
    for archs, shapes in FAMILIES:
        for arch in archs:
            print(f"| {arch} | " + " | ".join(
                cell_text(args.out, pairs, arch, s, counts) for s in shapes)
                + " |")
    print(f"{counts[0]} of {len(pairs)} pairs ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
