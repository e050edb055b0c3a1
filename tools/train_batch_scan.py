"""Peak memory and step time of a diffusion train step over global
batches, on one NVIDIA GPU: the data behind ``chip_smoke.py``'s
``UNET_TRAIN_BATCH``.

    python3 tools/train_batch_scan.py [--arch unet-sd15] [--batch 8 32 48 64]

Runs ``chip_smoke.diffusion_train`` (the published config at full width
and depth, train_256's 256 px, bf16 weights, f32 moments, through
``launch.train``'s ``run``: a warm step, a profiled one, two timed) at
each batch in turn, and stops at the first that runs out of memory.  The
per-sample slope and the intercept of the peaks (a least-squares line)
say how large a batch fits.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="unet-sd15",
                    choices=("unet-sd15", "dit-xl2"))
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32, 48, 64])
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config

    if not torch.cuda.is_available():
        print("train_batch_scan: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}", flush=True)
    cfg = get_config(args.arch)
    rows = []
    for B in args.batch:
        try:
            row = cs.diffusion_train(args.arch, cfg, B, torch.device("cuda"))
        except torch.cuda.OutOfMemoryError as e:
            print(f"{args.arch} B={B}: out of memory ({str(e)[:160]})",
                  flush=True)
            break
        finally:
            torch.cuda.empty_cache()
        rows.append((B, row["peak_gb"], row["ms"]))
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    if len(rows) >= 2:
        b, peak = np.array([r[0] for r in rows]), np.array([r[1] for r in rows])
        slope, icpt = np.polyfit(b, peak, 1)
        print(f"{args.arch}: peak = {icpt:.2f} GB + {slope:.4f} GB a sample "
              f"(B {list(b)}); the card holds {total:.2f} GB; "
              f"{(total - icpt) / slope:.1f} samples would fill it", flush=True)
    for B, peak, ms in rows:
        print(f"{args.arch} B={B}: peak {peak:.2f} GB, {ms:.1f} ms a step, "
              f"{B / (ms / 1e3):.1f} images/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
