"""Training launcher (the port of ``repro/launch/train.py``).

A smoke config unless ``--full`` (the published one); on the card unless
``--device cpu``, and without a card it raises rather than fall back:

    PYTHONPATH=src python -m repro_torch.launch.train --arch deit-b \\
        --steps 100 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch \\
        granite-moe-3b-a800m --full --batch 2 --seq 4096 --steps 4
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deit-b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64, help="LM sequence length")
    ap.add_argument("--full", action="store_true",
                    help="full published config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps as S
    from repro_torch.training.train_loop import TrainLoopConfig, run

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.family == "lm":
        shape = ShapeSpec("cli", "train", seq_len=args.seq,
                          global_batch=args.batch)
    else:
        shape = ShapeSpec("cli", "train", img_res=getattr(cfg, "img_res", 64),
                          global_batch=args.batch)
    S.shapes_for(cfg)["cli"] = shape
    try:
        cell = S.build_cell(args.arch, "cli", cfg=cfg)
    finally:
        S.shapes_for(cfg).pop("cli", None)

    out = run(cell, TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, seed=args.seed), device=args.device)
    print(f"final loss {out['losses'][-1][1]:.4f} in {out['wall_s']:.1f}s")
    return out


if __name__ == "__main__":
    main()
