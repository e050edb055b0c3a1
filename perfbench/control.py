"""Readings that the limits of a cell's check are set from, on the card.

    python3 -m perfbench.control --workload <cell> --seconds <s> \\
        --program-seeds 1 2 ... --control-seeds 1 2 3 \\
        [--control-seconds <s>] [--out <file>]

Each seed is one short run of the cell through its driver, in this
process, with the cell's own mix and sizes and the checks' readings
taken as the run's check takes them.  A program seed runs the program;
a control seed puts the control in the program's place
(:func:`fp8_in_place`): the plain reference with both operands of every
product in fp8 (e4m3, one scale a tensor; the precision below the
configuration's bf16), on the same weights and frames.  Every row
holds both readings, and ``correct`` under the cell's own limits (a
reading the cell does not compare has none).  Each reading is
a JSON line on standard output and, with ``--out``, in that file.  The
benchmark's own runs do not run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from perfbench import run  # noqa: E402

READINGS = ("label_gap", "labels_moved")


def fp8_in_place(model: dict):
    """A ``run_batch`` hook of the drivers: the fp8 reference's first label
    of each frame, in place of the program's."""
    def hook(run_batch, leaves):
        import torch
        from perfbench.reference import vit as ref_vit

        def call(cls_name, frames):
            x = torch.stack(frames)
            return ref_vit.logits(leaves, x, model,
                                  quant=ref_vit.fp8).argmax(-1).tolist()
        return call
    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float,
                    help="the control's window (default: --seconds)")
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.set_caches(run.ROOT)
    sys.path.insert(0, str(run.ROOT / "src"))
    from perfbench import spec
    bench = spec.load_benchmark(run.ROOT)
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"], run.ROOT)
    mix = spec.traffic(cell["traffic"])
    # both readings in every row; ``correct`` under the cell's own limits
    limits = dict(dict.fromkeys(READINGS, float("inf")),
                  **spec.limits(cell["name"]))
    sink = open(args.out, "a") if args.out else None
    try:
        fp8 = dict(run_batch=fp8_in_place(cfg["model"]))
        sides = [("program", s, None, args.seconds)
                 for s in args.program_seeds] + \
            [("control", s, fp8, args.control_seconds or args.seconds)
             for s in args.control_seeds]
        for side, seed, hooks, seconds in sides:
            line = run.run_cell(bench, cell, cfg, mix, limits, seed, seconds,
                                False, "cuda", hooks)
            row = dict(workload=cell["name"], side=side, seed=seed,
                       correct=line["correct"],
                       checks={k: v["value"] for k, v in line["checks"].items()},
                       metrics={k: v["value"]
                                for k, v in line["metrics"].items()})
            print(json.dumps(row), flush=True)
            if sink:
                sink.write(json.dumps(row) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
