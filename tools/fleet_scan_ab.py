"""The fleet simulator's ``event_scan`` kernel of two checkouts, timed in
turns on one NVIDIA GPU.

    python3 tools/fleet_scan_ab.py --other CHECKOUT [--reps 3]

``CHECKOUT`` is another tree with ``src/repro_torch`` (an unpacked older
commit, or a copy with an edited kernel).  Each timing runs in a process
of its own on one tree's ``src/`` (its kernels built into that tree's
``build/kernels``), in the order other, this, this, other.  In each, for
every main-path run of ``tests/data/torch_fleetsim_golden.json``
(``paper/scenario1..3`` and the 16,000-request ``fleet32_div4``): one
``simulate`` on the card, its per-request digests held against the
golden file, then CUDA events around ``--reps`` launches of
``event_scan`` on the inputs that call gave it.  Prints the card's name
and power limit, then one JSON object per (tree, turn, run).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_fleetsim_golden.json"
RUNS = ("paper/scenario1", "paper/scenario2", "paper/scenario3",
        "fleet32_div4")


def time_tree(tree: Path, label: str, turn: int, reps: int) -> None:
    """The worker: times ``tree``'s kernel on every run (this process
    imports ``tree``'s ``repro_torch``)."""
    sys.path.insert(0, str(tree / "src"))
    import hashlib

    import numpy as np
    import torch

    from repro_torch.fleetsim import simulate, topology_arrays
    from repro_torch.kernels import event_scan as scan
    from repro_torch.netsim import LinkModel
    from repro_torch.orchestration import (Topology, fleet_workload,
                                           get_workload)

    golden = json.loads(GOLDEN.read_text())
    by_name = {r["name"]: r for r in golden["runs"]}
    for name in RUNS:
        spec = by_name[name]
        w = spec["workload"]
        wl = get_workload(w["registry"]) if "registry" in w else \
            fleet_workload(w["fleet"], w["div"])
        reqs, _ = wl.to_arrays(0)
        topo = Topology.full_mesh(spec["n_nodes"])
        kept = []
        real = scan.event_scan

        def spy(*args, **kw):
            kept.append((args, kw))
            return real(*args, **kw)

        scan.event_scan = spy
        m = simulate(reqs, topology_arrays(topo), policy=golden["policy"],
                     max_forwards=golden["max_forwards"],
                     capacity=spec["capacity"], depth=spec["depth"],
                     net=LinkModel.campus(topo).net_params(),
                     max_events=spec["max_events"], device="cuda")
        scan.event_scan = real
        for k, want in spec["digests"].items():
            got = hashlib.sha256(getattr(m, k).cpu().numpy().astype(
                np.int32).tobytes()).hexdigest()
            if got != want:
                raise SystemExit(f"{label} {name}: {k} differs from the "
                                 "golden run")
        args, kw = kept[0]
        real(*args, **kw)
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            real(*args, **kw)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / reps
        print(json.dumps(dict(tree=label, turn=turn, run=name,
                              events=m.events, ms=ms,
                              us_per_event=ms * 1e3 / m.events)),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        tree, label, turn = a.worker
        time_tree(Path(tree), label, int(turn), a.reps)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"other": a.other.resolve(), "this": ROOT}
    for turn, label in enumerate(("other", "this", "this", "other")):
        env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(
            trees[label] / "build" / "kernels"))
        env.pop("PYTHONPATH", None)
        subprocess.run([sys.executable, __file__, "--other", str(a.other),
                        "--reps", str(a.reps), "--worker",
                        str(trees[label]), label, str(turn)],
                       env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
