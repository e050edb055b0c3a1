"""Run one cell of the benchmark and print its result as the last line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the profiled slice's busy and
window seconds and breakdown.  Each number the correctness check
compares is printed with its limit as the last lines of standard error
and under ``checks``, the line's last key.  The run exits non-zero and
prints no result without the CUDA devices the cell asks for, without
the program beside the benchmark, or if ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` is loaded once the window has closed.

Every build and kernel cache lives under ``build/`` in the checkout.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_caches(root: Path) -> None:
    """Fixed cache directories inside the checkout; JAX kept out of the
    libraries that would load it on their own."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names=None) -> list:
    """The top-level names among ``names`` (default: the loaded modules)
    that are one of ``FORBIDDEN``, each compared whole (``repro_torch`` is
    not ``repro``)."""
    return sorted({n.split(".")[0] for n in (names or list(sys.modules))}
                  & set(FORBIDDEN))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    set_caches(ROOT)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from perfbench import spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"perfbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    cfg = spec.config(bench, cell["config"], ROOT)
    mix = spec.traffic(cell["traffic"])
    torch.set_num_threads(1)
    line = run_cell(bench, cell, cfg, mix, spec.limits(cell["name"]),
                    args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def run_cell(bench: dict, cell: dict, cfg: dict, mix: dict, limits: dict,
             seed: int, seconds: float, trace: bool, device: str,
             hooks=None) -> dict:
    """The run past the look for the devices: the result's line, its
    ``checks`` last."""
    import torch
    from perfbench import spec
    out = spec.driver(cfg["driver"]).run(cfg, mix, limits, seed, seconds,
                                         trace, device, T_PROCESS, hooks)
    rec = out["record"]
    cuda = device.startswith("cuda")
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=cell["chips"], memory_peak_bytes=out["memory_peak_bytes"])
    line = dict(correct=all(c["value"] <= c["limit"]
                            for c in out["checks"].values()),
                attempted=out["attempted"], failed=out["failed"],
                metrics=spec.read_metrics(bench, cell["name"], trace, rec),
                device=dev)
    if trace:
        tr = rec["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = dict(device_ops=tr["device_ops"],
                                 idle_gaps=tr["idle_gaps"])
    t = [rec["window"][0]] + rec["episode_ends"]
    print(f"perfbench: set-up {[(n, round(s, 3)) for n, s in rec['setup_parts']]}"
          f" s; warm-up episodes {[round(s, 3) for s in rec['warmup_episodes']]}"
          " s; the window's episodes took "
          f"{[round(b - a, 3) for a, b in zip(t, t[1:])]} s", file=sys.stderr)
    if trace:
        print(f"perfbench: the profiled slice took {tr['window_s']:.4f} s, "
              f"the same episodes {tr['unprofiled_s']:.4f} s unprofiled; "
              f"device busy {tr['busy_s']:.4f} s", file=sys.stderr)
    line["checks"] = out["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
