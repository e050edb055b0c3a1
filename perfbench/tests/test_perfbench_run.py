"""A whole run at a smoke size on the CPU through the kernels' plain
versions, past the look for a chip: its result's line, and ``correct``
false with the timed path broken underneath."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import control, run, spec
from perfbench.tests import smoke

BENCH = spec.load_benchmark()
SEED = 2 ** 31 + 2024


def run_smoke(traffic, trace=False, hooks=None, seed=SEED, seconds=0.2,
              frames=48):
    cell = smoke.cell(traffic)
    return run.run_cell(BENCH, cell, smoke.config(), smoke.mix(traffic, frames),
                        smoke.limits(), seed, seconds, trace, "cpu", hooks)


@pytest.mark.parametrize("traffic", ["surveillance_peak", "hd_trickle"])
@pytest.mark.parametrize("trace", [False, True])
def test_smoke_run_line(traffic, trace):
    line = run_smoke(traffic, trace, seconds=1.0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 48
    json.dumps(line)
    cell = smoke.cell(traffic)["name"]
    want = {m["name"] for m in spec.metrics_of(BENCH, cell, trace)}
    got = set(line["metrics"])
    if trace:
        # the CPU has no flash kernel on its trace
        assert got == want - {"flash_roofline"}
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) >= 1
    else:
        assert got == want
        m = line["metrics"]
        assert m["requests_per_s"]["value"] > 0
        assert m["request_ms_p95"]["unit"] == "ms"


def test_host_and_step_add_up_to_the_rate():
    from perfbench.drivers import vision_serving
    out = vision_serving.run(smoke.config(), smoke.mix("surveillance_peak"),
                             smoke.limits(), SEED, 1.0, False, "cpu", 0.0)
    rec = out["record"]
    host = spec.reader("host_ms_per_request")(rec)
    step = spec.reader("step_ms_per_request")(rec)
    rate = spec.reader("requests_per_s")(rec)
    assert host > 0 and step > 0
    assert host + step == pytest.approx(1e3 / rate, rel=1e-9)
    assert 0 < spec.reader("mfu")(rec) < 100


def altered(rb, leaves):
    def call(name, frames):
        out = rb(name, frames)
        return [(out[0] + 1) % smoke.MODEL["n_classes"]] + out[1:]
    return call


def half_batch(rb, leaves):
    def call(name, frames):
        keep = (len(frames) + 1) // 2
        out = rb(name, frames[:keep])
        return [out[i % keep] for i in range(len(frames))]
    return call


def stale(rb, leaves):
    last = []

    def call(name, frames):
        out = rb(name, frames)
        prev = last[-1] if last else out
        last.append(out)
        return [prev[i % len(prev)] for i in range(len(frames))]
    return call


def fifo():
    from repro_torch.core.queues import FIFOQueue
    return FIFOQueue()


@pytest.mark.parametrize("traffic,fault,hooks,fails", [
    ("surveillance_peak", "answer altered", dict(run_batch=altered), "label_gap"),
    ("hd_trickle", "answer altered", dict(run_batch=altered), "label_gap"),
    ("surveillance_peak", "half the batch left out", dict(run_batch=half_batch),
     "label_gap"),
    ("surveillance_peak", "answers of the call before", dict(run_batch=stale),
     "label_gap"),
    ("hd_trickle", "answers of the call before", dict(run_batch=stale),
     "label_gap"),
    ("surveillance_peak", "FIFO queues", dict(queue=fifo),
     "decisions_differing"),
], ids=lambda x: x if isinstance(x, str) else "")
def test_fault_is_not_correct(traffic, fault, hooks, fails):
    line = run_smoke(traffic, hooks=hooks)
    assert line["correct"] is False, fault
    c = line["checks"][fails]
    assert c["value"] > c["limit"], (fault, line["checks"])


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_is_not_correct(seed):
    """The reference computed in fp8 in the program's place fails the
    label gap's limit."""
    line = run_smoke("surveillance_peak",
                     hooks=dict(run_batch=control.fp8_in_place(smoke.MODEL)),
                     seed=seed, frames=96)
    c = line["checks"]["label_gap"]
    assert line["correct"] is False and c["value"] > c["limit"], c


def test_no_result_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the look passes")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and the files under
    ``paths`` prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


def test_warmup_is_untimed_and_settles():
    from perfbench.drivers import vision_serving as vs
    assert vs.WARMUP_MIN_S == 3.0
    assert not vs._steady([3.0]) and not vs._steady([1.2, 2.0])
    assert not vs._steady([1.0, 1.01]) and vs._steady([1.2, 1.01, 1.0])
    out = vs.run(smoke.config(), smoke.mix("hd_trickle"), smoke.limits(),
                 SEED, 0.2, False, "cpu", 0.0)
    rec = out["record"]
    warm = rec["warmup_episodes"]
    assert 2 <= len(warm) <= vs.WARMUP_MAX
    assert sum(warm) >= vs.WARMUP_MIN_S or len(warm) == vs.WARMUP_MAX
    t0, _ = rec["window"]
    assert rec["calls"] and all(c[0] >= t0 for c in rec["calls"])
    assert out["attempted"] == 48 * len(rec["episode_ends"])


def test_slice_replays_the_windows_first_episodes():
    """The profiled slice serves the window's first episodes again, so its
    batches are theirs, and keeps their unprofiled wall time."""
    from perfbench.drivers import vision_serving
    out = vision_serving.run(smoke.config(), smoke.mix("surveillance_peak"),
                             smoke.limits(), SEED, 1.5, True, "cpu", 0.0)
    rec = out["record"]
    tr = rec["trace"]
    window = [(n, res) for _, _, n, res in rec["calls"]]
    assert tr["calls"] == window[:len(tr["calls"])]
    t = [rec["window"][0]] + rec["episode_ends"]
    assert tr["unprofiled_s"] in [b - t[0] for b in t[1:]]
