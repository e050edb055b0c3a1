"""BENCHMARK.json against the rules it is held to, and every file it
names found by name."""
import json
import re

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.load_benchmark()


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    for w in cmd:
        assert not w.startswith("/") and ".." not in w


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_kinds():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert one_line(metric["layer"])
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    cells = [w["name"] for w in BENCH["workloads"]]
    assert all(c in cells for c in metric.get("workloads", []))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    assert (spec.HERE / "metrics" / f"{metric['name']}.py").is_file()


def test_setup_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and one_line(cell["why"])
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    cfg = spec.config(BENCH, cell["config"])
    mix = spec.traffic(cell["traffic"])
    assert (spec.HERE / "drivers" / f"{cfg['driver']}.py").is_file()
    assert mix["classes"]
    assert "label_gap" in spec.limits(cell["name"])
    assert set(spec.limits(cell["name"])) <= {"label_gap", "labels_moved"}
    # every cell reports setup_s, another end-to-end and a per-layer metric
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell["name"], True)
    for m in spec.metrics_of(BENCH, cell["name"], True):
        assert callable(spec.reader(m["name"]))


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert one_line(cfg["source"]) and one_line(cfg["why"])
    assert cfg["file"].startswith("perfbench/configs/")
    on_disk = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert on_disk["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert on_disk["source"] == cfg["source"]
    assert all(NAME.match(k) for k in cfg["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert cfg["name"] in used
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_files_under_paths_named_from_name_characters():
    for f in spec.HERE.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(spec.ROOT).as_posix()
        assert PATH.match(rel), rel
