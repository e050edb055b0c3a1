"""Nothing the benchmark runs loads JAX, the JAX package ``repro`` or the
old benchmark, and the references import nothing of the program.  Each
module's top-level name is compared whole: ``repro_torch`` begins with
``repro`` and is allowed."""
import ast
import subprocess
import sys

import pytest

from perfbench import run, spec

SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_sources_import_nothing_banned(path):
    assert not imported_roots(path) & BANNED
    text = path.read_text()
    assert "BENCH_" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert imported_roots(path) <= {"__future__", "math", "random", "typing",
                                    "torch"}


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.launch.serve",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                 "repro"]


def test_a_run_loads_no_banned_module():
    code = (
        "import sys\n"
        "from perfbench import run, spec\n"
        "from perfbench.tests import smoke\n"
        "bench = spec.load_benchmark()\n"
        "line = run.run_cell(bench, smoke.cell('surveillance_peak'), "
        "smoke.config(), smoke.mix('surveillance_peak', 24), smoke.limits(), "
        "5, 0.1, True, 'cpu')\n"
        "assert line['correct'], line['checks']\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": f"{spec.ROOT / 'src'}:{spec.ROOT}"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & BANNED, loaded & BANNED
