"""One short run of a cell on the card, at its own size, through the
harness past the look for the devices.  Skips without a CUDA device
(decided inside the fixture)."""
import pytest

from perfbench import run, spec


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels and graphs")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", ["deit_b.surveillance_peak"])
def test_cell_runs_correct_on_the_card(cuda, cell_name):
    bench = spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    run.set_caches(run.ROOT)
    line = run.run_cell(bench, cell, spec.config(bench, cell["config"]),
                        spec.traffic(cell["traffic"]), spec.limits(cell_name),
                        2 ** 31 + 77, 2.0, False, cuda)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["requests_per_s"]["value"] > 0
