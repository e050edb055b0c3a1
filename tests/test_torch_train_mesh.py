"""Granite-3.0 MoE's meshed train step on the CPU against the golden's
``granite_mesh`` sections (``tests/data/torch_train_golden.npz``: the
reference's jitted step under its one-device mesh with
``install_rules(kind="train")``, its MoE differentiated through
``moe_ffn_sharded``'s ``shard_map``).

Full width, depth cut 32 -> 2, B = 1 x 1,100 tokens, f32 and bf16, every
leaf random: the port's step under a 1 x 1 mesh of one gloo rank with its
own ``install_rules(kind="train")`` (``train_golden.section_mesh``), held
to ``train_golden.LIMITS`` as the card holds it (``chip_smoke.py`` phase
6b).  The port's step without the mesh (the padded experts 40-47 routed,
the capacity from 48 experts) must fail the f32 section.  About 11 GB of
host memory and 50 s a step on an 8-core CPU.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import train_golden as tg  # noqa: E402
from repro_torch.models import common  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_train_golden.npz"
SECTIONS = ("granite_mesh/float32", "granite_mesh/bfloat16")


@pytest.fixture(scope="module")
def golden():
    if not GOLDEN.exists():
        pytest.fail(f"{GOLDEN} is missing: run tests/make_torch_train_golden.py")
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def drawn():
    """The sections' weights (f32 numpy, the same for both dtypes)."""
    return tg.numpy_weights(tg.port_configs()[SECTIONS[0]])


@pytest.fixture
def weights(drawn):
    """A copy of the drawn weights: an f32 step on the CPU updates the
    arrays its parameters were made from in place."""
    return common.tree_map(np.array, drawn)


@pytest.mark.parametrize("name", SECTIONS)
def test_granite_mesh_sections_on_the_cpu(golden, weights, name):
    cfg = tg.port_configs()[name]
    rec, losses = tg.port_record(name, cfg, golden, tree=weights)
    shares = tg.compare(rec, golden, name, cfg.param_dtype)
    assert not tg.fails(shares), tg.fails(shares)
    np.testing.assert_allclose(
        losses, golden[name + "/losses"],
        rtol=tg.LIMITS[cfg.param_dtype]["metric"])


def test_granite_mesh_section_rejects_the_unmeshed_step(golden, weights):
    """The planted fault: the port's step without its mesh (``moe_ffn``:
    the padded experts routed, the capacity from 48 experts) against the
    meshed f32 section: the aux loss, the router's and the expert
    weights' gradients among the checks past their limits."""
    name = SECTIONS[0]
    cfg = tg.port_configs()[name]
    rec, _ = tg.port_record(name, cfg, golden, tree=weights, meshed=False)
    bad = tg.fails(tg.compare(rec, golden, name, cfg.param_dtype))
    assert f"{name}/metrics/aux_loss" in bad
    assert f"{name}/layers/router/g" in bad, sorted(bad)
