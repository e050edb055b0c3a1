"""The diffusion train steps (``repro_torch.models.{dit,unet}.loss_fn`` /
``make_train_step``, the ``dit`` / ``unet`` train cells of
``launch.steps``, ``launch.train``) against the JAX reference on the CPU.

Both losses draw ``t`` and ``eps`` from JAX's threefry at the batch's
``step`` (``models.prng``, bit for bit: ``tests/test_torch_prng.py``),
so the port's loss is the reference's function of the same numbers.
Tolerances: the loss within 2e-6 relative of the reference's (f32: the
same arithmetic, sums in another order, ``ddpm_alphas`` within 3.1e-7
relative); a train step as ``tests/test_torch_train_step.py`` holds the
other families' (every gradient leaf within 2e-5 of its largest |g|);
the golden sections within ``tests/train_golden.py``'s f32 limits, each
planted fault of ``train_golden.DIFFUSION_FAULTS`` past them; a resumed
run equal to the uninterrupted one bit for bit (the noise is a function
of the step: a restart that drew other noise would differ).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import train_golden as tg  # noqa: E402
from test_torch_train_step import both_configs, check_step  # noqa: E402
from repro.launch.steps import model_module as jax_module  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import common, dit  # noqa: E402
from repro_torch.training.data import Spec, SyntheticSource  # noqa: E402
from repro_torch.training.train_loop import TrainLoopConfig, run  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_train_golden.npz"
ARCHS = ("dit-xl2", "unet-sd15")
LOSS_REL = 2e-6


def smoke_batch(cfg, step, B=2):
    specs = tg.batch_specs(cfg.family, B, res=cfg.img_res, cfg=cfg)
    return SyntheticSource({k: Spec(*v) for k, v in specs.items()},
                           seed=3).batch_at(step)


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, step):
    """The loss at two steps (two draws of ``t`` and ``eps``): within
    ``LOSS_REL`` of the reference's; the noise of another step is
    another loss."""
    jcfg, tcfg = both_configs(arch)
    tree = tg.numpy_weights(tcfg)
    params = {}
    for path, d in S.model_module(tcfg).param_defs(tcfg).items():
        common.assign(params, path, jnp.asarray(common.nested(tree, path))
                      .astype(d.dtype))
    b = smoke_batch(tcfg, step)
    want = float(jax.jit(lambda p, b: jax_module(jcfg).loss_fn(p, b, jcfg)[0])(
        params, {k: jnp.asarray(v) for k, v in b.items()}))
    mod = S.model_module(tcfg)
    tp = mod.params_from_numpy(tree, tcfg, "cpu")
    with torch.no_grad():
        got = float(mod.loss_fn(tp, S.batch_to(b, "cpu"), tcfg)[0])
        other = float(mod.loss_fn(tp, S.batch_to(dict(b, step=step + 1),
                                                 "cpu"), tcfg)[0])
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    assert abs(other - want) > 10 * LOSS_REL * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """The smoke UNet's 32-channel ResBlocks normalise each channel on its
    own (32 groups), so their time-embedding projections' gradients are 0
    in exact arithmetic: noise that ``check_step`` holds to the port's
    own first step."""
    grads = check_step(arch, own_noise_moments=arch == "unet-sd15")
    assert all(np.abs(g).max() > 0 for g in grads.values())


def test_dit_train_step_with_remat_matches_reference():
    """DiT as published trains with remat: the smoke config with it on."""
    check_step("dit-xl2", remat=True)


def test_dit_remat_on_equals_remat_off_bit_for_bit():
    _, cfg = both_configs("dit-xl2")
    tree = tg.numpy_weights(cfg)
    b = S.batch_to(smoke_batch(cfg, 1), "cpu")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = dit.params_from_numpy(tree, c, "cpu")
        (loss, _), grads = common.value_and_grad(
            lambda p: dit.loss_fn(p, b, c), params)
        out.append((loss, list(common.leaves(grads))))
    assert torch.equal(out[0][0], out[1][0])
    for x, y in zip(out[0][1], out[1][1]):
        assert torch.equal(x, y)


def golden():
    if not GOLDEN.exists():
        pytest.fail(f"{GOLDEN} is missing: run tests/make_torch_train_golden.py")
    return np.load(GOLDEN)


CPU_SECTIONS = ("dit/float32", "smoke/dit-smoke", "smoke/unet-smoke")


@pytest.mark.parametrize("name", CPU_SECTIONS)
def test_golden_sections_on_the_cpu(name):
    """DiT-XL/2 at full width (2 layers) in f32 and the smoke DiT and UNet
    over 3 steps within their limits; the UNet at full width (530 M
    parameters) and the bf16 sections are held on the card
    (``chip_smoke.py`` phase 6b)."""
    g = golden()
    cfg = tg.port_configs()[name]
    rec, losses = tg.port_record(name, cfg, g)
    assert not tg.fails(tg.compare(rec, g, name, cfg.param_dtype))
    np.testing.assert_allclose(losses, g[name + "/losses"], rtol=2e-5)


@pytest.mark.parametrize("fault", sorted(tg.DIFFUSION_FAULTS))
def test_golden_rejects_planted_faults(fault):
    """Each fault on its family's smoke section (3 steps)."""
    g = golden()
    name = {"dit": "smoke/dit-smoke",
            "unet": "smoke/unet-smoke"}[tg.DIFFUSION_FAULTS[fault]]
    cfg = tg.port_configs()[name]
    with tg.planted(fault):
        rec, _ = tg.port_record(name, cfg, g)
    assert tg.fails(tg.compare(rec, g, name, cfg.param_dtype)), fault


def f32_cell(arch, B=2):
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    S.shapes_for(cfg)["t"] = ShapeSpec("t", "train", img_res=cfg.img_res,
                                       global_batch=B)
    try:
        return S.build_cell(arch, "t", cfg=cfg)
    finally:
        S.shapes_for(cfg).pop("t", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_after_kill_equals_uninterrupted(tmp_path, arch):
    """4 steps against 2, a 'kill' and a run resumed to 4 from the
    checkpoint: every parameter and moment equal bit for bit (steps 2 and
    3 draw their noise from their own step after the restart)."""
    cell = f32_cell(arch, B=1)
    quiet = dict(log_fn=lambda s: None, device="cpu")
    cfg = dict(ckpt_every=2, log_every=100, seed=7)
    full = run(cell, TrainLoopConfig(total_steps=4, **cfg), **quiet)
    run(cell, TrainLoopConfig(total_steps=2, ckpt_dir=str(tmp_path), **cfg),
        **quiet)
    logs = []
    resumed = run(cell, TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path),
                                        **cfg),
                  log_fn=logs.append, device="cpu")
    assert logs[0] == "[train] resumed from step 2"
    assert int(resumed["opt_state"].step) == 4
    for out in (full, resumed):
        out["all"] = [*common.leaves(out["params"]),
                      *common.leaves(out["opt_state"].m),
                      *common.leaves(out["opt_state"].v)]
    for x, y in zip(full["all"], resumed["all"]):
        assert torch.equal(x, y)


def test_unet_checkpoints_hold_the_reference_layout(tmp_path):
    import json
    from repro_torch.models import unet
    cell = f32_cell("unet-sd15", B=1)
    run(cell, TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path)),
        log_fn=lambda s: None, device="cpu")
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    for path, d in unet.param_defs(cell.cfg).items():
        assert manifest["shapes"]["params/" + path] == list(d.shape)
        assert manifest["shapes"]["opt/.m/" + path] == list(d.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_256_cells_build(arch):
    """The published ``train_256`` cells build: the reference's batch
    specs, the step's donation; nothing is allocated."""
    cell = S.build_cell(arch, "train_256")
    cfg = get_config(arch)
    specs = cell.arg_specs[2]
    assert specs["latents"] == Spec((256, 32, 32, 4), np.float32)
    assert specs["step"] == Spec((), np.int32)
    if arch == "dit-xl2":
        assert specs["labels"] == Spec((256,), np.int32)
    else:
        assert specs["ctx"] == Spec((256, cfg.ctx_len, cfg.ctx_dim),
                                    np.float32)
    assert cell.donate == (0, 1) and cell.label == f"{arch}:train_256"


def test_batch_keeps_the_step_on_the_host():
    cfg = get_smoke_config("dit-xl2")
    b = S.batch_to(smoke_batch(cfg, 9), "cpu")
    assert b["step"] == 9 and type(b["step"]) is int
    assert b["labels"].dtype == torch.int64


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_a_smoke_config(tmp_path, capsys, arch):
    out = train_cli.main(["--arch", arch, "--steps", "2", "--batch", "1",
                          "--device", "cpu", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "1"])
    assert "final loss" in capsys.readouterr().out
    assert [s for s, _ in out["losses"]] == [0, 1]
    assert np.isfinite(out["losses"][-1][1])
    assert (tmp_path / "step_00000002" / "manifest.json").exists()
