"""The port's ResNet against ``repro.models.resnet`` on the CPU, with the
same weights: ``numpy_params`` makes them with numpy, the reference gets
the numpy tree cast as its ``param_defs`` type each leaf (kernels and head
in the config's dtype, BatchNorm in f32), the port gets it through
``params_from_numpy``.

Shapes: the smoke config (depths (1, 1), width 16) at 32 px, where every
stride-2 SAME pads (0, 1), and at 30 px, where the max pool pads (1, 1)
(a side of 15) and stage 1's stride-2 conv (0, 1); a narrow 4-stage
config (width 8, depths (1, 1, 1, 1)) at 100 px, where the pool pads
(0, 1) and stages 1-3 pad odd sides (25, 13, 7) by (1, 1).  The narrow
config is not run at 32 px: its last stage is then 1 x 1, and BatchNorm
over two values a channel (a batch of two) turns rounding into
differences of order one.

Tolerances on the logits (|logit| < 2): f32 1e-4 (observed <= 1.7e-6:
the same arithmetic, sums in another order); bf16 5e-2 (observed 0.010,
0.007 and 0.029 on the three shapes: conv outputs round to the other
bf16 neighbour wherever the f32 sums' order moves them across a rounding
boundary, about one in 10^4, and BatchNorm carries that on).  At full
width against the golden file the chip check's ``RESNET_LOGIT_ATOL``, by
dtype and side: f32 3e-4 (observed 6.5e-5 / 3.1e-5 at 224 / 384 px),
bf16 0.45 / 0.3 (observed 0.365 / 0.205: ResNet-50's 16 blocks amplify
those flips); a forward whose max pool pads (1, 1) must exceed each.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import resnet50 as jresnet50
from repro.launch import serve as jserve
from repro.models import resnet as jresnet
from repro_torch.configs import get_config, resnet50
from repro_torch.launch import serve
from repro_torch.launch.steps import model_module
from repro_torch.models import common, resnet

LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
GOLDEN_ATOL = {("float32", 224): 3e-4, ("float32", 384): 3e-4,
               ("bfloat16", 224): 0.45, ("bfloat16", 384): 0.3}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_vit_golden.json")
NARROW = dict(width=8, depths=(1, 1, 1, 1), n_classes=10)


def _configs(dtype, narrow):
    kw = dict(NARROW if narrow else {}, param_dtype=dtype)
    base = "CONFIG" if narrow else "SMOKE_CONFIG"
    return (dataclasses.replace(getattr(jresnet50, base), **kw),
            dataclasses.replace(getattr(resnet50, base), **kw))


def _reference_params(tree, cfg):
    out = {}
    for path, d in resnet.param_defs(cfg).items():
        common.assign(out, path, jnp.asarray(
            common.nested(tree, path)).astype(d.dtype))
    return out


def _both(jcfg, tcfg, img, seed=0):
    """The reference's logits (jitted) and the port's on the same images."""
    tree = resnet.numpy_params(tcfg, seed)
    want = np.asarray(jax.jit(lambda p, x: jresnet.forward(p, x, jcfg))(
        _reference_params(tree, tcfg), jnp.asarray(img)))
    got = resnet.serve_step(resnet.params_from_numpy(tree, tcfg, "cpu"),
                            torch.from_numpy(img), tcfg)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("narrow,res", [(False, 32), (False, 30),
                                        (True, 100)])
def test_forward_matches_reference(narrow, res, dtype):
    jcfg, tcfg = _configs(dtype, narrow)
    img = np.random.default_rng(res).random((2, res, res, 3),
                                            dtype=np.float32)
    got, want = _both(jcfg, tcfg, img)
    assert got.dtype == torch.float32 and got.shape == (2, tcfg.n_classes)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_ATOL[dtype])
    if dtype == "float32":
        assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("n,k,s,want", [
    (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)), (15, 3, 2, (1, 1)),
    (25, 3, 2, (1, 1)), (8, 1, 2, (0, 0)), (7, 1, 2, (0, 0)),
    (14, 3, 1, (1, 1)), (9, 7, 2, (3, 3)), (10, 7, 2, (2, 3))])
def test_same_pads(n, k, s, want):
    """XLA's rule, asymmetric where the total is odd: the smaller half
    before."""
    assert resnet.same_pads(n, k, s) == want


@pytest.mark.parametrize("n", [5, 6, 7, 8, 9, 10])
@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (3, 1), (3, 2), (5, 2)])
def test_conv_pads_as_xla_same(n, k, s):
    """``_conv`` on channels_last tensors against ``lax.conv_general_dilated``
    with ``padding="SAME"`` (NHWC, HWIO), odd and even sides."""
    rng = np.random.default_rng(n * 10 + k + s)
    x = rng.standard_normal((2, n, n, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(s, s),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = resnet._conv(tx, resnet.to_port_layout(torch.from_numpy(w)), s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [5, 6, 7, 8, 15, 16, 112])
def test_max_pool_pads_as_xla_same_with_minus_infinity(n):
    """The 3x3/2 pool against ``lax.reduce_window`` with ``-inf`` and
    ``"SAME"``, on negative inputs: padding with 0 would show at the
    edges."""
    x = -1.0 - np.random.default_rng(n).random((2, n, n, 3),
                                               dtype=np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet._max_pool(tx).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    sym = torch.nn.functional.max_pool2d(tx, 3, 2, padding=1)
    assert (n % 2 == 1) == np.array_equal(sym.permute(0, 2, 3, 1).numpy(),
                                          np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_uses_batch_statistics_with_ddof_0(dtype):
    """``_bn`` against the reference's and against numpy's population
    variance over (N, H, W) with eps 1e-5."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(6).astype(np.float32)
                   for _ in range(2))
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jresnet._bn(jx, jnp.asarray(scale), jnp.asarray(bias)),
                      np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = resnet._bn(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == tx.dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        mu, var = x.mean((0, 1, 2)), x.var((0, 1, 2), ddof=0)
        np.testing.assert_allclose(
            got, (x - mu) / np.sqrt(var + 1e-5) * scale + bias,
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_a_frames_logits_depend_on_its_batch():
    """Batch statistics in serving too: one frame's logits change with its
    batch-mate, in the reference as in the port (and agree there); a batch
    of copies of one frame gives that frame's logits alone."""
    jcfg, tcfg = _configs("float32", False)
    rng = np.random.default_rng(6)
    a, b, c = (rng.random((1, 32, 32, 3), dtype=np.float32)
               for _ in range(3))
    ab, want_ab = _both(jcfg, tcfg, np.concatenate([a, b]))
    ac, want_ac = _both(jcfg, tcfg, np.concatenate([a, c]))
    assert np.abs(ab[0].numpy() - ac[0].numpy()).max() > 1e-3
    assert np.abs(want_ab[0] - want_ac[0]).max() > 1e-3
    np.testing.assert_allclose(ab.numpy(), want_ab, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ac.numpy(), want_ac, rtol=0, atol=1e-4)
    alone, _ = _both(jcfg, tcfg, a)
    copies, _ = _both(jcfg, tcfg, np.concatenate([a, a, a]))
    np.testing.assert_allclose(copies.numpy(), np.repeat(alone.numpy(), 3, 0),
                               rtol=0, atol=1e-5)


def test_params_from_numpy_round_trips_the_layouts():
    cfg = dataclasses.replace(resnet50.SMOKE_CONFIG, param_dtype="float32")
    tree = resnet.numpy_params(cfg, 0)
    p = resnet.params_from_numpy(tree, cfg, "cpu")
    for path, d in resnet.param_defs(cfg).items():
        got, want = common.nested(p, path), common.nested(tree, path)
        if len(d.shape) == 4:          # HWIO in, OIHW channels_last kept
            h, w, i, o = d.shape
            assert got.shape == (o, i, h, w)
            assert got.is_contiguous(memory_format=torch.channels_last)
        assert np.array_equal(resnet.to_reference_layout(got).numpy(), want)
    p16 = resnet.params_from_numpy(tree, resnet50.SMOKE_CONFIG, "cpu")
    assert p16["stem"]["conv"].dtype == torch.bfloat16
    assert p16["head"]["w"].dtype == torch.bfloat16
    assert p16["stem"]["bn"]["scale"].dtype == torch.float32
    bad = dict(tree, head=dict(tree["head"], w=tree["head"]["w"][:-1]))
    with pytest.raises(ValueError, match="head/w"):
        resnet.params_from_numpy(bad, cfg, "cpu")


def test_init_params_uses_the_generator_and_the_reference_fan_in():
    cfg = resnet50.CONFIG
    a, b, c = (resnet.init_params(cfg, torch.Generator().manual_seed(s),
                                  "cpu") for s in (0, 0, 1))
    w = a["stage1"]["block0"]["conv2"]
    assert torch.equal(w, b["stage1"]["block0"]["conv2"])
    assert not torch.equal(w, c["stage1"]["block0"]["conv2"])
    assert w.shape == (128, 128, 3, 3) and w.dtype == torch.bfloat16
    # fan-in is shape[-2] of the HWIO kernel: the in-channels only
    assert abs(float(w.float().std()) * 128 ** 0.5 - 1) < 0.02
    assert torch.equal(a["stem"]["bn"]["scale"], torch.ones(64))
    assert torch.count_nonzero(a["head"]["b"]) == 0
    assert a["head"]["w"].shape == (2048, 1000)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_port_matches_the_golden_logits(dtype, monkeypatch):
    """ResNet-50 at full width on the CPU against the reference's logits in
    the golden file (the ones the card is held to), 224 and 384 px; the
    same tolerance rejects the forward with the max pool padded (1, 1)."""
    with open(GOLDEN) as f:
        gold = json.load(f)["resnet"]
    cfg = dataclasses.replace(resnet50.CONFIG, param_dtype=dtype)
    params = resnet.params_from_numpy(
        resnet.numpy_params(cfg, gold["weight_seed"]), cfg, "cpu")
    rng = np.random.default_rng(gold["image_seed"])
    for res in gold["resolutions"]:
        img = rng.random((gold["n_images"], res, res, 3), dtype=np.float32)
        got = resnet.forward(params, torch.from_numpy(img), cfg).numpy()
        want = np.asarray(gold["logits"][str(res)][dtype], np.float32)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GOLDEN_ATOL[dtype, res])
        monkeypatch.setattr(resnet, "_max_pool",
                            lambda x: F.max_pool2d(x, 3, 2, padding=1))
        bad = resnet.forward(params, torch.from_numpy(img), cfg).numpy()
        monkeypatch.undo()
        assert np.abs(bad - want).max() > GOLDEN_ATOL[dtype, res]


def test_configs_and_model_module():
    from repro.configs import get_config as jget
    assert dataclasses.asdict(get_config("resnet-50")) == dataclasses.asdict(
        jget("resnet-50"))
    assert model_module(get_config("resnet-50")) is resnet
    assert not hasattr(get_config("resnet-50"), "n_tokens")


def test_serve_launcher_serves_resnet_50_on_cpu(capsys, monkeypatch):
    """``--arch resnet-50 --device cpu`` runs and prints what the reference
    launcher prints for the same arch (engine time is the fixed step
    model, so the decisions do not depend on the model's output)."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "resnet-50",
                                      "--requests", "24"])
    jserve.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    serve.main(["--arch", "resnet-50", "--requests", "24", "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want
    cfg = serve.get_smoke_config("resnet-50")
    params = resnet.params_from_numpy(resnet.numpy_params(cfg, 0), cfg, "cpu")
    run_batch = serve.make_run_batch(params, cfg)
    assert not hasattr(run_batch.step, "graphs")        # eager on the CPU
    img = torch.rand(cfg.img_res, cfg.img_res, 3)
    assert len(run_batch("hd", [img] * 3)) == 3
    with pytest.raises(ValueError, match="CUDA"):
        serve.make_run_batch(params, cfg, graphed=True)


def test_resnet_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means CUDA: without it the ResNet entry points raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = resnet50.SMOKE_CONFIG
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.params_from_numpy(resnet.numpy_params(cfg, 0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "resnet-50", "--requests", "3"])
