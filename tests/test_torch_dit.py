"""The port's DiT (``repro_torch.models.dit``) against ``repro.models.dit``
on the CPU, with the same weights and inputs: ``numpy_params`` makes the
weights with numpy, **every leaf random** (``constant_std``: adaLN-Zero
zero-initialises the gates and the final layer, and with them at 0 the
output is 0 for any input, so a parity check on such weights would pass
any forward at all); the reference consumes the numpy tree, each leaf cast
to its def's dtype, the port gets it through ``params_from_numpy``.

Tolerances (outputs of magnitude ~0.5-0.7): f32 1e-5 (observed up to
3e-7: the same arithmetic, sums in another order); bf16 1e-2 (observed up
to 3.9e-3: XLA and PyTorch round bf16 intermediates at different
places).  The timestep embedding is held within 1e-4 (observed 5.7e-5):
XLA's ``exp`` and PyTorch's differ in the last place on a few of its
frequencies, and ``t`` up to 999 multiplies that into the arguments of
the sines and cosines (the reference jitted and eager differ by 3e-5).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs import shapes as jshapes
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.models import unet as junet
from repro_torch.configs import (FAMILY_SHAPES, cell_is_applicable,
                                 get_config, get_smoke_config, shapes_for)
from repro_torch.configs import shapes as tshapes
from repro_torch.launch.steps import model_module
from repro_torch.models import common, diffusion, dit, unet

ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
CONSTANT_STD = 0.02


def reference_params(tree, defs):
    """The numpy tree as the reference's parameters, each leaf in its def's
    dtype."""
    out = {}
    for path, d in defs.items():
        common.assign(out, path, jnp.asarray(common.nested(tree, path))
                      .astype(d.dtype))
    return out


def inputs(cfg, res, seed):
    """Seeded latents (2, res/8, res/8, C), timesteps and labels, the
    second label the class-dropout one."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((2, res // 8, res // 8, cfg.latent_channels),
                              dtype=np.float32)
    return lat, np.array([3, 999], np.int32), np.array([1, cfg.n_classes],
                                                       np.int32)


def both_forwards(jcfg, tcfg, res, seed=0):
    tree = dit.numpy_params(tcfg, seed, CONSTANT_STD)
    lat, t, y = inputs(tcfg, res, seed + 1)
    want = jdit.forward(reference_params(tree, dit.param_defs(tcfg)),
                        jnp.asarray(lat), jnp.asarray(t), jnp.asarray(y),
                        jcfg)
    got = dit.serve_step(dit.params_from_numpy(tree, tcfg, "cpu"),
                         torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(y), tcfg)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1, 2])       # 2: pos-embed interpolation
def test_forward_matches_reference(scale, dtype):
    jcfg = dataclasses.replace(jax_smoke("dit-xl2"), param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config("dit-xl2"), param_dtype=dtype)
    res = tcfg.img_res * scale
    got, want = both_forwards(jcfg, tcfg, res)
    assert got.dtype == common.torch_dtype(dtype)
    assert got.shape == (2, res // 8, res // 8, 2 * tcfg.latent_channels)
    got = got.float().numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_72_wide_heads_on_the_kernel_path(dtype):
    """DiT-XL/2's head width (72) in a narrow DiT: d 144, 2 heads, 2
    layers, ``attn_impl="pallas"`` with ``attn_chunk`` 8 at 64 px (16
    tokens > 8, the pos-embed resized from 2 x 2 to 4 x 4), so both
    packages take their kernel path (the reference's Pallas kernel in
    interpret mode, D padded to 128; the port's plain version on CPU
    tensors); tolerances as above."""
    kw = dict(name="dit-72", d_model=144, n_heads=2, attn_impl="pallas",
              attn_chunk=8, param_dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke("dit-xl2"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("dit-xl2"), **kw)
    assert tcfg.d_model // tcfg.n_heads == 72
    assert tcfg.n_tokens(64) == 16 > tcfg.attn_chunk
    got, want = both_forwards(jcfg, tcfg, 64, seed=3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ATOL[dtype])


def test_the_dropout_label_reads_its_own_row():
    """Label ``n_classes`` (the class-dropout label) reads the last row of
    ``y_embed``: another row there moves the output."""
    tcfg = dataclasses.replace(get_smoke_config("dit-xl2"),
                               param_dtype="float32")
    tree = dit.numpy_params(tcfg, 0, CONSTANT_STD)
    params = dit.params_from_numpy(tree, tcfg, "cpu")
    lat, t, y = (torch.from_numpy(a) for a in inputs(tcfg, 32, 1))
    out = dit.forward(params, lat, t, y, tcfg)
    params["y_embed"][-1] += 1.0
    moved = dit.forward(params, lat, t, y, tcfg)
    assert torch.equal(out[0], moved[0]) and not torch.equal(out[1], moved[1])


@pytest.mark.parametrize("dim", [256, 320])
def test_timestep_embedding_matches_reference(dim):
    t = np.array([0, 1, 17, 250, 999], np.int32)
    want = np.asarray(jcommon.timestep_embedding(jnp.asarray(t), dim))
    got = common.timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == (5, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # cosines first: t = 0 gives 1 then 0
    assert got[0, :dim // 2].eq(1).all() and got[0, dim // 2:].eq(0).all()


def test_ddpm_alphas_match_reference():
    want = np.asarray(jdit.ddpm_alphas())
    got = diffusion.ddpm_alphas()
    assert got.dtype == torch.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["dit-xl2", "unet-sd15"])
def test_configs_match_reference(arch):
    """The published and the smoke configuration: the reference's fields,
    defaults and helpers; ``param_defs`` the reference's shapes and
    dtypes; the family's module."""
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        assert type(mine).__name__ == type(theirs).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.total_params() == theirs.total_params()
        mod, jmod = {"dit": (dit, jdit), "unet": (unet, junet)}[mine.family]
        if mine.family == "dit":
            for px in (None, 256, 512, 1024):
                assert mine.n_tokens(px) == theirs.n_tokens(px)
                assert mine.latent_res(px) == theirs.latent_res(px)
            assert mine.d_ff == theirs.d_ff
        defs, jdefs = mod.param_defs(mine), jmod.param_defs(theirs)
        assert sorted(defs) == sorted(jdefs)
        for path, d in defs.items():
            assert d.shape == jdefs[path].shape, path
            assert d.dtype == jnp.dtype(jdefs[path].dtype).name, path
            assert (d.init in ("zeros", "ones")) == (
                jdefs[path].init in ("zeros", "ones")), path
        assert model_module(mine) is mod


def test_registry_matches_reference():
    """The port's registry is the reference's, in its order: every arch
    ported (the language models since ROADMAP item 8c), each with the
    reference's family."""
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS
    assert ARCHS == JARCHS
    assert {"dit-xl2", "unet-sd15"} <= set(ARCHS)
    assert all(get_config(a).family == jax_config(a).family for a in ARCHS)
    assert sum(jax_config(a).family == "lm" for a in ARCHS) == 4


def test_full_width_parameter_counts():
    """By ``param_defs``: DiT-XL/2 675,000,608 (``total_params`` counts
    the layers alone: 668,860,416), the SD 1.5 UNet 784,957,760."""
    count = lambda defs: sum(int(np.prod(d.shape)) for d in defs.values())
    assert count(dit.param_defs(get_config("dit-xl2"))) == 675_000_608
    assert get_config("dit-xl2").total_params() == 668_860_416
    assert count(unet.param_defs(get_config("unet-sd15"))) == 784_957_760


def test_shape_tables_match_reference():
    for name in ("LM_SHAPES", "DIFFUSION_SHAPES", "VISION_SHAPES"):
        mine, theirs = getattr(tshapes, name), getattr(jshapes, name)
        assert {k: dataclasses.asdict(v) for k, v in mine.items()} == \
            {k: dataclasses.asdict(v) for k, v in theirs.items()}
    assert {f: sorted(s) for f, s in FAMILY_SHAPES.items()} == \
        {f: sorted(s) for f, s in jshapes.FAMILY_SHAPES.items()}
    for arch in ("dit-xl2", "unet-sd15", "deit-b", "resnet-50"):
        cfg = get_config(arch)
        assert sorted(shapes_for(cfg)) == sorted(
            jshapes.shapes_for(jax_config(arch)))
        for shape in shapes_for(cfg).values():
            assert cell_is_applicable(cfg, shape) == (True, None)
    for window in (None, 1024):             # an LM, full or local attention
        lm = types.SimpleNamespace(family="lm", sliding_window=window)
        for s, js in zip(tshapes.LM_SHAPES.values(),
                         jshapes.LM_SHAPES.values()):
            assert cell_is_applicable(lm, s) == \
                jshapes.cell_is_applicable(lm, js)
    assert get_config("dit-xl2").n_tokens(
        tshapes.DIFFUSION_SHAPES["gen_fast"].img_res) == 1024


def test_params_from_numpy_checks_shapes_and_keeps_the_dtype():
    cfg = get_smoke_config("dit-xl2")
    tree = dit.numpy_params(cfg, 0)
    p = dit.params_from_numpy(tree, cfg, "cpu")
    assert p["layers"]["wq"].dtype == torch.bfloat16
    assert torch.equal(p["layers"]["wq"],
                       torch.from_numpy(tree["layers"]["wq"]).bfloat16())
    bad = dict(tree, final=dict(tree["final"], w=tree["final"]["w"][:, :-1]))
    with pytest.raises(ValueError, match="final/w"):
        dit.params_from_numpy(bad, cfg, "cpu")


def test_the_all_random_weights_have_no_all_zero_leaf():
    """The default seeding keeps the published init (zeros, ones); the
    parity seeding (``constant_std``) leaves no leaf constant."""
    cfg = get_smoke_config("dit-xl2")
    plain = dit.numpy_params(cfg, 0)
    assert not plain["final"]["w"].any() and not plain["layers"]["adaln"].any()
    tree = dit.numpy_params(cfg, 0, CONSTANT_STD)
    for path, d in dit.param_defs(cfg).items():
        leaf = common.nested(tree, path)
        assert leaf.any() and np.unique(leaf).size > 1, path
        if d.init == "zeros":
            assert 0.01 < leaf.std() < 0.03, path
    jtree = jax.tree_util.tree_leaves(
        reference_params(tree, dit.param_defs(cfg)))
    assert all(bool(jnp.any(leaf != 0)) for leaf in jtree)
