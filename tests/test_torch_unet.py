"""The port's SD 1.5 UNet (``repro_torch.models.unet``) against
``repro.models.unet`` on the CPU, with the same weights and inputs:
``numpy_params`` makes the weights with numpy, **every leaf random**
(``constant_std``: the UNet zero-initialises each ResBlock's ``c2`` and
``conv_out``, and with ``conv_out`` at 0 the output is 0 for any input);
the reference consumes the numpy tree, each leaf cast to its def's dtype
(norm scales and biases f32, kernels and projections the config's), the
port gets it through ``params_from_numpy``.

Tolerances (outputs of magnitude ~0.7-0.8): f32 2e-5 (observed up to
7.5e-7: the same arithmetic, sums in another order); bf16 3e-2 (observed
up to 7.8e-3: XLA and PyTorch round bf16 intermediates at different
places).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import common as jcommon
from repro.models import unet as junet
from repro_torch.configs import get_smoke_config
from repro_torch.models import common, resnet, unet

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
CONSTANT_STD = 0.02


def reference_params(tree, defs):
    out = {}
    for path, d in defs.items():
        common.assign(out, path, jnp.asarray(common.nested(tree, path))
                      .astype(d.dtype))
    return out


def both_forwards(jcfg, tcfg, latent, seed=0):
    tree = unet.numpy_params(tcfg, seed, CONSTANT_STD)
    rng = np.random.default_rng(seed + 1)
    lat = rng.standard_normal((2, latent, latent, tcfg.latent_channels),
                              dtype=np.float32)
    t = np.array([5, 900], np.int32)
    ctx = rng.standard_normal((2, tcfg.ctx_len, tcfg.ctx_dim),
                              dtype=np.float32)
    want = junet.forward(reference_params(tree, unet.param_defs(tcfg)),
                         jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
                         jcfg)
    got = unet.serve_step(unet.params_from_numpy(tree, tcfg, "cpu"),
                          torch.from_numpy(lat), torch.from_numpy(t),
                          torch.from_numpy(ctx), tcfg)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    jcfg = dataclasses.replace(jax_smoke("unet-sd15"), param_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config("unet-sd15"),
                               param_dtype=dtype)
    got, want = both_forwards(jcfg, tcfg, tcfg.latent_res)
    assert got.dtype == common.torch_dtype(dtype)
    assert got.shape == (2, tcfg.latent_res, tcfg.latent_res,
                         tcfg.latent_channels)
    got = got.float().numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_chunked_self_attention_matches_reference(dtype):
    """Attention at level 0 of a 36 x 36 latent: 1,296 tokens, past the
    reference's hard-coded ``q_chunk`` 1024, so both packages take their
    chunked path (two query chunks, a zero-padded key tail); two ResBlocks
    a level, so the skip stack's order and the downsample's (0, 1) SAME
    padding on an even side (36 -> 18) both show."""
    kw = dict(attn_levels=(0, 1), n_res_blocks=2, param_dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke("unet-sd15"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("unet-sd15"), **kw)
    got, want = both_forwards(jcfg, tcfg, 36, seed=4)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 3, 64), dtype=np.float32) * 3 + 1)
    scale = rng.standard_normal(64, dtype=np.float32)
    bias = rng.standard_normal(64, dtype=np.float32)
    want = jcommon.group_norm(jnp.asarray(x).astype(dtype),
                              jnp.asarray(scale), jnp.asarray(bias))
    got = common.group_norm(torch.from_numpy(x).to(common.torch_dtype(dtype)),
                            torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == common.torch_dtype(dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=2e-6 if dtype == "float32" else 2e-2)


def test_skip_channels_match_reference():
    deeper = dict(n_res_blocks=2, ch_mult=(1, 2, 4))
    for kw in ({}, deeper):
        cfg = dataclasses.replace(get_smoke_config("unet-sd15"), **kw)
        jcfg = dataclasses.replace(jax_smoke("unet-sd15"), **kw)
        assert unet._skip_channels(cfg) == junet._skip_channels(jcfg)


def test_params_from_numpy_keeps_each_defs_dtype_and_layout():
    """Norms f32, kernels and projections bf16; a 3 x 3 kernel OIHW stored
    channels_last; a wrong shape is refused by name."""
    cfg = get_smoke_config("unet-sd15")
    tree = unet.numpy_params(cfg, 0, CONSTANT_STD)
    p = unet.params_from_numpy(tree, cfg, "cpu")
    assert p["norm_out"]["scale"].dtype == torch.float32
    assert p["down0"]["res0"]["n1"]["bias"].dtype == torch.float32
    assert p["t_mlp"]["w1"].dtype == torch.bfloat16
    w = p["conv_in"]
    assert w.dtype == torch.bfloat16 and w.shape == (32, 4, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(resnet.to_reference_layout(w),
                       torch.from_numpy(tree["conv_in"]).bfloat16())
    bad = dict(tree, conv_out=tree["conv_out"][..., :-1])
    with pytest.raises(ValueError, match="conv_out"):
        unet.params_from_numpy(bad, cfg, "cpu")


def test_the_all_random_weights_have_no_all_zero_leaf():
    cfg = get_smoke_config("unet-sd15")
    assert not unet.numpy_params(cfg, 0)["conv_out"].any()
    tree = unet.numpy_params(cfg, 0, CONSTANT_STD)
    for path, d in unet.param_defs(cfg).items():
        leaf = common.nested(tree, path)
        assert leaf.any() and np.unique(leaf).size > 1, path
        if d.init == "ones":
            assert abs(leaf.mean() - 1) < 0.02, path
