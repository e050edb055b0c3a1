"""The port's ViT/DeiT forward against ``repro.models.vit.forward`` on the
CPU, with the same weights: ``numpy_params`` makes them with numpy, the
reference consumes the numpy tree, the port gets it through
``params_from_numpy``.

The smoke configs run with ``attn_impl="pallas", attn_chunk=16``, so both
packages take their kernel path (S = 17 or 18 > 16; the reference's
Pallas kernel in interpret mode, the port's plain version on CPU
tensors).  Tolerances: f32 logits 1e-4 (observed ~2e-6: the same
arithmetic, sums in another order); bf16 logits 5e-2 (observed 0.014 on
logits of magnitude ~3: XLA and PyTorch round bf16 intermediates at
different places, e.g. inside GELU and the attention softmax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import common as jcommon
from repro.models import vit as jvit
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ViTConfig
from repro_torch.launch.steps import model_module
from repro_torch.models import common, resnet, vit

ARCHS = ["deit-b", "vit-l16", "vit-h14"]
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _configs(arch, dtype):
    kw = dict(attn_impl="pallas", attn_chunk=16, param_dtype=dtype)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1, 2])       # 2: pos-embed interpolation
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, scale, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    assert tcfg.n_tokens() > tcfg.attn_chunk        # the kernel path
    tree = vit.numpy_params(tcfg, 0)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                     tree)
    tparams = vit.params_from_numpy(tree, tcfg, "cpu")
    res = tcfg.img_res * scale
    img = np.random.default_rng(scale).random((2, res, res, 3),
                                              dtype=np.float32)
    want = np.asarray(jvit.forward(jparams, jnp.asarray(img), jcfg))
    got = vit.serve_step(tparams, torch.from_numpy(img), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, tcfg.n_classes)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_ATOL[dtype])
    if dtype == "float32":
        assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_80_wide_heads_matches_reference(dtype):
    """ViT-H/14's head width (80) in a narrow ViT: d_model 160, 2 heads, 2
    layers, patch 14 at 56 px enlarged to 98 (50 tokens against
    ``attn_chunk`` 32), so both packages take their kernel path (the
    reference's Pallas kernel in interpret mode, D padded to 128; the
    port's plain version on CPU tensors) and resize the pos-embed;
    tolerances as above."""
    kw = dict(name="vit-h14-80", img_res=56, patch=14, n_layers=2,
              d_model=160, n_heads=2, d_ff=320, n_classes=10,
              attn_impl="pallas", attn_chunk=32, param_dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke("vit-h14"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("vit-h14"), **kw)
    assert tcfg.d_model // tcfg.n_heads == 80
    assert tcfg.n_tokens(98) == 50 > tcfg.attn_chunk
    tree = vit.numpy_params(tcfg, 3)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                     tree)
    tparams = vit.params_from_numpy(tree, tcfg, "cpu")
    img = np.random.default_rng(4).random((2, 98, 98, 3), dtype=np.float32)
    want = np.asarray(jvit.forward(jparams, jnp.asarray(img), jcfg))
    got = vit.serve_step(tparams, torch.from_numpy(img), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_ATOL[dtype])
    if dtype == "float32":
        assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_vit_h14_serving_shapes():
    """ViT-H/14 on the serving path: 224 px stays under the 512-token
    chunk (naive attention), 384 px does not (the kernel in each of 32
    layers, heads 80 wide)."""
    cfg = get_config("vit-h14")
    assert cfg.n_tokens(224) == 257 and cfg.n_tokens(384) == 730
    assert cfg.attn_chunk == 512 and cfg.n_layers == 32
    assert cfg.d_model // cfg.n_heads == 80


@pytest.mark.parametrize("grid_from,grid_to", [(14, 24), (4, 6), (2, 5),
                                               (24, 14), (4, 3), (5, 5)])
def test_interp_pos_embed_matches_reference(grid_from, grid_to):
    """Bilinear resize of the position grid, edges included, enlarging
    (as 224 -> 384 px does) and shrinking; the extra tokens pass through."""
    n_extra, d = 2, 6
    pos = np.random.default_rng(grid_to).standard_normal(
        (n_extra + grid_from ** 2, d)).astype(np.float32)
    want = np.asarray(jvit._interp_pos_embed(jnp.asarray(pos), n_extra,
                                             grid_from, grid_to))
    got = vit._interp_pos_embed(torch.from_numpy(pos), n_extra, grid_from,
                                grid_to).numpy()
    assert got.shape == (n_extra + grid_to ** 2, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:n_extra], pos[:n_extra])


def test_patch_embed_is_the_reference_convolution():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 20, 20, 3)).astype(np.float32)  # ragged
    w = rng.standard_normal((8, 8, 3, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(img), jnp.asarray(w), window_strides=(8, 8),
        padding="VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    got = vit._patch_embed(torch.from_numpy(img), torch.from_numpy(w),
                           torch.from_numpy(b), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(2, 4, 5),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_match_reference(dtype):
    rng = np.random.default_rng(5)
    x, s, b = (rng.standard_normal(shape).astype(np.float32) * 3
               for shape in ((4, 7, 24), (24,), (24,)))
    jx = [jnp.asarray(a).astype(dtype) for a in (x, s, b)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, s, b)]
    tol = dict(rtol=0, atol=1e-5) if dtype == "float32" else \
        dict(rtol=0, atol=2 ** -7 * 4)     # one bf16 ulp at |y| < 4
    got = common.layer_norm(*tx)
    assert got.dtype == tx[0].dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        jcommon.layer_norm(*jx), np.float32), **tol)
    np.testing.assert_allclose(common.gelu(tx[0]).float().numpy(), np.asarray(
        jcommon.gelu(jx[0]), np.float32), **tol)


def test_numpy_params_are_seeded_and_carried_exactly():
    cfg = get_smoke_config("deit-b")
    a, b = vit.numpy_params(cfg, 0), vit.numpy_params(cfg, 0)
    assert np.array_equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not np.array_equal(a["layers"]["wq"],
                              vit.numpy_params(cfg, 1)["layers"]["wq"])
    p = vit.params_from_numpy(a, dataclasses.replace(
        cfg, param_dtype="float32"), "cpu")
    assert np.array_equal(p["pos_embed"].numpy(), a["pos_embed"])
    p16 = vit.params_from_numpy(a, cfg, "cpu")
    assert p16["head"]["w"].dtype == torch.bfloat16
    assert torch.equal(p16["head"]["w"],
                       torch.from_numpy(a["head"]["w"]).bfloat16())
    bad = dict(a, pos_embed=a["pos_embed"][:-1])
    with pytest.raises(ValueError, match="pos_embed"):
        vit.params_from_numpy(bad, cfg, "cpu")


def test_init_params_uses_the_generator():
    cfg = get_smoke_config("vit-l16")
    a = vit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = vit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = vit.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a["layers"]["w_in"], b["layers"]["w_in"])
    assert not torch.equal(a["layers"]["w_in"], c["layers"]["w_in"])
    assert a["layers"]["w_in"].shape == (2, 64, 128)
    assert a["layers"]["w_in"].dtype == torch.bfloat16
    assert torch.count_nonzero(a["layers"]["bq"]) == 0
    assert torch.equal(a["final_ln"]["scale"], torch.ones(64, dtype=torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS + ["resnet-50"])
def test_configs_match_reference(arch):
    """Every vision arch of the registry: the reference's fields, defaults
    and parameter count; ``n_tokens`` where the family has tokens."""
    from repro.configs import get_config as jget
    for mine, theirs in ((get_config(arch), jget(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        assert type(mine).__name__ == type(theirs).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.total_params() == theirs.total_params()
        if mine.family == "vit":
            assert mine.n_tokens(384) == theirs.n_tokens(384)
        else:
            assert not hasattr(mine, "n_tokens")
    assert model_module(get_config(arch)) is (
        vit if get_config(arch).family == "vit" else resnet)


def test_other_archs_name_their_roadmap_item():
    """Every architecture of the reference resolves in the port (the
    language models since ROADMAP item 8c), with the family the
    reference's config names, and ``model_module`` maps each family, the
    LMs' ``"lm"`` to ``models.transformer``; an unknown arch or family
    still raises."""
    from repro.configs import ARCHS as REFERENCE_ARCHS
    from repro.configs import get_config as reference_config
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer
    assert ARCHS == REFERENCE_ARCHS
    for arch in REFERENCE_ARCHS:
        for cfg in (get_config(arch), get_smoke_config(arch)):
            assert cfg.family == reference_config(arch).family
            assert model_module(cfg).param_defs(cfg)
    assert model_module(get_config("starcoder2-7b")) is transformer
    assert model_module(dataclasses.replace(get_config("deit-b"),
                                            family="lm")) is transformer
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("vit-b32")
    with pytest.raises(ValueError, match="unknown model family"):
        model_module(dataclasses.replace(get_config("deit-b"),
                                         family="rnn"))


def test_deit_b_serving_shapes():
    """The serving path's two classes: 224 px stays under the 512-token
    chunk (naive attention), 384 px does not (the kernel)."""
    cfg = get_config("deit-b")
    assert isinstance(cfg, ViTConfig) and cfg.attn_chunk == 512
    assert cfg.n_tokens(224) == 198 and cfg.n_tokens(384) == 578
