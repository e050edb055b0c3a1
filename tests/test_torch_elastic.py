"""Elastic remeshing (``repro_torch.training.elastic``) and the cell's
``_materialize`` against the JAX reference, on the CPU.

The reference's ``TestElastic`` mirrored: the surviving mesh's shape at
each device count (the reference's arithmetic run on stub devices: its
``Mesh`` needs real ones), ``replace_mesh`` and ``shrink_batch``, and a
checkpoint written under mesh A and restored under mesh B on a gloo group
of 4 ranks (one subprocess: ``tests/torch_dist_jobs.py elastic``).
``steps._materialize`` is held bit for bit to the reference's on each
family's batch specs and parameter specs (smoke configs, small shapes:
full-size cells would draw hundreds of MB), through the n-way
``prng.split``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.training.elastic as jelastic
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.shapes import ShapeSpec as JaxShapeSpec
from repro.launch import steps as jsteps
from repro.training.optimizer import AdamWConfig as JaxAdamW
from repro.training.optimizer import opt_state_specs as jax_opt_specs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.fleetsim.rng import prng_key
from repro_torch.launch import steps
from repro_torch.models import prng
from repro_torch.training.elastic import (replace_mesh, shrink_batch,
                                          surviving_mesh, surviving_shape)
from repro_torch.training.optimizer import AdamWConfig, opt_state_specs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_dist_jobs as jobs  # noqa: E402


# ---------------------------------------------------------------------------
# surviving meshes
# ---------------------------------------------------------------------------
def reference_shape(monkeypatch, n, mp):
    """The reference's ``surviving_mesh`` arithmetic on ``n`` stub
    devices: the shape of the device array it builds its mesh of."""
    monkeypatch.setattr(jelastic.jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(jelastic, "Mesh",
                        lambda devices, names, axis_types: devices.shape)
    return tuple(jelastic.surviving_mesh(n, mp))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_surviving_shape_matches_reference(monkeypatch, n):
    for mp in (1, 2, 4, 8, 16, 64):
        assert surviving_shape(n, mp) == reference_shape(monkeypatch, n, mp)


def test_surviving_mesh_on_a_fake_group():
    """The mesh over the first dp x mp ranks of a 16-rank group, the model
    axis shrunk to fit."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        for n, mp, shape in ((16, 4, (4, 4)), (12, 8, (3, 4)),
                             (6, 64, (3, 2)), (1, 16, (1, 1))):
            m = surviving_mesh(n, mp, device="cpu")
            assert tuple(m.shape) == shape
            assert m.mesh_dim_names == ("data", "model")
            assert m.mesh.flatten().tolist() == list(range(n))
    finally:
        dist.destroy_process_group()


def test_replace_mesh_and_shrink_batch():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = surviving_mesh(1, 1, device="cpu")
        tree = {"w": torch.arange(32.0).reshape(8, 4)}
        placed = replace_mesh(tree, {"w": (None, None)}, mesh)
        assert torch.equal(placed["w"].full_tensor(), tree["w"])
        placed = replace_mesh(tree, {"w": ("data", "model")}, mesh)
        assert placed["w"].placements[0].is_shard(0)
        assert torch.equal(placed["w"].to_local(), tree["w"])
    finally:
        dist.destroy_process_group()
    assert shrink_batch(256, old_dp=16, new_dp=12) == 192 == \
        jelastic.shrink_batch(256, old_dp=16, new_dp=12)


@pytest.fixture(scope="module")
def elastic_job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("elastic"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "torch_dist_jobs.py"),
                          "elastic", out], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(jobs.ELASTIC_RANKS)]


def test_placed_on_mesh_a_by_block(elastic_job):
    """On the (4, 1) mesh each rank holds its 2 rows of ``w``; ``b`` (6
    values over 4 ranks) does not divide and is replicated."""
    tree = jobs.elastic_tree()
    for r, res in enumerate(elastic_job):
        assert tuple(res["a/shape"]) == (4, 1)
        assert np.array_equal(res["a/w_local"], tree["w"][2 * r:2 * r + 2])
        assert np.array_equal(res["a/b_local"], tree["b"])


def test_failure_recovery_end_to_end(elastic_job):
    """Checkpoint under mesh A, two ranks lost, restore under the
    surviving (2, 1) mesh: each survivor's blocks, and the whole tree
    gathered there, equal the original bit for bit."""
    tree = jobs.elastic_tree()
    for r, res in enumerate(elastic_job):
        assert tuple(res["b/shape"]) == (2, 1) and int(res["batch"]) == 128
        if r >= 2:
            assert "b/w" not in res
            continue
        assert np.array_equal(res["b/w"], tree["w"])
        assert np.array_equal(res["b/b"], tree["b"])
        assert np.array_equal(res["b/w_local"], tree["w"][4 * r:4 * r + 4])
        assert np.array_equal(res["b/b_local"], tree["b"][3 * r:3 * r + 3])


# ---------------------------------------------------------------------------
# _materialize and the n-way split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num", [1, 2, 3, 7, 100])
def test_split_matches_jax(num):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.split(key, num)).tolist()
    assert [list(k) for k in prng.split(prng_key(11), num)] == want


def bits(x) -> np.ndarray:
    """A tensor's or array's values as integers of its width (bf16 as the
    16 bits of f32's top half)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(f"i{x.element_size()}") \
            if x.is_floating_point() else x.numpy().astype(np.int64)
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(f"i{a.itemsize}") if a.dtype.kind == "f" \
        else a.astype(np.int64)


def assert_same_draws(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_draws(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, tuple):
        for f, g, w in zip(want._fields, got, want):
            assert_same_draws(g, w, f"{path}/.{f}")
        return
    assert tuple(got.shape) == tuple(want.shape), path
    assert np.array_equal(bits(got), bits(want)), path


# (family, the arch of its smoke config, the shape of a small batch)
BATCHES = [("lm", "granite-moe-3b-a800m", dict(seq_len=16, global_batch=2)),
           ("vit", "deit-b", dict(img_res=32, global_batch=2)),
           ("resnet", "resnet-50", dict(img_res=32, global_batch=2)),
           ("dit", "dit-xl2", dict(img_res=64, global_batch=2)),
           ("unet", "unet-sd15", dict(img_res=64, global_batch=1))]


@pytest.mark.parametrize("family,arch,kw", BATCHES,
                         ids=[b[0] for b in BATCHES])
def test_materialize_batch_matches_reference(family, arch, kw):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    specs = steps._BATCH_SPECS[family](cfg, ShapeSpec("t", "train", **kw))
    jspecs = {"lm": jsteps._lm_batch_specs, "vit": jsteps._vision_batch_specs,
              "resnet": jsteps._vision_batch_specs,
              "dit": jsteps._dit_batch_specs,
              "unet": jsteps._unet_batch_specs}[family](
        jcfg, JaxShapeSpec("t", "train", **kw))
    for seed in (0, 5):
        got = steps._materialize(specs, prng_key(seed), "cpu")
        want = jsteps._materialize(jspecs, jax.random.PRNGKey(seed))
        assert_same_draws(got, want)


@pytest.mark.parametrize("family,arch", [b[:2] for b in BATCHES],
                         ids=[b[0] for b in BATCHES])
def test_materialize_params_matches_reference(family, arch):
    """Each family's smoke parameter specs (bf16 leaves times bf16 0.1),
    and the LM's optimizer state too (a NamedTuple, its int32 step a
    scalar 0).  The reference draws leaf by leaf, eagerly: ~20 s for the
    UNet's 151 leaves."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    mod, jmod = steps.model_module(cfg), jsteps.model_module(jcfg)
    specs, jspecs = mod.param_specs(cfg), jmod.param_specs(jcfg)
    if family == "lm":
        specs = opt_state_specs(specs, AdamWConfig())
        jspecs = jax_opt_specs(jspecs, JaxAdamW())
    got = steps._materialize(specs, prng_key(3), "cpu")
    want = jsteps._materialize(jspecs, jax.random.PRNGKey(3))
    assert_same_draws(got, want)
