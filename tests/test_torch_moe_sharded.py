"""The port's sharded MoE (``repro_torch.models.moe.moe_ffn_sharded`` /
``_local_dispatch_ffn``) and the LM's mesh branch against the JAX
reference, on the CPU.

* A 2 x 4 (data, model) gloo group of 8 ranks runs ``moe_ffn_sharded``
  expert-sharded and d_ff-sharded with ``n_real < E`` and copies dropped
  at capacity, from plain tensors and from DTensors, in f32 and bf16 (the
  router f32); held to the reference's ``shard_map`` on 8 host devices on
  the same numpy inputs (one subprocess, ``tests/torch_dist_jobs.py
  moe``) within ``MOE_ATOL`` in f32 and ``MOE_BF16_RTOL`` of the largest
  output in bf16.
* ``_local_dispatch_ffn`` shard by shard in this process, the partial
  outputs summed over the model shards: the same result.
* Granite-3.0 MoE at full width, 2 of its 32 layers, f32, B=2 x 12
  tokens, under a 1 x 1 mesh (gloo, one rank) with ``install_rules``:
  its logits against the reference's jitted logits under its own one-
  device mesh, within the LM golden's f32 limits (``chip_smoke.py``'s
  ``GRANITE_ATOL`` / ``GRANITE_RMS``); the port's logits without the mesh
  (padded experts routed, capacity from 48) must fail those limits.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import granite_moe_3b_a800m as jax_granite
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import transformer as jtr
from repro_torch.configs import granite_moe_3b_a800m
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh
from repro_torch.models import moe, transformer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_dist_jobs as jobs  # noqa: E402
from make_torch_lm_golden import reference_params  # noqa: E402

# f32 sharded MoE against the reference's: the products and the
# all-reduce over 4 model shards sum in other orders (observed 4.5e-8 on
# outputs up to ~0.5, the aux loss 1.2e-7 on 1.05)
MOE_ATOL = 1e-5
# bf16: the expert products and the all-reduce of the 4 partial outputs
# round to bf16 on both sides, in other orders: one bf16 unit of the
# largest output (observed one unit, 2^-10 on outputs up to 0.156)
MOE_BF16_RTOL = 2.0 ** -7
# chip_smoke.py's f32 limits of the Granite golden (max, rms)
GRANITE_ATOL, GRANITE_RMS = 1e-4, 1e-5
GRANITE_LAYERS, BATCH, PROMPT = 2, 2, 12


@pytest.fixture(scope="module")
def moe_job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "torch_dist_jobs.py"),
                          "moe", out], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return (dict(np.load(os.path.join(out, "ranks.npz"))),
            dict(np.load(os.path.join(out, "reference.npz"))))


def atol(dtype, ref):
    return MOE_ATOL if dtype == "float32" else \
        MOE_BF16_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("mode", list(jobs.MOE_MODES))
@pytest.mark.parametrize("dtype", jobs.MOE_DTYPES)
@pytest.mark.parametrize("form", ["plain", "dtensor"])
def test_sharded_moe_on_8_ranks_matches_reference(moe_job, mode, dtype,
                                                  form):
    got, want = moe_job
    key = f"{mode}/{dtype}"
    out, ref = got[f"{key}/{form}/out"], want[f"{key}/reference/out"]
    assert out.shape == ref.shape == (jobs.MOE_T, jobs.MOE_D)
    assert np.abs(out - ref).max() <= atol(dtype, ref)
    # the aux loss: f32 routing logits on both sides
    assert abs(float(got[f"{key}/{form}/aux"])
               - float(want[f"{key}/reference/aux"])) <= MOE_ATOL
    if form == "dtensor":
        # the output's placements: tokens over 'data', replicated on 'model'
        assert got[f"{key}/dtensor/sharded"].tolist() == [True, False]


def shard_sum(mode, dtype):
    """``_local_dispatch_ffn`` on each (data, model) shard of the job's
    inputs, the partial outputs summed over the model shards (in the
    inputs' dtype, as the all-reduce sums them) and the data shards
    stacked, and the aux losses averaged."""
    x, rw, wg, wu, wd = (torch.from_numpy(a) for a in jobs.moe_inputs())
    dt = getattr(torch, dtype)
    x, wg, wu, wd = (a.to(dt) for a in (x, wg, wu, wd))
    n_dp, n_mp = jobs.MOE_MESH
    es = jobs.MOE_MODES[mode]
    outs, auxes = [], []
    for xs in x.chunk(n_dp):
        part = 0
        for m in range(n_mp):
            if es:
                sl = slice(m * wg.shape[0] // n_mp,
                           (m + 1) * wg.shape[0] // n_mp)
                w = (wg[sl], wu[sl], wd[sl])
                off = sl.start
            else:
                f = wg.shape[2] // n_mp
                w = (wg[..., m * f:(m + 1) * f], wu[..., m * f:(m + 1) * f],
                     wd[:, m * f:(m + 1) * f])
                off = 0
            o, aux = moe._local_dispatch_ffn(
                xs, rw, *w, top_k=jobs.MOE_K, capacity_factor=jobs.MOE_CF,
                n_experts=jobs.MOE_E, expert_offset=off,
                n_real=jobs.MOE_N_REAL)
            part = part + o
        outs.append(part)
        auxes.append(aux)
    return torch.cat(outs).float().numpy(), float(torch.stack(auxes).mean())


@pytest.mark.parametrize("mode", list(jobs.MOE_MODES))
@pytest.mark.parametrize("dtype", jobs.MOE_DTYPES)
def test_local_dispatch_by_shard_sums_to_reference(moe_job, mode, dtype):
    out, aux = shard_sum(mode, dtype)
    ref = moe_job[1][f"{mode}/{dtype}/reference/out"]
    assert np.abs(out - ref).max() <= atol(dtype, ref)
    assert abs(aux - float(moe_job[1][f"{mode}/{dtype}/reference/aux"])) \
        <= MOE_ATOL


def test_local_dispatch_masks_padded_experts():
    """With ``n_real`` the padded experts get no copy and the capacity is
    sized from the real ones: ``route_topk`` records no expert id past
    ``n_real``."""
    x, rw, wg, wu, wd = (torch.from_numpy(a) for a in jobs.moe_inputs())
    seen, real = [], moe.route_topk

    def recording(logits, top_k, n_real=None):
        gates, experts = real(logits, top_k, n_real)
        seen.append(experts)
        return gates, experts

    moe.route_topk = recording
    try:
        moe._local_dispatch_ffn(x, rw, wg, wu, wd, top_k=jobs.MOE_K,
                                capacity_factor=jobs.MOE_CF,
                                n_experts=jobs.MOE_E, expert_offset=0,
                                n_real=jobs.MOE_N_REAL)
    finally:
        moe.route_topk = real
    assert int(seen[0].max()) < jobs.MOE_N_REAL
    assert moe.capacity(jobs.MOE_T, jobs.MOE_N_REAL, jobs.MOE_K,
                        jobs.MOE_CF) == 13


# ---------------------------------------------------------------------------
# Granite at full width under a one-device mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def granite_logits():
    """(the reference's meshed logits, the port's meshed, the port's
    unmeshed), f32, B=2 x 12 tokens."""
    kw = dict(n_layers=GRANITE_LAYERS, param_dtype="float32")
    cfg = dataclasses.replace(jax_granite.CONFIG, attn_impl="chunked", **kw)
    tcfg = dataclasses.replace(granite_moe_3b_a800m.CONFIG, **kw)
    tree = transformer.numpy_params(tcfg, 0, 0.02)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    params = reference_params(tree, transformer.param_defs(tcfg))
    jmesh.install_rules(jmesh.make_host_mesh(), cfg, BATCH, kind="prefill")
    try:
        want = np.asarray(jax.jit(lambda p, t: jtr.logits_fn(p, t, cfg))(
            params, jnp.asarray(toks)))
    finally:
        jshd.clear_rules()
    del params
    tparams = transformer.params_from_numpy(tree, tcfg, "cpu")
    del tree
    tt = torch.from_numpy(toks).long()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = mesh.make_host_mesh(device="cpu")
        rules = mesh.install_rules(m, tcfg, BATCH, kind="prefill")
        assert rules["dp"] == "data" and rules["tp"] == "model"
        with torch.no_grad():
            got = transformer.logits_fn(tparams, tt, tcfg).numpy()
    finally:
        shd.clear_rules()
        dist.destroy_process_group()
    with torch.no_grad():
        plain = transformer.logits_fn(tparams, tt, tcfg).numpy()
    return want, got, plain


def errors(a, b):
    d = a - b
    return float(np.abs(d).max()), float(np.sqrt((d ** 2).mean()))


def test_granite_mesh_branch_matches_reference(granite_logits):
    want, got, _ = granite_logits
    assert got.shape == want.shape == (BATCH, PROMPT, 49155)
    e, r = errors(got, want)
    assert e <= GRANITE_ATOL and r <= GRANITE_RMS, (e, r)


def test_granite_unmeshed_output_rejected(granite_logits):
    """The planted fault: the unmeshed ``moe_ffn`` in place of the
    sharded path (observed max 1.36, rms 0.186 from the reference's
    meshed logits, against 5.9e-6 and rms 1.1e-6 for the mesh branch)."""
    want, _, plain = granite_logits
    e, r = errors(plain, want)
    assert e > GRANITE_ATOL and r > GRANITE_RMS, (e, r)
