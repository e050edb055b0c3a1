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
* The same job's gradients of x, the router, gate, up and down, for the
  output loss ``sum(out * r)`` and the aux loss taken separately, held
  to the reference's ``jax.grad`` through ``shard_map`` (f32 within
  ``MOE_ATOL`` of each gradient's largest value, bf16 within
  ``MOE_BF16_GRAD_RTOL`` of it), whole on every rank from plain tensors
  as from DTensors; the padded experts' gradient is exactly 0; four
  planted faults (the all-reduce's backward a sum, one ``Partial(model)``
  for the whole router gradient, ``distribute_tensor`` in ``distribute``,
  the padded experts routed) each fail, the first two in bf16 as well.
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
import train_golden as tg  # noqa: E402
from make_torch_lm_golden import reference_params  # noqa: E402

# f32 sharded MoE against the reference's: the products and the
# all-reduce over 4 model shards sum in other orders (observed 4.5e-8 on
# outputs up to ~0.5, the aux loss 1.2e-7 on 1.05)
MOE_ATOL = 1e-5
# bf16: the expert products and the all-reduce of the 4 partial outputs
# round to bf16 on both sides, in other orders: one bf16 unit of the
# largest output (observed one unit, 2^-10 on outputs up to 0.156)
MOE_BF16_RTOL = 2.0 ** -7
# bf16 gradients: two bf16 units of the largest.  A gradient rounds to
# bf16 at least twice in series on each side (a weight's: its product per
# data rank, then the reduce-scatter's sum of the 2 ranks; x's: the
# products, the sum of the gate and up parts, the 4 model ranks' sum),
# each in its own order: observed 1.00e-2 of the largest (x) between the
# sides, where each side is 4.2e-3 to 9.2e-3 of it from the f32
# gradient of the same bf16-valued inputs: 0.64 of this limit.  The two
# bf16 planted faults count a part 4 times, an error of 3x the largest
# value: 192x this limit on the gradients they reach
# (test_gradient_limits_reject_planted_faults)
MOE_BF16_GRAD_RTOL = 2 * MOE_BF16_RTOL
# chip_smoke.py's f32 limits of the Granite golden (max, rms)
GRANITE_ATOL, GRANITE_RMS = 1e-4, 1e-5
GRANITE_LAYERS, BATCH, PROMPT = 2, 2, 12


@pytest.fixture(scope="module")
def moe_out(tmp_path_factory):
    """The ``moe`` job's output directory: ``rank<r>.npz`` of each of the
    8 ranks and ``reference.npz``."""
    out = str(tmp_path_factory.mktemp("moe"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "torch_dist_jobs.py"),
                          "moe", out], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def moe_job(moe_out):
    """(rank 0's results, the reference's)."""
    return (dict(np.load(os.path.join(moe_out, "rank0.npz"))),
            dict(np.load(os.path.join(moe_out, "reference.npz"))))


@pytest.fixture(scope="module")
def moe_ranks(moe_out):
    return [dict(np.load(os.path.join(moe_out, f"rank{r}.npz")))
            for r in range(np.prod(jobs.MOE_MESH))]


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
# The gradient on the 2 x 4 grid
# ---------------------------------------------------------------------------
def grad_tol(dtype, ref):
    """The limit of a gradient against the reference's, from its largest
    value.  f32: ``MOE_ATOL`` of it; the gradients span 3.4e-3 (the aux
    loss's in x) to 1.2 (gate's), so one absolute limit would hold the
    small ones to 0.3% and the large ones to 1e-5 (observed 3.1e-7 of the
    largest, the sums over 4 model and 2 data ranks in other orders).
    bf16: ``MOE_BF16_GRAD_RTOL`` of it."""
    top = float(np.abs(ref).max())
    return (MOE_ATOL if dtype == "float32" else MOE_BF16_GRAD_RTOL) * top


def grad_errors(ranks, want, key, ref_key, form, loss):
    """Each gradient's largest error over every rank against the
    reference's, with the reference's gradient: (err, ref) by name."""
    out = {}
    for name in jobs.GRAD_NAMES:
        ref = want[f"{ref_key}/reference/grad/{loss}/{name}"]
        err = 0.0
        for got in ranks:
            g = got[f"{key}/{form}/grad/{loss}/{name}"]
            assert g.shape == ref.shape
            err = max(err, float(np.abs(g - ref).max()))
        out[name] = (err, ref)
    return out


@pytest.mark.parametrize("mode", list(jobs.MOE_MODES))
@pytest.mark.parametrize("dtype", jobs.MOE_DTYPES)
@pytest.mark.parametrize("form", ["plain", "dtensor"])
@pytest.mark.parametrize("loss", ["out", "aux"])
def test_sharded_moe_gradients_match_reference(moe_out, moe_ranks, mode,
                                               dtype, form, loss):
    """The gradients of x, the router, gate, up and down on the 2 x 4
    gloo grid against the reference's ``jax.grad`` through ``shard_map``
    on 8 host devices, for the output loss ``sum(out * r)`` and the aux
    loss alone: the whole gradient on every rank, from plain tensors as
    from DTensors."""
    want = dict(np.load(os.path.join(moe_out, "reference.npz")))
    key = f"{mode}/{dtype}"
    for name, (err, ref) in grad_errors(moe_ranks, want, key, key, form,
                                        loss).items():
        assert err <= grad_tol(dtype, ref), (name, err, grad_tol(dtype, ref))
        if loss == "aux" and name in ("gate", "up", "down"):
            # the aux loss reaches no expert weight, on either side
            assert not ref.any() and err == 0.0, name


@pytest.mark.parametrize("mode", list(jobs.MOE_MODES))
@pytest.mark.parametrize("dtype", jobs.MOE_DTYPES)
@pytest.mark.parametrize("form", ["plain", "dtensor"])
def test_padded_experts_get_exactly_zero_gradient(moe_out, moe_ranks, mode,
                                                  dtype, form):
    """Experts ``n_real`` .. E - 1 (padding, as Granite's 40-47): their
    router columns and gate, up and down weights get a gradient of exactly
    0 on every rank, from both losses, as in the reference."""
    want = dict(np.load(os.path.join(moe_out, "reference.npz")))
    n = jobs.MOE_N_REAL
    for loss in ("out", "aux"):
        for name in jobs.GRAD_NAMES[1:]:
            padded = (lambda g: g[:, n:]) if name == "router" else \
                (lambda g: g[n:])
            ref = want[f"{mode}/{dtype}/reference/grad/{loss}/{name}"]
            assert not padded(ref).any(), (loss, name)
            for got in moe_ranks:
                g = got[f"{mode}/{dtype}/{form}/grad/{loss}/{name}"]
                assert not padded(g).any(), (loss, name)
                if loss == "out" and form == "dtensor":
                    # the real experts do get one
                    assert (g[:, :n] if name == "router" else g[:n]).any()


# which losses each planted fault must fail, by entry form: the all-reduce
# over model with a sum as its backward counts the dispatch's part 4
# times (the output loss); one Partial(model) for the whole router and x
# gradients counts the aux loss's part 4 times (the aux loss); the
# distribute_tensor leaf leaves the plain entry without any gradient; the
# padded experts routed move every gradient of the output loss
FAULT_FAILS = {"sum_backward_sum": {"plain": {"out"}, "dtensor": {"out"}},
               "router_one_partial": {"plain": {"aux"}, "dtensor": {"aux"}},
               "distribute_tensor": {"plain": {"out", "aux"},
                                     "dtensor": set()},
               "padded_routed": {"plain": {"out", "aux"},
                                 "dtensor": {"out", "aux"}}}


FAULT_CASES = [pytest.param(f, "float32", id=f) for f in jobs.MOE_FAULTS] + [
    pytest.param(f, "bfloat16", id=f"{f}-bfloat16")
    for f in jobs.MOE_BF16_FAULTS]


@pytest.mark.parametrize("fault,dtype", FAULT_CASES)
def test_gradient_limits_reject_planted_faults(moe_out, moe_ranks, fault,
                                               dtype):
    """Each planted fault (expert-sharded) fails the gradient limits of
    its dtype for the losses ``FAULT_FAILS`` names and passes the others:
    the two losses are held apart, so a part counted 4 times cannot hide
    in their sum.  ``padded_routed`` also gives the padded experts a
    gradient."""
    want = dict(np.load(os.path.join(moe_out, "reference.npz")))
    key = f"fault/{fault}/{dtype}"
    for form in ("plain", "dtensor"):
        for loss in ("out", "aux"):
            errs = grad_errors(moe_ranks, want, key, f"expert/{dtype}", form,
                               loss)
            bad = [n for n, (e, ref) in errs.items()
                   if e > grad_tol(dtype, ref)]
            assert bool(bad) == (loss in FAULT_FAILS[fault][form]), (
                form, loss, bad)
    if fault == "padded_routed":
        g = moe_ranks[0][f"{key}/dtensor/grad/out/gate"]
        assert g[jobs.MOE_N_REAL:].any()


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
    jmesh.install_rules(tg.reference_one_device_mesh(), cfg, BATCH,
                        kind="prefill")
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
