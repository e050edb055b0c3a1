"""One train step of the port (``loss_fn`` / ``make_train_step`` of the
``lm``, ``vit`` and ``resnet`` families, the kernels' backwards, the
chunked LM loss, remat) against the JAX reference on the CPU, on the same
seeded numpy weights (every leaf random) and ``SyntheticSource`` batches.

Tolerances (f32; the reference's step runs under ``jax.jit``, as its
train loop runs it): every gradient leaf within 2e-5 of its largest |g|
(~1e-6 seen: the same arithmetic, sums in another order), never below
1e-6 of the step's gradient norm (a gradient that is 0 in exact
arithmetic, such as DeiT's key bias, is rounding noise on both sides);
the moments within 2e-5 of their largest value, never below the floor
squared, and the first moment equal to the port's own first step,
``(1 - b1)`` times its clipped gradient, bit for bit (where a case's
gradients at the floor are noise that the floor squared cannot hold,
the smoke UNet's time-embedding projections ahead of a GroupNorm of one
channel a group, that exact step is their moments' only check, the
gradient check tying them to the reference's); the new parameters by
their update over the learning rate, ``(p_new - p_old) / lr``, within
1e-3 plus one f32 unit of the value (over ``lr``) wherever the gradient
is above 1e-3 of the leaf's largest (and the noise floor), and within
2.05 elsewhere: AdamW's first step is ``lr sign(g)``, so a gradient at
rounding noise may flip.  The golden file's limits are
``tests/train_golden.py``'s.
"""
import contextlib
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
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.steps import model_module as jax_module  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import batch_to, model_module  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.data import Spec, SyntheticSource  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_train_golden.npz"
GRAD_REL, MOM_REL, NOISE = 2e-5, 2e-5, 1e-6
UPD_LIVE, UPD_FLIP = 1e-3, 2.05
SMOKE = ("granite-moe-3b-a800m", "starcoder2-7b", "gemma3-27b", "deit-b",
         "resnet-50")


def both_configs(arch, **kw):
    return (dataclasses.replace(jax_smoke(arch), param_dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                                **kw))


def batch(cfg, B=2, S=24, seed=3):
    specs = tg.batch_specs(cfg.family, B, S, getattr(cfg, "img_res", 0),
                           cfg)
    return SyntheticSource({k: Spec(*v) for k, v in specs.items()},
                           seed).batch_at(0)


def reference_step(jcfg, tcfg, tree, b, ocfg_kw):
    mod = jax_module(jcfg)
    params = {}
    for path, d in model_module(tcfg).param_defs(tcfg).items():
        common.assign(params, path, jnp.asarray(common.nested(tree, path))
                      .astype(d.dtype))
    ocfg = jopt.AdamWConfig(**ocfg_kw)

    @jax.jit
    def step(params, batch):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: mod.loss_fn(p, batch, jcfg), has_aux=True)(params)
        new_p, state, om = jopt.adamw_update(
            params, grads, jopt.init_opt_state(params, ocfg), ocfg)
        return grads, new_p, state, dict(metrics, **om)

    grads, new_p, state, metrics = step(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    f = lambda t: {k: np.asarray(v, np.float32)  # noqa: E731
                   for k, v in tg.flat_leaves(t)}
    return f(grads), f(new_p), f(state.m), f(state.v), metrics


def port_step(tcfg, tree, b, ocfg_kw):
    mod = model_module(tcfg)
    params = mod.params_from_numpy(tree, tcfg, "cpu")
    ocfg = opt.AdamWConfig(**ocfg_kw)
    (_, metrics), grads = common.value_and_grad(
        lambda p: mod.loss_fn(p, batch_to(b, "cpu"), tcfg), params)
    new_p, state, om = opt.adamw_update(params, grads,
                                        opt.init_opt_state(params, ocfg),
                                        ocfg)
    lay = lambda t: {k: v.float().numpy() for k, v in  # noqa: E731
                     tg.flat_leaves(tg.reference_layout(tcfg, t))}
    return lay(grads), lay(new_p), lay(state.m), lay(state.v), \
        dict(metrics, **om)


@contextlib.contextmanager
def reference_mesh(jcfg, B):
    """The reference's one-device mesh with its train rules."""
    jmesh.install_rules(tg.reference_one_device_mesh(), jcfg, B,
                        kind="train")
    try:
        yield
    finally:
        jshd.clear_rules()


def check_step(arch, S=24, own_noise_moments=False, mesh=False, **cfg_kw):
    """One step of ``arch``'s smoke config in f32 against the reference;
    ``own_noise_moments``: a leaf whose gradient is at most the floor has
    its first moment held to the port's own step alone; ``mesh``: both
    steps under a 1 x 1 mesh with ``install_rules(kind="train")`` (the
    port's on one gloo rank)."""
    jcfg, tcfg = both_configs(arch, **cfg_kw)
    tree = tg.numpy_weights(tcfg)
    b = batch(tcfg, S=S)
    ocfg_kw = dict(lr=1e-3, warmup_steps=1)
    B = b["tokens"].shape[0] if "tokens" in b else 2
    with (reference_mesh(jcfg, B) if mesh else contextlib.nullcontext()):
        jg, jp, jm, jv, jmet = reference_step(jcfg, tcfg, tree, b, ocfg_kw)
    with (tg.one_rank_mesh(tcfg, B, "cpu") if mesh
          else contextlib.nullcontext()):
        tgr, tp, tm, tv, tmet = port_step(tcfg, tree, b, ocfg_kw)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-5, err_msg=k)
    lr = float(jmet["lr"])
    floor = NOISE * float(jmet["grad_norm"])
    ocfg = opt.AdamWConfig(**ocfg_kw)
    clip = opt._clip_scale(tmet["grad_norm"], ocfg.grad_clip)
    assert sorted(tgr) == sorted(jg)
    before = {k: np.asarray(v, np.float32)
              for k, v in tg.flat_leaves(tree)}
    for name in jg:
        g = jg[name]
        top = max(float(np.abs(g).max()), floor)
        np.testing.assert_allclose(tgr[name], g, rtol=0,
                                   atol=max(GRAD_REL * top, floor),
                                   err_msg=f"{arch} grad {name}")
        # the first step's first moment from the port's own clipped gradient
        assert torch.equal(torch.from_numpy(tm[name]), (1 - ocfg.b1) * (
            torch.from_numpy(tgr[name]) * clip)), f"{arch} moment {name}"
        noise = own_noise_moments and np.abs(g).max() <= floor
        for mine, want in ((tm, jm), (tv, jv))[int(noise):]:
            np.testing.assert_allclose(
                mine[name], want[name], rtol=0,
                atol=max(MOM_REL * float(np.abs(want[name]).max()),
                         floor ** 2), err_msg=f"{arch} moment {name}")
        upd_t = (tp[name] - before[name]) / lr
        upd_j = (jp[name] - before[name]) / lr
        live = np.abs(g) >= max(1e-3 * top, floor)
        lim = np.where(live, UPD_LIVE, UPD_FLIP) \
            + 2.0 ** -23 * np.abs(jp[name]) / lr
        assert (np.abs(upd_t - upd_j) <= lim).all(), f"{arch} update {name}"
    return tgr


@pytest.mark.parametrize("arch", SMOKE)
def test_train_step_matches_reference(arch):
    grads = check_step(arch)
    # every leaf of a smoke model gets a gradient
    assert all(np.abs(g).max() > 0 for g in grads.values())


def test_granite_train_step_chunked_remat_matches_reference():
    """Granite smoke on the published path: ``chunked`` attention over 3
    query chunks of 8 (each KV step checkpointed) and remat on."""
    check_step("granite-moe-3b-a800m", attn_impl="chunked", attn_chunk=8,
               remat=True)


# the smoke Granite on the reference's meshed path: the MoE through
# moe_ffn_sharded (3 padded experts, expert-sharded, copies dropped at
# capacity factor 1.25), chunked attention, remat on
MESH_SMOKE = dict(moe_impl="shard_map", n_experts_pad=8, moe_shard="expert",
                  capacity_factor=1.25, attn_impl="chunked", attn_chunk=8,
                  remat=True)


def test_meshed_granite_train_step_matches_reference():
    """The smoke Granite's train step under a 1 x 1 mesh (the port's on a
    gloo rank, the reference's on its one-device mesh, each with
    ``install_rules(kind="train")``) against the reference's jitted
    step, within this file's limits; the padded experts' gradient exactly
    0 on both sides."""
    grads = check_step("granite-moe-3b-a800m", mesh=True, **MESH_SMOKE)
    n = get_smoke_config("granite-moe-3b-a800m").n_experts
    for name in ("we_gate", "we_up", "we_down"):
        g = grads[f"layers/{name}"]
        assert not g[:, n:].any() and g[:, :n].any(), name
    assert not grads["layers/router"][..., n:].any()


def test_meshed_train_step_differs_from_unmeshed():
    """The same config without a mesh routes the padded experts (the
    reference's ``moe_ffn`` quirk): its gradient gives them a share, so
    the meshed check above tells the two paths apart."""
    _, tcfg = both_configs("granite-moe-3b-a800m", **MESH_SMOKE)
    tree = tg.numpy_weights(tcfg)
    g = port_step(tcfg, tree, batch(tcfg), dict(lr=1e-3, warmup_steps=1))[0]
    assert g["layers/we_gate"][:, tcfg.n_experts:].any()


def test_meshed_remat_on_equals_remat_off_bit_for_bit():
    """Under the 1 x 1 mesh remat recomputes each layer's sharded MoE,
    its collectives and its routing in the backward: the loss and every
    gradient equal the run without remat bit for bit."""
    _, cfg = both_configs("granite-moe-3b-a800m", **MESH_SMOKE)
    tree = tg.numpy_weights(cfg)
    b = batch_to(batch(cfg), "cpu")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = transformer.params_from_numpy(tree, c, "cpu")
        with tg.one_rank_mesh(c, 2, "cpu"):
            (loss, _), grads = common.value_and_grad(
                lambda p: transformer.loss_fn(p, b, c), params)
        out.append((loss, list(common.leaves(grads))))
    assert torch.equal(out[0][0], out[1][0])
    for x, y in zip(out[0][1], out[1][1]):
        assert torch.equal(x, y)


def test_train_cell_step_runs_the_sharded_moe_under_installed_rules():
    """``build_cell``'s train step takes the mesh branch when rules with
    a mesh are installed (one ``moe_ffn_sharded`` call a layer, and one
    more under remat), as the reference's cell lowers under its mesh, and
    the unmeshed ``moe_ffn`` without them."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.models import moe
    _, cfg = both_configs("granite-moe-3b-a800m", **MESH_SMOKE)
    shape = ShapeSpec("smoke_train", "train", seq_len=24, global_batch=2)
    calls = {"sharded": 0, "plain": 0}
    real = {"sharded": moe.moe_ffn_sharded, "plain": moe.moe_ffn}

    def counted(kind):
        def fn(*a, **k):
            calls[kind] += 1
            return real[kind](*a, **k)
        return fn

    moe.moe_ffn_sharded, moe.moe_ffn = counted("sharded"), counted("plain")
    try:
        for meshed in (True, False):
            cell = steps.build_cell(cfg.name, shape.name, cfg=cfg,
                                    shape=shape)
            args = cell.make_args(0, "cpu")
            with (tg.one_rank_mesh(cfg, 2, "cpu") if meshed
                  else contextlib.nullcontext()):
                _, _, met = cell.step_fn(*args)
            assert np.isfinite(float(met["loss"]))
            want = 2 * cfg.n_layers
            assert calls == ({"sharded": want, "plain": 0} if meshed else
                             {"sharded": want, "plain": want}), calls
    finally:
        moe.moe_ffn_sharded, moe.moe_ffn = real["sharded"], real["plain"]


def test_remat_on_equals_remat_off_bit_for_bit():
    _, cfg = both_configs("granite-moe-3b-a800m", attn_impl="chunked",
                          attn_chunk=8)
    tree = tg.numpy_weights(cfg)
    b = batch_to(batch(cfg), "cpu")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = transformer.params_from_numpy(tree, c, "cpu")
        (loss, _), grads = common.value_and_grad(
            lambda p: transformer.loss_fn(p, b, c), params)
        out.append((loss, list(common.leaves(grads))))
    assert torch.equal(out[0][0], out[1][0])
    for x, y in zip(out[0][1], out[1][1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,d", [(6, 48), (5, 7), (3, 1536), (3, 4608),
                                 (2, 5376), (2, 7168)])
def test_rmsnorm_backward_matches_jax_vjp(R, d, dtype):
    rng = np.random.default_rng(R * d)
    x = rng.standard_normal((2, R, d)).astype(np.float32)
    s = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, R, d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(jcommon.rms_norm, jnp.asarray(x).astype(jdt),
                     jnp.asarray(s).astype(jdt))
    jdx, jds = vjp(jnp.asarray(dy).astype(jdt))
    tdt = getattr(torch, dtype)
    tx, ts, tdy = (torch.from_numpy(a).to(tdt) for a in (x, s, dy))
    dx, ds = ref.rmsnorm_bwd_ref(tx, ts, tdy)
    assert dx.dtype == ds.dtype == tdt
    tol = ref.rmsnorm_bwd_tolerance(tx, ts, tdy)
    torch.testing.assert_close(dx.float(), torch.from_numpy(
        np.asarray(jdx, np.float32)), **tol["dx"])
    torch.testing.assert_close(ds.float(), torch.from_numpy(
        np.asarray(jds, np.float32)), **tol["dscale"])
    # the entry point's autograd is the plain backward on the CPU
    lx, ls = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    ops.rmsnorm(lx, ls).backward(tdy)
    assert torch.equal(lx.grad, dx) and torch.equal(ls.grad, ds)
    # the tolerance rejects a dscale without its last row
    bad = ds.float() - (tdy.float() * tx.float() * torch.rsqrt(
        tx.float().square().mean(-1, keepdim=True) + 1e-6))[-1, -1]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad, ds.float(), **tol["dscale"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1536, 4608, 5376, 7168])
def test_rmsnorm_bwd_tolerance_rejects_a_dropped_dscale(d, dtype):
    """``ref.rmsnorm_bwd_tolerance`` at the LM train steps' widths
    (Granite-3.0 MoE, StarCoder2-7B, Gemma-3 27B, Kimi-K2), the check
    phase 6a of ``chip_smoke.py`` makes on the card: the plain version's
    dscale passes against the f64 sum of the same terms, and a dscale
    without its last row or a dscale of 0 is rejected."""
    R = 1024
    rng = np.random.default_rng(d)
    tdt = getattr(torch, dtype)
    x, dy = (torch.from_numpy(rng.standard_normal((R, d)).astype(np.float32))
             .to(tdt) for _ in range(2))
    s = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32)
                         ).to(tdt)
    _, ds = ref.rmsnorm_bwd_ref(x, s, dy)
    tol = ref.rmsnorm_bwd_tolerance(x, s, dy)["dscale"]
    x64, dy64 = x.double(), dy.double()
    terms = dy64 * x64 * torch.rsqrt(x64.square().mean(-1, keepdim=True)
                                     + 1e-6)
    torch.testing.assert_close(ds.double(), terms.sum(0), **tol)
    for bad in (terms[:-1].sum(0), torch.zeros(d, dtype=torch.float64)):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(bad.to(tdt).double(), ds.double(),
                                       **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_gradients_match_jax_vjp(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 13, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 24)).astype(np.float32) * 0.1
    dy = rng.standard_normal((3, 13, 24)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(jref.moe_gemm_ref, jnp.asarray(x).astype(jdt),
                     jnp.asarray(w).astype(jdt))
    jdx, jdw = (np.asarray(a, np.float32)
                for a in vjp(jnp.asarray(dy).astype(jdt)))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    ops.moe_gemm(tx, tw).backward(torch.from_numpy(dy).to(tdt))
    assert tx.grad.dtype == tw.grad.dtype == tdt
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=1e-5 * np.abs(want).max())
    # the contraction over C padded with zero rows (the card's dW) adds
    # exactly: the product is the same bits
    xt = tx.detach().transpose(1, 2).contiguous()
    g = torch.from_numpy(dy).to(tdt)
    assert torch.equal(ops._moe_gemm(ops._pad_rows(xt, 8, 2),
                                     ops._pad_rows(g, 8, 1)),
                       ops._moe_gemm(xt, g))
    assert ops._pad_rows(xt, 8, 2).shape[-1] == 16


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 550), (1100,), (3, 7)])
def test_embedding_backward_matches_jax_vjp_bit_for_bit(shape, dtype):
    """``common.embedding``'s gradient equals ``jax.vjp`` of the
    reference's ``jnp.take`` (jitted: XLA's scatter-add) bit for bit: each
    id's rows summed in row order in the table's dtype; on 8 ids as
    ``SyntheticSource`` draws them, ~137 rows an id at 1,100 tokens.
    ``F.embedding``'s backward on the card sums a bf16 table's rows in
    f32 (``chip_smoke.py`` phase 6a measures the gap there)."""
    rng = np.random.default_rng(len(shape))
    V, d = 50, 16
    w = rng.standard_normal((V, d)).astype(np.float32)
    tok = rng.integers(0, 8, shape).astype(np.int32)
    dy = rng.standard_normal(shape + (d,)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jax.jit(lambda w, dy: jax.vjp(
        lambda w: jnp.take(w, jnp.asarray(tok), axis=0), w)[1](dy)[0])(
        jnp.asarray(w).astype(jdt), jnp.asarray(dy).astype(jdt))
    tdt = getattr(torch, dtype)
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    out = common.embedding(tw, torch.from_numpy(tok).long())
    assert torch.equal(out.detach(), tw.detach()[torch.from_numpy(tok).long()])
    out.backward(torch.from_numpy(dy).to(tdt))
    assert tw.grad.dtype == tdt
    assert np.array_equal(tw.grad.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_chunked_lm_loss_with_a_remainder_matches_reference():
    """B=2, S=37 in chunks of 16: two chunks and a remainder of 5; the loss
    and its gradients in h and the head; a remainder taken from the front
    of the sequence fails."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 37, 8)).astype(np.float32)
    head = rng.standard_normal((8, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 37)).astype(np.int32)
    jl, (jh, jw) = jax.value_and_grad(
        lambda a, b: jtr.chunked_lm_loss(a, b, jnp.asarray(labels), 16),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    loss = transformer.chunked_lm_loss(th, tw, torch.from_numpy(labels), 16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), atol=1e-6)
    bad = tg._remainder_misordered(th.detach(), tw.detach(),
                                   torch.from_numpy(labels), 16)
    assert abs(float(bad) - float(jl)) > 1e-3


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 3, 9)).astype(np.float32) * 4
    labels = rng.integers(0, 9, (4, 3)).astype(np.int32)
    want = float(jcommon.softmax_xent(jnp.asarray(logits),
                                      jnp.asarray(labels)))
    got = float(common.softmax_xent(torch.from_numpy(logits),
                                    torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_wrappers_without_a_backward_raise_under_grad():
    """flash_attention's plain version (the CPU) stays differentiable; the
    admission and event entry points raise under grad, on any device."""
    q = torch.randn(1, 6, 2, 8, requires_grad=True)
    k, v = torch.randn(1, 6, 2, 8), torch.randn(1, 6, 2, 8)
    ops.flash_attention(q, k, v).sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().max() > 0
    starts = torch.zeros(2, 4, requires_grad=True)
    z = torch.zeros(2, 4)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fleet_feasibility(starts, z, z, n, torch.ones(2), 5.0, torch.zeros(2))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.link_cost(starts, z, z, n, torch.ones(2), 5.0, torch.zeros(2), None, 0.0,
                      torch.zeros(2), torch.zeros(2), 0.0)
    with torch.no_grad():
        ops.fleet_feasibility(starts, z, z, n, torch.ones(2),
                              torch.tensor(5.0), torch.zeros(2))


def test_flash_attention_raises_under_grad_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)


def golden():
    if not GOLDEN.exists():
        pytest.fail(f"{GOLDEN} is missing: run tests/make_torch_train_golden.py")
    return np.load(GOLDEN)


CPU_SECTIONS = ("deit/float32", "smoke/deit-smoke", "smoke/resnet-smoke",
                "smoke/granite-moe-smoke")


@pytest.mark.parametrize("name", CPU_SECTIONS)
def test_golden_sections_on_the_cpu(name):
    """The golden's DeiT-B (full width, 2 layers) and smoke sections (the
    smoke Granite over 3 steps) held to their limits on the CPU; the
    full-width Granite sections (390 M parameters) are held on the card,
    by chip_smoke.py phase 6b."""
    g = golden()
    cfg = tg.port_configs()[name]
    rec, losses = tg.port_record(name, cfg, g)
    assert not tg.fails(tg.compare(rec, g, name, cfg.param_dtype))
    np.testing.assert_allclose(losses, g[name + "/losses"], rtol=2e-5)


@pytest.mark.parametrize("fault", ["no_dscale", "no_autograd", "no_aux",
                                   "no_bias_correction", "embed_overwrite"])
def test_golden_rejects_planted_faults(fault):
    """On the smoke Granite's section (3 steps): a zero dscale, a wrapper
    without autograd (every norm scale's gradient lost), the aux term
    dropped, AdamW without bias correction.  (A misordered loss remainder
    needs more than 512 tokens: the full-width section on the card, and
    the unit test above.)  An embedding backward that overwrites rows
    instead of adding them."""
    g = golden()
    name = "smoke/granite-moe-smoke"
    cfg = tg.port_configs()[name]
    with tg.planted(fault):
        rec, _ = tg.port_record(name, cfg, g)
    bad = tg.fails(tg.compare(rec, g, name, cfg.param_dtype))
    assert bad, fault
    if fault in ("no_dscale", "no_autograd"):
        assert f"{name}/layers/ln1/gnorm" in bad
