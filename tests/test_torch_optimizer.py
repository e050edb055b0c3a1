"""The port's AdamW (``repro_torch.training.optimizer``) against
``repro.training.optimizer`` on the CPU, on seeded numpy trees, and the
reference's own optimizer tests (``tests/test_training.py``) mirrored.

Tolerances: the reference's update runs under ``jax.jit`` here, as its
train step does, and XLA may contract ``b1 * m + (1 - b1) * g`` and the
like into fused multiply-adds, where the port rounds each product.  So
``m`` and ``v`` (f32) agree within 2e-7 relative (a few ulp) plus 2^-21
of the leaf's largest value (where the two terms cancel), the learning
rate and the norm within 1e-6 relative, and the new parameters within 1e-6
of their size plus 1e-6 ``lr`` (f32; AdamW divides the moments, so the
ulps of m and v reach the update scaled by ``lr``); bf16 state and
parameters within one bf16 unit (2^-8 relative) of each value, where
either side may round the other way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro_torch.training import optimizer as opt

SCHEDULES = ("cosine", "constant", "linear_warmup")


def trees(seed, dtype="float32", scale=1.0):
    """A nested (params, grads) pair of numpy f32 arrays, with one stacked
    leaf of 3 layers."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7,), "b": {"c": (3, 5), "d": (2, 4, 6)}, "e": ()}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return make(shapes), make(shapes)


def to_jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                  tree)


def to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def tflat(tree):
    return [x.float().numpy() for x in _leaves(tree)]


def jflat(tree):
    return [np.asarray(jnp.asarray(x).astype(jnp.float32))
            for x in jax.tree_util.tree_leaves(tree)]


def run_both(seed, steps=3, state_dtype="float32", param_dtype="float32",
             **cfg_kw):
    """``steps`` AdamW updates of each package from the same trees; the
    gradients are fresh seeded trees each step."""
    p_np, _ = trees(seed)
    jcfg = jopt.AdamWConfig(state_dtype=jnp.dtype(state_dtype), **cfg_kw)
    tcfg = opt.AdamWConfig(state_dtype=state_dtype, **cfg_kw)
    jp, tp = to_jax(p_np, param_dtype), to_torch(p_np, getattr(
        torch, param_dtype))
    js, ts = jopt.init_opt_state(jp, jcfg), opt.init_opt_state(tp, tcfg)
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jcfg))
    for k in range(steps):
        _, g_np = trees(seed * 100 + k, scale=0.3 + k)
        jp, js, jm = upd(jp, to_jax(g_np, param_dtype), js)
        tp, ts, tm = opt.adamw_update(tp, to_torch(g_np, getattr(
            torch, param_dtype)), ts, tcfg)
    return (jp, js, jm), (tp, ts, tm)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_adamw_matches_reference_f32(schedule):
    (jp, js, jm), (tp, ts, tm) = run_both(
        1, steps=4, schedule=schedule, lr=1e-2, warmup_steps=2,
        total_steps=6)
    assert int(ts.step) == int(js.step) == 4
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for a, b in zip(tflat(ts.m) + tflat(ts.v), jflat(js.m) + jflat(js.v)):
        np.testing.assert_allclose(a, b, rtol=2e-7,
                                   atol=2.0 ** -21 * np.abs(b).max())
    for a, b in zip(tflat(tp), jflat(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * 1e-2)


def test_adamw_matches_reference_bf16_state_and_params():
    (jp, js, jm), (tp, ts, tm) = run_both(2, steps=3, state_dtype="bfloat16",
                                          param_dtype="bfloat16", lr=1e-2,
                                          warmup_steps=1)
    for t_tree, j_tree in ((ts.m, js.m), (ts.v, js.v), (tp, jp)):
        for x in _leaves(t_tree):
            assert x.dtype == torch.bfloat16
        for a, b in zip(tflat(t_tree), jflat(j_tree)):
            np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=1e-30)


def test_clip_and_global_norm_match_reference():
    _, g_np = trees(5, scale=50.0)
    jg, tg = to_jax(g_np, jnp.float32), to_torch(g_np, torch.float32)
    np.testing.assert_allclose(float(opt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-6)
    (tc, tn), (jc, jn) = opt.clip_by_global_norm(tg, 1.0), \
        jopt.clip_by_global_norm(jg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tflat(tc), jflat(jc)):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-9)
    # below the limit the gradients pass unchanged
    small, _ = opt.clip_by_global_norm(tg, 1e9)
    for a, b in zip(tflat(small), tflat(tg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match_reference(schedule):
    jcfg = jopt.AdamWConfig(lr=0.5, warmup_steps=7, total_steps=40,
                            schedule=schedule)
    tcfg = opt.AdamWConfig(lr=0.5, warmup_steps=7, total_steps=40,
                           schedule=schedule)
    for s in (0, 1, 6, 7, 8, 20, 39, 40, 55):
        want = float(jax.jit(lambda k: jopt.schedule_lr(jcfg, k))(
            jnp.asarray(s, jnp.int32)))
        got = float(opt.schedule_lr(tcfg, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_chunked_update_equals_whole(monkeypatch):
    """A leaf updated a chunk of its leading axis at a time (the full-width
    expert leaves) gets the same bits as when updated whole."""
    p_np, g_np = trees(7)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1)
    whole_p = to_torch(p_np, torch.float32)
    whole = opt.adamw_update(whole_p, to_torch(g_np, torch.float32),
                             opt.init_opt_state(whole_p, cfg), cfg)
    monkeypatch.setattr(opt, "CHUNK", 8)
    part_p = to_torch(p_np, torch.float32)
    part = opt.adamw_update(part_p, to_torch(g_np, torch.float32),
                            opt.init_opt_state(part_p, cfg), cfg)
    for a, b in zip(tflat(part[0]) + tflat(part[1].m) + tflat(part[1].v),
                    tflat(whole[0]) + tflat(whole[1].m) + tflat(whole[1].v)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(part[2]["grad_norm"]),
                               float(whole[2]["grad_norm"]), rtol=1e-6)


def test_update_is_in_place_and_grads_untouched():
    p_np, g_np = trees(3)
    cfg = opt.AdamWConfig(lr=1e-2, grad_clip=0.5, warmup_steps=1)
    p = to_torch(p_np, torch.float32)
    g = to_torch(g_np, torch.float32)
    state = opt.init_opt_state(p, cfg)
    ptr = p["b"]["c"].data_ptr()
    new_p, new_state, _ = opt.adamw_update(p, g, state, cfg)
    assert new_p["b"]["c"].data_ptr() == ptr
    assert new_state.m is state.m and int(new_state.step) == 1
    for a, b in zip(tflat(g), [np.asarray(x, np.float32)
                               for x in _leaves(g_np)]):
        np.testing.assert_array_equal(a, b)


# -- the reference's own optimizer tests, mirrored ---------------------------
def test_adamw_reduces_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0, schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params, cfg)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.adamw_update(params, grads, state, cfg)
    assert float((params["w"] ** 2).sum()) < 0.1


def test_grad_clip_reports_norm():
    cfg = opt.AdamWConfig(grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    state = opt.init_opt_state(params, cfg)
    _, _, metrics = opt.adamw_update(params, {"w": torch.full((4,), 100.0)},
                                     state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_bf16_state_dtype():
    cfg = opt.AdamWConfig(state_dtype="bfloat16")
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = opt.init_opt_state(params, cfg)
    assert state.m["w"].dtype == torch.bfloat16
    _, state, _ = opt.adamw_update(
        params, {"w": torch.ones(4, dtype=torch.bfloat16)}, state, cfg)
    assert state.v["w"].dtype == torch.bfloat16


def test_schedule_warmup_and_decay():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(opt.schedule_lr(cfg, torch.tensor(s))) for s in
           (0, 5, 10, 50, 99)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] >= lrs[3] >= lrs[4]
    assert lrs[4] < 0.05
