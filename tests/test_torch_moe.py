"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, with the same numpy inputs.

The integer outputs (capacity, the routed experts, the dispatch plan) are
held equal; gates, the aux loss and the layer's output in f32 within
``ATOL`` 5e-6 (2e-6 of the largest output, 2.4; observed up to 6.0e-7:
the products sum in another order, and the combine sums each token's K
copies in k order where the reference scatter-adds them), the aux loss
within 1e-6 (observed 1.2e-7); in bf16 within one bf16 unit of the output
(``BF16_RTOL`` 2^-7, with ``atol`` 2^-7 x max|want| for elements near
zero: the expert products round to bf16 on both sides).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.models import moe, transformer

ATOL = 5e-6
BF16_RTOL = 2.0 ** -7


@pytest.mark.parametrize("T,E,K,cf", [(1, 48, 8, 1.25), (16, 48, 8, 1.25),
                                      (2200, 48, 8, 1.25), (32768, 48, 8, 1.25),
                                      (7, 5, 2, 64.0), (100, 8, 2, 0.3)])
def test_capacity_matches_reference(T, E, K, cf):
    """Granite's capacity at decode (B = 1, 16: C = 1, 4), at the golden's
    2,200 tokens and at the 32k prefill (6,826), and the smoke configs'."""
    assert moe.capacity(T, E, K, cf) == jmoe.capacity(T, E, K, cf)
    assert [moe.capacity(n, 48, 8, 1.25) for n in (1, 16, 32768)] == \
        [1, 4, 6826]


def logits_with_ties(T, E, seed):
    """Random router logits with planted exact ties: row 0 all equal, row 1
    two equal leaders, row 2 a tie across the top-k boundary."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E), dtype=np.float32)
    x[0] = 0.5
    x[1, 3] = x[1, 1] = 9.0
    x[2, :] = -1.0
    x[2, [0, 2, 4, E - 1]] = 2.0
    return x


@pytest.mark.parametrize("n_real", [None, 5])
def test_route_topk_matches_reference_with_ties(n_real):
    """Experts equal as integers, lower index first on an exact tie (as
    ``jax.lax.top_k``), gates within ``ATOL``; with ``n_real`` the padded
    columns never route."""
    x = logits_with_ties(40, 8, 0)
    jg, je = jmoe.route_topk(jnp.asarray(x), 3, n_real)
    g, e = moe.route_topk(torch.from_numpy(x), 3, n_real)
    assert e.dtype == torch.int32
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=ATOL)
    assert e[0].tolist() == [0, 1, 2] and e[1, :2].tolist() == [1, 3]
    if n_real:
        assert int(e.max()) < n_real


def test_dispatch_indices_match_reference():
    """The sort-based plan on crowded experts (slots in token order within
    an expert; copies past the capacity dropped), equal as integers."""
    rng = np.random.default_rng(1)
    experts = rng.integers(0, 6, (300, 2)).astype(np.int32)
    experts[:40] = [0, 1]                      # crowd experts 0 and 1
    for cap in (1, 4, 37, 300):
        want = jmoe.dispatch_indices(jnp.asarray(experts), 6, cap)
        got = moe.dispatch_indices(torch.from_numpy(experts), 6, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2].all() or cap >= 300


def test_load_balancing_loss_matches_reference():
    x = logits_with_ties(64, 8, 2)
    _, e = jmoe.route_topk(jnp.asarray(x), 2)
    want = float(jmoe.load_balancing_loss(jnp.asarray(x), e, 8))
    got = float(moe.load_balancing_loss(torch.from_numpy(x),
                                        torch.tensor(np.asarray(e)), 8))
    assert abs(got - want) <= 1e-6 * want


def ffn_inputs(T, d, E, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d), dtype=np.float32)
    rw = rng.standard_normal((d, E), dtype=np.float32) / np.float32(d ** 0.5)
    wg, wu = (rng.standard_normal((E, d, f), dtype=np.float32)
              / np.float32(d ** 0.5) for _ in range(2))
    wd = rng.standard_normal((E, f, d), dtype=np.float32) \
        / np.float32(f ** 0.5)
    return x, rw, wg, wu, wd


def both_ffn(args, dtype, **kw):
    """The layer in both packages: x and the expert weights in ``dtype``,
    the router f32."""
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    x, rw, wg, wu, wd = args
    want = jmoe.moe_ffn(jnp.asarray(x).astype(jd), jnp.asarray(rw),
                        *(jnp.asarray(w).astype(jd) for w in (wg, wu, wd)),
                        **kw)
    got = moe.moe_ffn(torch.from_numpy(x).to(td), torch.from_numpy(rw),
                      *(torch.from_numpy(w).to(td) for w in (wg, wu, wd)),
                      **kw)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [64.0, 1.0, 0.25])
def test_moe_ffn_matches_reference(cf, dtype):
    """Drop-free (64), some copies dropped (1.0) and most dropped (0.25):
    output and aux loss."""
    args = ffn_inputs(96, 32, 6, 24, 3)
    (out, aux), (jout, jaux) = both_ffn(args, dtype, top_k=2,
                                        capacity_factor=cf)
    assert out.dtype == getattr(torch, dtype)
    want = np.asarray(jout.astype(jnp.float32))
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(want).max())
    assert abs(float(aux) - float(jaux)) <= 1e-6
    plan = moe.dispatch_indices(
        moe.route_topk(torch.from_numpy(args[0]) @ torch.from_numpy(args[1]),
                       2)[1], 6, moe.capacity(96, 6, 2, cf))
    dropped = int((~plan[2]).sum())
    assert (dropped == 0) == (cf == 64.0)
    if cf < 1:
        assert (np.abs(want).sum(1) == 0).any()   # tokens with no expert


def test_padded_experts_route_like_real_ones_in_both_packages():
    """The reference quirk the port keeps: ``moe_ffn`` takes ``n_real`` and
    does not use it, so the padded experts (columns >= n_real of the
    router, random weights) are routed to as real ones and size the
    capacity.  Both packages route some tokens to an expert >= n_real, and
    agree; masking the router to ``n_real`` (what the reference's sharded
    path does) gives another output."""
    args = ffn_inputs(64, 32, 8, 16, 4)
    kw = dict(top_k=2, capacity_factor=1.25, n_real=5)
    (out, _), (jout, _) = both_ffn(args, "float32", **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    logits = torch.from_numpy(args[0]) @ torch.from_numpy(args[1])
    _, e = moe.route_topk(logits, 2)
    _, je = jmoe.route_topk(jnp.asarray(args[0]) @ jnp.asarray(args[1]), 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert int((e >= 5).sum()) > 0
    masked = moe.route_topk(logits, 2, n_real=5)[1]
    assert int(masked.max()) < 5 and not torch.equal(masked, e)


def test_granite_layer_routes_to_padded_experts_as_the_reference():
    """Granite's own layer (40 experts padded to 48, top-8) at d 1536 on
    48 tokens: ``transformer._ffn`` of the port and of the reference agree
    and both send copies to experts 40-47."""
    jcfg = dataclasses.replace(jax_config("granite-moe-3b-a800m"),
                               n_layers=1, param_dtype="float32")
    tcfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                               n_layers=1, param_dtype="float32")
    rng = np.random.default_rng(5)
    E, d, f = 48, 1536, 512
    lp = {"router": rng.standard_normal((d, E), dtype=np.float32) / 40,
          **{n: rng.standard_normal(s, dtype=np.float32)
             / np.float32(s[1] ** 0.5)
             for n, s in (("we_gate", (E, d, f)), ("we_up", (E, d, f)),
                          ("we_down", (E, f, d)))}}
    x = rng.standard_normal((1, 48, d), dtype=np.float32)
    jout, _ = jtr._ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in lp.items()}, jcfg)
    out, _ = transformer._ffn(torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in lp.items()},
                              tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    _, e = moe.route_topk(torch.from_numpy(x[0]) @ torch.from_numpy(
        lp["router"]), 8)
    assert int((e >= tcfg.n_experts).sum()) > 0
