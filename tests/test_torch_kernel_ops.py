"""The port's four entry-point kernels on the CPU against the JAX package:
``repro_torch.kernels.ops.{fleet_feasibility, link_cost, rmsnorm,
moe_gemm}`` (their plain versions, on CPU tensors) vs the jitted
``repro.kernels.ops`` wrappers (the Pallas kernels in interpret mode), on
the JAX tests' own cases.

Bars:
- ``fleet_feasibility``, ``link_cost``: bit for bit on ``feasible`` and
  ``arrive``, and on ``load`` where the ledger sizes are dyadic (integer
  service times); within a relative 1e-6 elsewhere (the sum's order).
- ``rmsnorm``: ``ref.rmsnorm_tolerance`` — f32 rtol 2e-6, bf16 one bf16
  unit (the jitted and eager references differ by 1 ulp; rsqrt is not
  correctly rounded everywhere).
- ``moe_gemm``: ``ref.moe_gemm_tolerance`` — rtol 1e-5 (f32) or one bf16
  unit, atol growing with sqrt(d) (the sum's order).

The kernels themselves run only on the card: tests/test_torch_gpu.py holds
them against their plain versions there.
"""
import inspect
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_queue as jq
from repro.kernels import ops as jops
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.kernels import admission, build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models.common import rms_norm

FLEETS = [(1, 8), (5, 16), (12, 32)]
LOAD_RTOL = 1e-6
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _random_fleet(rng, K, N, retired=False, sizes_scale=1.0):
    """tests/test_fleetsim.py's fleet — K ledgers grown by ``jq.push`` —
    as numpy arrays ``(starts, ends, sizes, n, head, busy)``; with
    ``retired``, a random prefix of each row is retired (head-pointer
    rows: -BIG / 0 slots in front, ``head`` set), else ``head`` is None."""
    leds, busy = [], []
    for _ in range(K):
        led = jq.empty_ledger(N)
        free = rng.uniform(0, 50)
        for _ in range(rng.randrange(0, N + 2)):
            led, _ = jq.push(led, jnp.float32(rng.choice([5.0, 20.0, 44.0])),
                             jnp.float32(rng.uniform(10, 9000)),
                             jnp.float32(free))
        leds.append(led)
        busy.append(free)
    starts, ends, sizes, n = (
        np.stack([np.asarray(getattr(led, f)) for led in leds])
        for f in ("starts", "ends", "sizes", "n"))
    head = None
    if retired:
        head = np.minimum([rng.randrange(0, 4) for _ in range(K)], n)
        for k in range(K):
            h = head[k]
            starts[k] = np.concatenate([np.full(h, -jq.BIG),
                                        starts[k, :N - h]])
            ends[k] = np.concatenate([np.full(h, -jq.BIG), ends[k, :N - h]])
            sizes[k] = np.concatenate([np.zeros(h), sizes[k, :N - h]])
        n = n - head
        head = head.astype(np.int32)
    sizes = (sizes * np.float32(sizes_scale)).astype(np.float32)
    return (starts, ends, sizes, n.astype(np.int32), head,
            np.asarray(busy, np.float32))


def _deadlines(starts, n, head):
    """The JAX tests' deadlines plus one on a block edge (a ``<`` tie)."""
    k = int(np.argmax(n))
    h = 0 if head is None else int(head[k])
    edge = [float(starts[k, h])] if n[k] else []
    return [30.0, 400.0, 8000.0] + edge


def _t(args):
    return tuple(None if a is None else torch.from_numpy(np.asarray(a))
                 for a in args)


def _j(args):
    return tuple(None if a is None else jnp.asarray(a) for a in args)


def _assert_equal(got, want, exact=True):
    """Bit for bit; the last output (``load``) within LOAD_RTOL unless
    ``exact``."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if i == len(got) - 1 and not exact:
            np.testing.assert_allclose(g, w, rtol=LOAD_RTOL, atol=0)
        else:
            assert np.array_equal(g, w), (i, g, w)


# ---------------------------------------------------------------------------
# fleet_feasibility and link_cost
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("retired", [False, True])
@pytest.mark.parametrize("K,N", FLEETS)
def test_fleet_feasibility_matches_pallas(K, N, retired):
    rng = random.Random(K * 31 + N + retired)
    starts, ends, sizes, n, head, busy = _random_fleet(rng, K, N, retired)
    ps = np.asarray([rng.choice([5.0, 20.0, 44.0, 180.0]) for _ in range(K)],
                    np.float32)
    for d in _deadlines(starts, n, head):
        args = (starts, ends, sizes, n, ps, np.float32(d), busy, head)
        _assert_equal(ops.fleet_feasibility(*_t(args)),
                      jops.fleet_feasibility(*_j(args)))


LINK_CASES = ((400.0, 10.0, 24.8832), (8000.0, 120.0, 2.0736),
              (60.0, 0.0, 0.9216))


def _link_rows(rng, K):
    lat = np.asarray([rng.uniform(0.0, 120.0) for _ in range(K)], np.float32)
    ibw = np.asarray([rng.choice([0.0, 0.1, 0.8, 1.0]) for _ in range(K)],
                     np.float32)
    ps = np.asarray([rng.choice([5.0, 20.0, 44.0, 180.0]) for _ in range(K)],
                    np.float32)
    return lat, ibw, ps


@pytest.mark.parametrize("retired", [False, True])
@pytest.mark.parametrize("K,N", FLEETS)
def test_link_cost_matches_pallas(K, N, retired):
    rng = random.Random(K * 131 + N + retired)
    starts, ends, sizes, n, head, busy = _random_fleet(rng, K, N, retired)
    lat, ibw, ps = _link_rows(rng, K)
    edge = _deadlines(starts, n, head)[3:]
    for d, t, payload in LINK_CASES + tuple((e, 5.0, 6.2208) for e in edge):
        args = (starts, ends, sizes, n, ps, np.float32(d), busy, head,
                np.float32(t), lat, ibw, np.float32(payload))
        _assert_equal(ops.link_cost(*_t(args)), jops.link_cost(*_j(args)))


def test_link_cost_non_dyadic_sizes():
    """Sizes of 1/3 UT multiples: feasible and arrive exact, load within a
    relative 1e-6."""
    rng = random.Random(5)
    starts, ends, sizes, n, head, busy = _random_fleet(
        rng, 6, 16, retired=True, sizes_scale=1.0 / 3.0)
    lat, ibw, ps = _link_rows(rng, 6)
    for d, t, payload in LINK_CASES:
        args = (starts, ends, sizes, n, ps, np.float32(d), busy, head,
                np.float32(t), lat, ibw, np.float32(payload))
        _assert_equal(ops.link_cost(*_t(args)), jops.link_cost(*_j(args)),
                      exact=False)


def test_link_cost_arrival_is_one_fused_multiply_add():
    """The jitted reference rounds ``t + lat + payload * inv_bw`` once after
    the product (XLA's contraction); the port's plain version does too.
    Over these 1600 arrivals, rounding the product first differs on some."""
    rng = np.random.default_rng(0)
    K, N = 40, 8
    starts = np.full((K, N), 1e30, np.float32)
    sizes = np.zeros((K, N), np.float32)
    n = np.zeros(K, np.int32)
    busy = np.zeros(K, np.float32)
    ps = np.ones(K, np.float32)
    two_roundings_differ = 0
    for _ in range(40):
        lat = rng.uniform(0, 120, K).astype(np.float32)
        ibw = rng.choice([0.1, 0.8, 1.0 / 3.0], K).astype(np.float32)
        t = np.float32(rng.uniform(0, 200))
        pay = np.float32(rng.uniform(0, 30))
        args = (starts, starts, sizes, n, ps, np.float32(9000.0), busy, None,
                t, lat, ibw, pay)
        got = ops.link_cost(*_t(args))[1].numpy()
        assert np.array_equal(got, np.asarray(jops.link_cost(*_j(args))[1]))
        want = ref.fma32(torch.full((K,), float(pay)), torch.from_numpy(ibw),
                         torch.tensor(t) + torch.from_numpy(lat))
        assert np.array_equal(got, want.numpy())
        two_roundings_differ += int(((t + lat) + pay * ibw != got).sum())
    assert two_roundings_differ > 0


def test_link_cost_zero_delay_is_fleet_feasibility():
    rng = random.Random(42)
    K, N = 6, 16
    starts, ends, sizes, n, head, busy = _random_fleet(rng, K, N, True)
    ps = torch.full((K,), 20.0)
    zeros = torch.zeros(K)
    st, en, sz, nn, hd, bz = _t((starts, ends, sizes, n, head, busy))
    for d, t in ((300.0, 0.0), (4000.0, 55.0)):
        feas, arrive, load = ops.link_cost(
            st, en, sz, nn, ps, torch.tensor(d), bz, hd, torch.tensor(t),
            zeros, zeros, torch.tensor(24.8))
        base = ops.fleet_feasibility(st, en, sz, nn, ps, torch.tensor(d),
                                     torch.maximum(torch.tensor(t), bz), hd)
        assert torch.equal(feas, base[0]) and torch.equal(load, base[1])
        assert torch.equal(arrive, torch.full((K,), t))


def _event_select_args(rng, K, N):
    """One event_select input: a head-pointer fleet, a priced (K, K)
    network with a zero diagonal and two candidate events."""
    starts, ends, sizes, n, head, busy = _random_fleet(rng, K, N, True)
    speeds = np.asarray([rng.choice([0.5, 1.0, 2.0]) for _ in range(K)],
                        np.float32)
    lat = np.asarray([[0.0 if i == j else rng.uniform(0.0, 120.0)
                       for j in range(K)] for i in range(K)], np.float32)
    ibw = np.asarray([[0.0 if i == j else rng.choice([0.0, 0.1, 0.8, 1.0])
                       for j in range(K)] for i in range(K)], np.float32)
    f = np.float32
    cand = lambda t, p: (f(t), np.int32(rng.randrange(K)),
                         f(rng.uniform(50, 9000)), f(p),
                         f(rng.choice([0.92, 24.88])), np.bool_(True))
    return _t(cand(rng.uniform(0, 90), 20.0) + cand(rng.uniform(0, 90), 44.0)
              + (starts, ends, sizes, n, head, speeds, busy, lat, ibw))


def event_select_identity(args):
    """``event_select`` scores its selected event as ``link_cost`` does
    from the event's node, and ``fleet_feasibility`` agrees from the
    arrival: returns the three pairs of outputs that must be equal."""
    take, t, node, feas, arrive, _, _, load = ops.event_select(*args)
    starts, ends, sizes, n, head, speeds, busy, lat, ibw = args[12:]
    K = starts.shape[0]
    pick = lambda a, b: torch.where(take, a, b)
    d, p, pay = pick(args[2], args[8]), pick(args[3], args[9]), \
        pick(args[4], args[10])
    ps = p / speeds
    row = node.reshape(1).long()
    lc = ops.link_cost(starts, ends, sizes, n, ps, d, busy, head, t,
                       lat.index_select(0, row).reshape(K),
                       ibw.index_select(0, row).reshape(K), pay)
    ff = ops.fleet_feasibility(starts, ends, sizes, n, ps, d,
                               torch.maximum(arrive, busy), head)
    return [(lc[0], feas), (lc[1], arrive), (lc[2], load), (ff[0], feas),
            (ff[1], load)]


@pytest.mark.parametrize("K,N", FLEETS)
def test_event_select_scores_as_link_cost(K, N):
    rng = random.Random(K * 53 + N)
    for _ in range(4):
        for got, want in event_select_identity(_event_select_args(rng, K, N)):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
def _bf16_pair(a: np.ndarray, dtype: str):
    """The same values in both packages: each rounds f32 to bf16 to
    nearest even."""
    return (torch.from_numpy(a).to(TORCH_DTYPE[dtype]),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,d", [(8, 64), (300, 128), (1024, 512), (7, 7168)])
def test_rmsnorm_matches_pallas(R, d, dtype):
    rng = np.random.default_rng(R * 7 + d)
    tx, jx = _bf16_pair(rng.standard_normal((R, d), dtype=np.float32), dtype)
    ts, js = _bf16_pair((rng.standard_normal(d) * 0.1).astype(np.float32),
                        dtype)
    got = ops.rmsnorm(tx, ts)
    want = torch.from_numpy(np.array(jops.rmsnorm(jx, js), np.float32))
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (R, d)
    torch.testing.assert_close(got.float(), want,
                               **ref.rmsnorm_tolerance(got.dtype))


def test_rmsnorm_flattens_leading_axes_and_matches_model_norm():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 4, 256), dtype=np.float32)
    s = (rng.standard_normal(256) * 0.1).astype(np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert got.shape == (32, 4, 256)
    tol = ref.rmsnorm_tolerance(torch.float32)
    want = torch.from_numpy(np.array(jops.rmsnorm(jnp.asarray(x),
                                                    jnp.asarray(s))))
    torch.testing.assert_close(got, want, **tol)
    model = rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    jmodel = torch.from_numpy(np.array(jax_rms_norm(jnp.asarray(x),
                                                      jnp.asarray(s))))
    torch.testing.assert_close(model, jmodel, **tol)
    torch.testing.assert_close(got, model, **tol)


@pytest.mark.parametrize("R,d", [(1, 32), (77, 128), (500, 384)])
def test_rmsnorm_unit_rms(R, d):
    """With a zero scale offset every output row has RMS 1."""
    x = torch.from_numpy(np.random.default_rng(R * 31 + d).standard_normal(
        (R, d), dtype=np.float32))
    got = ops.rmsnorm(x, torch.zeros(d))
    rms = got.square().mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones(R), rtol=1e-5, atol=0)


def test_rmsnorm_tolerance_rejects_a_dropped_column():
    """A row normalised without its last column in the sum fails the f32
    rule at d = 5376, and passes the bf16 one."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 5376), dtype=np.float32))
    s = torch.zeros(5376)
    want = ref.rmsnorm_ref(x, s)
    var = x[:, :-1].square().sum(-1, keepdim=True) / x.shape[1]
    bad = x * torch.rsqrt(var + 1e-6)
    assert not torch.allclose(bad, want,
                              **ref.rmsnorm_tolerance(torch.float32))
    assert torch.allclose(bad, want, **ref.rmsnorm_tolerance(torch.bfloat16))


# ---------------------------------------------------------------------------
# moe_gemm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [(4, 64, 128, 256), (8, 100, 64, 96),
                                     (2, 256, 512, 128)])
def test_moe_gemm_matches_pallas(E, C, d, f, dtype):
    rng = np.random.default_rng(E * 1000 + C + d + f)
    tx, jx = _bf16_pair((rng.standard_normal((E, C, d)) * 0.1
                         ).astype(np.float32), dtype)
    tw, jw = _bf16_pair((rng.standard_normal((E, d, f)) * 0.1
                         ).astype(np.float32), dtype)
    got = ops.moe_gemm(tx, tw)
    want = torch.from_numpy(np.array(jops.moe_gemm(jx, jw), np.float32))
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (E, C, f)
    torch.testing.assert_close(got.float(), want,
                               **ref.moe_gemm_tolerance(tx, tw))


def test_moe_gemm_is_blockwise_independent():
    """Each expert's output depends only on its own inputs."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 32, 64), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 64, 64), dtype=np.float32))
    base = ops.moe_gemm(x, w)
    x2 = x.clone()
    x2[2] = 0.0
    out = ops.moe_gemm(x2, w)
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    for e in (0, 1, 3):
        assert torch.equal(out[e], base[e])


def test_moe_gemm_tolerance_rejects_a_dropped_slice():
    """An output without the last 16 of d = 1536 products fails the rule,
    in f32 and in bf16."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 64, 1536), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 1536, 64), dtype=np.float32))
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), w.to(dt)
        want = ref.moe_gemm_ref(xd, wd).float()
        bad = ref.moe_gemm_ref(xd[..., :-16], wd[:, :-16]).float()
        assert not torch.allclose(bad, want, **ref.moe_gemm_tolerance(xd, wd))


# ---------------------------------------------------------------------------
# dispatch and signatures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fleet_feasibility", "link_cost",
                                  "rmsnorm", "moe_gemm"])
def test_signature_is_the_references(name):
    ours = list(inspect.signature(getattr(ops, name)).parameters)
    theirs = list(inspect.signature(getattr(jops, name)).parameters)
    assert ours == theirs


def test_cpu_runs_plain_versions_and_kernels_refuse_cpu(monkeypatch):
    """CPU tensors reach the plain versions and no launch is counted; each
    kernel wrapper refuses them before anything is built."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "load", no_build)
    wrappers = (admission.fleet_feasibility, admission.link_cost,
                rn.rmsnorm, mg.moe_gemm)
    before = [fn.launches for fn in wrappers]
    starts, ends, sizes, n, head, busy = _t(_random_fleet(
        random.Random(0), 4, 8, True))
    ps, d, t = torch.full((4,), 20.0), torch.tensor(400.0), torch.tensor(3.0)
    lat, ibw = torch.full((4,), 7.0), torch.full((4,), 0.5)
    assert torch.equal(
        ops.fleet_feasibility(starts, ends, sizes, n, ps, d, busy, head)[0],
        ref.fleet_feasibility_ref(starts, ends, sizes, n, ps, d, busy,
                                  head)[0])
    for g, w in zip(ops.link_cost(starts, ends, sizes, n, ps, d, busy, head,
                                  t, lat, ibw, t),
                    ref.link_cost_ref(starts, ends, sizes, n, ps, d, busy,
                                      head, t, lat, ibw, t)):
        assert torch.equal(g, w)
    x, s = torch.randn(3, 16), torch.randn(16)
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    xe, we = torch.randn(2, 3, 4), torch.randn(2, 4, 5)
    assert torch.equal(ops.moe_gemm(xe, we), ref.moe_gemm_ref(xe, we))
    assert [fn.launches for fn in wrappers] == before

    one = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        admission.fleet_feasibility(starts, ends, sizes, n, ps, one, busy,
                                    head)
    with pytest.raises(ValueError, match="CUDA"):
        admission.link_cost(starts, ends, sizes, n, ps, one, busy, head, one,
                            lat, ibw, one)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(x, s)
    with pytest.raises(ValueError, match="CUDA"):
        mg.moe_gemm(xe, we)


# ---------------------------------------------------------------------------
# the kernel variants: chosen by the wrappers from dtype, shape and
# alignment before any launch (no CUDA needed to decide)
# ---------------------------------------------------------------------------
def _shaped(shape, dtype=torch.bfloat16, offset=0):
    """A tensor of ``shape`` over one small allocation (stride 0), its
    data pointer ``offset`` elements into the allocation."""
    return torch.empty(offset + 1, dtype=dtype)[offset:].expand(*shape)


@pytest.mark.parametrize("E,C,d,f", [(40, 1024, 1536, 512),
                                     (40, 1024, 512, 1536),
                                     (40, 1000, 1536, 504), (1, 1, 8, 8)])
def test_moe_gemm_variant_is_tma_where_a_tensor_map_fits(E, C, d, f):
    """Granite-3.0 MoE gate/up and down, ragged C with f = 504, one slice."""
    assert mg.variant(_shaped((E, C, d)), _shaped((E, d, f))) == "tma_wgmma"


@pytest.mark.parametrize("d,f,x_off,w_off", [(1536, 500, 0, 0),
                                             (1539, 512, 0, 0),
                                             (1536, 512, 1, 0),
                                             (1536, 512, 0, 1), (4, 64, 0, 0)])
def test_moe_gemm_variant_is_mma_sync_where_it_does_not(d, f, x_off, w_off):
    """A ragged f (500), an odd d (1539), a view 2 bytes off 16-byte
    alignment, d below one 8-wide row of a tensor map."""
    x = _shaped((40, 1000, d), offset=x_off)
    w = _shaped((40, d, f), offset=w_off)
    assert mg.variant(x, w) == "mma_sync"


def test_moe_gemm_variant_of_f32_is_simt():
    x, w = _shaped((40, 1024, 1536), torch.float32), \
        _shaped((40, 1536, 512), torch.float32)
    assert mg.variant(x, w) == "f32_simt"


@pytest.mark.parametrize("D", [64, 128])
def test_flash_variant_is_tma_at_d64_and_d128(D):
    q, k = _shaped((8, 578, 12, D)), _shaped((8, 578, 4, D))
    assert fa.variant(q, k, k) == "tma_wgmma"


@pytest.mark.parametrize("D", [72, 80])
@pytest.mark.parametrize("B,S,H,KV", [(8, 730, 16, 16), (8, 1024, 16, 16),
                                      (1, 578, 16, 4), (2, 65, 8, 1)])
def test_flash_variant_is_tma_at_d72_and_d80(B, S, H, KV, D):
    """DiT-XL/2's heads (72 wide) and ViT-H/14's (80 wide), aligned, take
    the TMA / wgmma kernel: ViT-H/14 at 384 px (730 tokens), DiT-XL/2 at
    512 px (1,024), ragged S and GQA."""
    q, k = _shaped((B, S, H, D)), _shaped((B, S, KV, D))
    assert fa.variant(q, k, k) == "tma_wgmma"
    assert D in fa.WGMMA_HEAD_DIMS


@pytest.mark.parametrize("B,D,offset,dtype", [(2, 36, 0, torch.bfloat16),
                                              (2, 32, 0, torch.bfloat16),
                                              (2, 64, 1, torch.bfloat16),
                                              (2, 80, 1, torch.bfloat16),
                                              (2, 96, 0, torch.bfloat16),
                                              (16384, 64, 0, torch.bfloat16),
                                              (16384, 80, 0, torch.bfloat16),
                                              (2, 64, 0, torch.float32)])
def test_flash_variant_elsewhere(B, D, offset, dtype):
    """D = 36 (not a multiple of 8), D = 32 (below 64) and D = 96 (no
    wgmma width of it built) stay on mma_sync, as do views 2 bytes off
    alignment (D = 64 and 80) and B * H = 65536 (past the tma_wgmma
    grid); f32 takes the register-tiled kernel."""
    q = _shaped((B, 130, 4, D), dtype, offset)
    k = _shaped((B, 130, 4, D), dtype)
    want = "f32_regtile" if dtype == torch.float32 else "mma_sync"
    assert fa.variant(q, k, k) == want
    assert fa.variant(k, q, k) == want


@pytest.mark.parametrize("B,S,D,offset", [(8, 578, 64, 0), (1, 1, 80, 0),
                                          (2, 65, 128, 0), (2, 63, 7, 0),
                                          (2, 1024, 64, 1), (16384, 130, 64, 0),
                                          (2, 130, 80, 3)])
def test_flash_variant_of_f32_is_regtile_everywhere(B, S, D, offset):
    """Every f32 shape and alignment takes the register-tiled kernel:
    DeiT-B at 384 px, ragged S, D = 80 / 128 / 7, views off 16-byte
    alignment, B * H past the tma_wgmma grid."""
    q = _shaped((B, S, 4, D), torch.float32, offset)
    k = _shaped((B, S, 2, D), torch.float32)
    assert fa.variant(q, k, k) == "f32_regtile"
    assert fa.variant(k, q, k) == "f32_regtile"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_scale_passes_through_in_f32_and_bf16(dtype):
    """The kernel reads an f32 or bf16 scale itself: no cast, no copy."""
    s = torch.randn(96).to(dtype)
    assert rn.kernel_scale(s) is s


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_rmsnorm_scale_of_other_dtypes_is_cast_to_f32(dtype):
    """Other float dtypes take the reference's astype(f32); a strided
    scale is made contiguous."""
    s = torch.randn(192, dtype=torch.float64).to(dtype)[::2]
    got = rn.kernel_scale(s)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, s.to(torch.float32))


@pytest.mark.parametrize("B,split", [(1, True), (2, True), (3, False),
                                     (5, False), (8, False)])
def test_flash_splits_keys_below_two_waves(B, split):
    """DeiT-B at 384 px (S = 578, 12 heads) on 132 SMs: B * 12 * 10
    warpgroup tiles against 264."""
    assert fa.split_keys(B, 578, 12, 132) is split
