"""The torch admission ledger and event buffer (repro_torch.core.torch_queue)
against the JAX reference (repro.core.jax_queue), bit for bit.

Inputs are made from a seed with numpy and handed to both packages; the
cases replay those of tests/test_jax_queue.py: push streams (the host
queue property's shape, times on a half grid), forced admissions with
per-slot metadata, the closed-form insert on head-pointer rows, the
heapq property of the sorted event buffer with equal keys, overflow and
no-op gating, and the capacity limit.
"""
import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_queue as jq
from repro.kernels import ref as jref
from repro_torch.core import torch_queue as tq

F32 = np.float32


def t32(x):
    return torch.tensor(x, dtype=torch.float32)


def same(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def assert_ledgers_equal(lj, lt):
    for name, a, b in zip(("starts", "ends", "sizes", "n"), lj, lt):
        assert same(a, b), name


def push_stream(rng, length):
    """(p, D, dt) triples as test_jax_queue's strategy draws them."""
    return [(float(rng.choice([5.0, 20.0, 44.0, 180.0])),
             float(rng.choice([50.0, 400.0, 4000.0, 9000.0])),
             int(rng.integers(0, 601)) / 2.0) for _ in range(length)]


@pytest.mark.parametrize("seed", range(6))
def test_push_stream_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lj, lt = jq.empty_ledger(64), tq.empty_ledger(64, device="cpu")
    t = cpu_free = 0.0
    for p, D, dt in push_stream(rng, 40):
        t += dt
        cpu_free = max(cpu_free, t) + (p if rng.random() < 0.3 else 0.0)
        lj, ok_j = jq.push(lj, F32(p), F32(t + D), F32(cpu_free))
        lt, ok_t = tq.push(lt, t32(p), t32(t + D), t32(cpu_free))
        assert bool(ok_j) == bool(ok_t)
        assert_ledgers_equal(lj, lt)


@pytest.mark.parametrize("seed", range(4))
def test_search_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    lj, lt = jq.empty_ledger(32), tq.empty_ledger(32, device="cpu")
    for p, D, dt in push_stream(rng, 20):
        lj, _ = jq.push(lj, F32(p), F32(D + dt), F32(0.0))
        lt, _ = tq.push(lt, t32(p), t32(D + dt), t32(0.0))
    for _ in range(30):
        p = float(rng.choice([5.0, 20.0, 44.0, 180.0]))
        d = float(rng.integers(0, 20000)) / 2
        free = float(rng.integers(0, 400)) / 2
        got = tq._search(lt, t32(p), t32(d), t32(free))
        want = jq._search(lj, F32(p), F32(d), F32(free))
        for g, w in zip(got, want):
            assert same(w, g)


@pytest.mark.parametrize("seed", range(4))
def test_admit_forced_with_meta_matches_jax(seed):
    """Forced tail appends (the host's forced push) and a metadata column
    riding the insertion shift, on a ledger small enough to fill up."""
    rng = np.random.default_rng(200 + seed)
    N = 12
    lj, lt = jq.empty_ledger(N), tq.empty_ledger(N, device="cpu")
    mj = jnp.zeros((N,), jnp.int32)
    mt = torch.zeros((N,), dtype=torch.int32)
    for i, (p, D, dt) in enumerate(push_stream(rng, 16)):
        forced = bool(rng.random() < 0.5)
        d = min(D, 600.0) + dt
        lj, aj, fj, (mj,) = jq.admit(lj, F32(p), F32(d), F32(dt), forced,
                                     meta=(mj,), meta_vals=(jnp.int32(i),))
        lt, at, ft, (mt,) = tq.admit(lt, t32(p), t32(d), t32(dt), forced,
                                     meta=(mt,),
                                     meta_vals=(torch.tensor(i, dtype=torch.int32),))
        assert (bool(aj), bool(fj)) == (bool(at), bool(ft))
        assert_ledgers_equal(lj, lt)
        assert same(mj, mt)


@pytest.mark.parametrize("head", [0, 1, 3])
def test_insert_at_head_pointer_rows_matches_jax(head):
    """insert_at on a fleet row with a retired prefix, at the (j, cap) the
    fleet search computes, for feasible inserts and forced appends."""
    rng = np.random.default_rng(300 + head)
    N = 16
    starts = np.full(N, jq.BIG, F32)
    ends = np.full(N, jq.BIG, F32)
    sizes = np.zeros(N, F32)
    starts[:head] = ends[:head] = -jq.BIG
    t, n = 0.0, 6
    for i in range(head, head + n):
        gap = 0.0 if rng.random() < 0.5 else float(rng.integers(1, 40)) / 2
        size = float(rng.choice([20.0, 44.0]))
        starts[i], ends[i], sizes[i] = t + gap, t + gap + size, size
        t = float(ends[i])
    rids = np.arange(N, dtype=np.int32)
    for d in (30.0, 75.0, 150.0, 400.0):
        for forced in (False, True):
            args = (starts[None], ends[None], sizes[None],
                    np.asarray([n], np.int32), np.asarray([20.0], F32),
                    F32(d), np.asarray([5.0], F32), np.asarray([head], np.int32))
            ok, j, cap, _ = (np.asarray(x) for x in jref.fleet_search_ref(*args))
            feas = bool(ok[0]) and not forced
            want = jq.insert_at(starts, ends, sizes, jnp.int32(head),
                                jnp.int32(n), feas, forced, j[0], cap[0],
                                F32(20.0), F32(5.0), meta=(rids,),
                                meta_vals=(jnp.int32(99),))
            got = tq.insert_at(
                *(torch.from_numpy(a) for a in (starts, ends, sizes)),
                torch.tensor(head, dtype=torch.int32),
                torch.tensor(n, dtype=torch.int32), torch.tensor(feas),
                torch.tensor(forced), torch.tensor(j[0]),
                torch.tensor(cap[0]), t32(20.0), t32(5.0),
                meta=(torch.from_numpy(rids),),
                meta_vals=(torch.tensor(99, dtype=torch.int32),))
            for w, g in zip(want[:3], got[:3]):
                assert same(w, g), (d, forced)
            assert bool(want[3]) == bool(got[3])
            assert same(want[4][0], got[4][0])


@pytest.mark.parametrize("seed", range(6))
def test_event_queue_matches_heapq_and_jax(seed):
    """The buffer replays heapq's (time, seq) order — equal keys in push
    order — and agrees with the JAX buffer slot for slot."""
    rng = np.random.default_rng(400 + seed)
    B = 32
    kj, vj, nj = jnp.full((B,), jq.BIG, jnp.float32), (jnp.zeros((B,), jnp.int32),), jnp.int32(0)
    kt = torch.full((B,), tq.BIG, dtype=torch.float32)
    vt, nt = (torch.zeros((B,), dtype=torch.int32),), torch.zeros((), dtype=torch.int32)
    heap, seq = [], 0
    for _ in range(30):
        if rng.random() < 0.6:
            t = int(rng.integers(0, 41)) / 2.0          # many equal keys
            heapq.heappush(heap, (t, seq))
            kj, vj, nj, dj = jq.event_push(kj, vj, nj, F32(t), (seq,), True)
            kt, vt, nt, dt = tq.event_push(
                kt, vt, nt, t32(t), (torch.tensor(seq, dtype=torch.int32),),
                torch.tensor(True))
            assert not bool(dj) and not bool(dt)
            seq += 1
        elif heap:
            assert (float(kt[0]), int(vt[0][0])) == heapq.heappop(heap)
            kj, vj, nj = jq.event_pop(kj, vj, nj, True)
            kt, vt, nt = tq.event_pop(kt, vt, nt, torch.tensor(True))
        assert same(kj, kt) and same(vj[0], vt[0]) and same(nj, nt)
    while heap:
        assert (float(kt[0]), int(vt[0][0])) == heapq.heappop(heap)
        kt, vt, nt = tq.event_pop(kt, vt, nt, torch.tensor(True))
    assert int(nt) == 0


def test_event_queue_overflow_and_noop_gating():
    keys = torch.full((4,), tq.BIG, dtype=torch.float32)
    vals = (torch.zeros((4,), dtype=torch.int32),)
    n = torch.zeros((), dtype=torch.int32)
    yes, no = torch.tensor(True), torch.tensor(False)
    for i, t in enumerate([3.0, 1.0, 2.0, 1.0]):
        keys, vals, n, dropped = tq.event_push(
            keys, vals, n, t32(t), (torch.tensor(i, dtype=torch.int32),), yes)
        assert not bool(dropped)
    nine = (torch.tensor(9, dtype=torch.int32),)
    keys2, _, n2, dropped = tq.event_push(keys, vals, n, t32(0.5), nine, yes)
    assert bool(dropped) and int(n2) == 4 and torch.equal(keys2, keys)
    _, _, _, dropped = tq.event_push(keys, vals, n, t32(0.5), nine, no)
    assert not bool(dropped)
    assert keys.tolist() == [1.0, 1.0, 2.0, 3.0]
    assert vals[0].tolist() == [1, 3, 2, 0]
    k3, _, n3 = tq.event_pop(keys, vals, n, no)
    assert torch.equal(k3, keys) and int(n3) == 4


def test_capacity_limit():
    led = tq.empty_ledger(2, device="cpu")
    for _ in range(2):
        led, ok = tq.push(led, t32(1.0), t32(9000.0), t32(0.0))
        assert bool(ok)
    led, ok = tq.push(led, t32(1.0), t32(9000.0), t32(0.0))
    assert not bool(ok) and int(led.n) == 2
