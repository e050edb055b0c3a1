"""The port's event_select plain version and dispatch against the JAX
package: ``repro_torch.kernels.ref.event_select_ref`` (torch, CPU) vs
``repro.kernels.ops.event_select`` (the Pallas kernel, interpret mode)
and vs ``repro.kernels.ref.event_select_ref`` under ``jax.jit`` — the
way the reference simulator runs it.

Bar: bit for bit on take_fresh, t, node, feasible, arrive, j and cap;
``load`` bit for bit where the ledger sizes are dyadic (integer service
times, speeds in {0.5, 1, 2}) and within a relative 1e-6 elsewhere (the
sum's order differs between XLA and torch).

Arithmetic note: XLA's CPU compiler contracts ``x + a * b`` into a fused
multiply-add inside jitted code (eager JAX does not), so the reference
simulator's wire-delayed arrival is ``fma(payload, inv_bw, t + lat)``;
the port computes it with one rounding too (``fma32``), which the CUDA
kernel gets from ``__fmaf_rn``.

The kernel itself runs only on the card: tests/test_torch_gpu.py holds it
against the plain version there.
"""
import fractions
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_queue as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import event_select as es

NAMES = ("take_fresh", "t", "node", "feasible", "arrive", "j", "cap", "load")
LOAD_RTOL = 1e-6
jref_jit = jax.jit(jref.event_select_ref)


def _random_fleet(rng, K, N):
    """tests/test_fleetsim.py's fleet: K ledgers grown by jq.push."""
    leds, frees = [], []
    for _ in range(K):
        led = jq.empty_ledger(N)
        free = rng.uniform(0, 50)
        for _ in range(rng.randrange(0, N + 2)):
            led, _ = jq.push(led, jnp.float32(rng.choice([5.0, 20.0, 44.0])),
                             jnp.float32(rng.uniform(10, 9000)),
                             jnp.float32(free))
        leds.append(led)
        frees.append(free)
    stacked = [np.stack([np.asarray(getattr(l, f)) for l in leds])
               for f in ("starts", "ends", "sizes", "n")]
    return stacked, np.asarray(frees, np.float32)


def _cases(rng, K, N, head=None, sizes_scale=1.0):
    """The six merge cases of tests/test_netsim.py over one random fleet,
    as numpy argument tuples (scalars as 0-d arrays)."""
    (starts, ends, sizes, n), busy = _random_fleet(rng, K, N)
    if head is not None:                 # retire a prefix: head-pointer rows
        h = np.minimum(head, n)
        for k in range(K):
            starts[k] = np.concatenate([np.full(h[k], -jq.BIG), starts[k, :N - h[k]]])
            ends[k] = np.concatenate([np.full(h[k], -jq.BIG), ends[k, :N - h[k]]])
            sizes[k] = np.concatenate([np.zeros(h[k]), sizes[k, :N - h[k]]])
        n = n - h
        head = h.astype(np.int32)
    sizes = (sizes * np.float32(sizes_scale)).astype(np.float32)
    speeds = np.asarray([rng.choice([0.5, 1.0, 2.0]) for _ in range(K)], np.float32)
    lat = np.asarray([[0.0 if i == j else rng.uniform(0.0, 120.0)
                       for j in range(K)] for i in range(K)], np.float32)
    ibw = np.asarray([[0.0 if i == j else rng.choice([0.0, 0.1, 0.8, 1.0])
                       for j in range(K)] for i in range(K)], np.float32)
    f = np.float32
    for t_a, av_a, t_b, av_b in [
            (10.0, True, 40.0, True), (25.0, True, 25.0, True),
            (90.0, True, 12.0, True), (10.0, True, 5.0, False),
            (3.0, False, 55.0, True), (1.0, False, 2.0, False)]:
        yield (f(t_a), np.int32(rng.randrange(K)), f(rng.uniform(50, 9000)),
               f(20.0), f(rng.choice([0.92, 24.88])), np.bool_(av_a),
               f(t_b), np.int32(rng.randrange(K)), f(rng.uniform(50, 9000)),
               f(44.0), f(rng.choice([0.92, 24.88])), np.bool_(av_b),
               starts, ends, sizes, n.astype(np.int32), head, speeds, busy,
               lat, ibw)


def _torch_args(args):
    return tuple(None if a is None else torch.from_numpy(np.asarray(a))
                 for a in args)


def _jax_args(args):
    return tuple(None if a is None else jnp.asarray(a) for a in args)


def _assert_match(got, want, exact_load=True):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "load" and not exact_load:
            np.testing.assert_allclose(g, w, rtol=LOAD_RTOL, atol=0)
        else:
            assert np.array_equal(g, w), (name, g, w)


@pytest.mark.parametrize("K,N", [(1, 8), (5, 16), (12, 32)])
def test_event_select_ref_matches_pallas_kernel(K, N):
    rng = random.Random(K * 17 + N)
    for args in _cases(rng, K, N):
        got = ops.event_select(*_torch_args(args))
        _assert_match(got, jops.event_select(*_jax_args(args)))
        if bool(args[5]) and bool(args[11]) and args[0] == args[6]:
            assert bool(got[0])                       # fresh wins ties


@pytest.mark.parametrize("K,N", [(1, 8), (5, 16), (12, 32)])
def test_event_select_ref_matches_jax_ref(K, N):
    rng = random.Random(K * 29 + N)
    for args in _cases(rng, K, N):
        _assert_match(ref.event_select_ref(*_torch_args(args)),
                      jref_jit(*_jax_args(args)))


@pytest.mark.parametrize("K,N", [(5, 16), (12, 32)])
def test_event_select_head_pointer_rows(K, N):
    rng = random.Random(K * 41 + N)
    head = np.asarray([rng.randrange(0, 4) for _ in range(K)])
    for args in _cases(rng, K, N, head=head):
        _assert_match(ops.event_select(*_torch_args(args)),
                      jops.event_select(*_jax_args(args)))


def test_event_select_non_dyadic_sizes():
    """Sizes of 1/3 UT multiples: every output exact but the sum ``load``,
    which holds to a relative 1e-6."""
    rng = random.Random(5)
    for args in _cases(rng, 6, 16, sizes_scale=1.0 / 3.0):
        _assert_match(ops.event_select(*_torch_args(args)),
                      jops.event_select(*_jax_args(args)), exact_load=False)


@pytest.mark.parametrize("K,N", [(1, 8), (6, 16)])
def test_fleet_search_ref_matches_jax(K, N):
    rng = random.Random(K * 7 + N)
    (starts, ends, sizes, n), busy = _random_fleet(rng, K, N)
    ps = np.asarray([rng.choice([5.0, 20.0, 44.0, 180.0]) for _ in range(K)],
                    np.float32)
    for d in (30.0, 400.0, 8000.0):
        args = (starts, ends, sizes, n, ps, np.float32(d), busy)
        want = jax.jit(jref.fleet_search_ref)(*_jax_args(args))
        got = ref.fleet_search_ref(*_torch_args(args))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def _round_f32(x: fractions.Fraction) -> np.float32:
    """Round an exact rational to the nearest f32, ties to even."""
    c = np.float32(float(x))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        err = abs(fractions.Fraction(float(cand)) - x)
        even = (cand.view(np.uint32) & 1) == 0
        key = (err, not even)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_fma32_is_correctly_rounded_and_matches_xla():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 30, 400).astype(np.float32)
    b = rng.choice([0.1, 0.8, 1.0 / 3.0, 2.5e-8], 400).astype(np.float32)
    c = (rng.uniform(0, 2e5, 400) * rng.choice([1.0, 1e-6], 400)).astype(np.float32)
    got = ref.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.asarray([_round_f32(fractions.Fraction(float(x)) * fractions.Fraction(float(y))
                                  + fractions.Fraction(float(z)))
                       for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    xla = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    assert np.array_equal(got, xla)


def test_dispatch_cpu_runs_plain_version_and_kernel_refuses_cpu():
    rng = random.Random(3)
    args = _torch_args(next(_cases(rng, 4, 8)))
    before = es.event_select.launches
    got = ops.event_select(*args)
    want = ref.event_select_ref(*args)
    assert es.event_select.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fs = torch.zeros(8)
    is_ = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        es.event_select(fs, is_, *args[12:15], args[15], args[15], *args[17:])


def test_candidate_buffers_follow_the_kernel_layout():
    """csrc/event_select.cu reads fs = (t, d, p, payload) of a then b and
    is = (node_a, avail_a, node_b, avail_b)."""
    f = lambda x: torch.tensor([x], dtype=torch.float32)
    i = lambda x: torch.tensor([x], dtype=torch.int32)
    b = lambda x: torch.tensor([x])
    fs, is_ = ops.candidate_buffers(f(1.0), i(7), f(2.0), f(3.0), f(4.0),
                                    b(True), f(5.0), i(9), f(6.0), f(7.0),
                                    f(8.0), b(False))
    assert fs.dtype == torch.float32 and fs.tolist() == [1, 2, 3, 4, 5, 6, 7, 8]
    assert is_.dtype == torch.int32 and is_.tolist() == [7, 1, 9, 0]


def test_build_dir_follows_env_checkout_then_home(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = Path(__file__).resolve().parents[1]
    assert build.build_dir() == root / "build" / "kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert build.build_dir() == tmp_path / "b"
    # an installed package: no checkout around the module
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    monkeypatch.setattr(build, "_CHECKOUT", tmp_path / "site")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.build_dir() == (tmp_path / "home" / ".cache" / "repro_torch"
                                 / "kernels")


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build("event_select")
    assert list(tmp_path.iterdir()) == []


def test_library_name_hashes_the_headers_a_source_includes(monkeypatch,
                                                           tmp_path):
    """An edit of csrc/hopper.cuh renames the libraries of the sources that
    include it, so no stale build loads; a source without it keeps its
    name.  Needs no nvcc: only the names are computed."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    names = ("moe_gemm", "flash_attention", "rmsnorm")
    before = {n: build._library(n) for n in names}
    assert build._sources("moe_gemm") == [csrc / "moe_gemm.cu",
                                          csrc / "hopper.cuh"]
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: build._library(n) for n in names}
    assert after["moe_gemm"] != before["moe_gemm"]
    assert after["flash_attention"] != before["flash_attention"]
    assert after["rmsnorm"] == before["rmsnorm"]


def test_launch_errors_name_a_failed_tensor_map_encode():
    build.raise_on("k", 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        build.raise_on("k", 700)
    with pytest.raises(RuntimeError, match="tensor-map encode failed "
                                           r"\(CUresult 1\)"):
        build.raise_on("k", build.ENCODE_ERROR + 1)
