"""The port's threefry (``repro_torch.fleetsim.rng``) against ``jax.random``,
bit for bit, on the keys the fleet simulator's stochastic policies draw
from: ``fold_in(fold_in(PRNGKey(seed), rid), hop)``, its ``split`` and the
``uniform``s of each, over 1,200 (seed, rid, hop) triples with seeds 0, 1
and 2**31 - 1 and rids and hops up to 2**31 - 1.  JAX here runs as the
reference does (``jax_threefry_partitionable`` on)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.fleetsim import rng

N_TRIPLES = 1200


def _triples():
    g = np.random.default_rng(0)
    seeds = np.concatenate([[0, 1, 2 ** 31 - 1],
                            g.integers(0, 2 ** 31, N_TRIPLES - 3)])
    near = lambda n: 2 ** 31 - 1 - g.integers(0, 64, n)
    rids = np.where(g.random(N_TRIPLES) < 0.3, near(N_TRIPLES),
                    g.integers(0, 20_000, N_TRIPLES))
    hops = np.where(g.random(N_TRIPLES) < 0.2, near(N_TRIPLES),
                    g.integers(0, 3, N_TRIPLES))
    return [np.asarray(a, np.int32) for a in (seeds, rids, hops)]


@jax.jit
@jax.vmap
def _reference(seed, rid, hop):
    key = jax.random.PRNGKey(seed)
    kh = jax.random.fold_in(jax.random.fold_in(key, rid), hop)
    k1, k2 = jax.random.split(kh)
    data = lambda k: jax.random.key_data(k)
    return (data(key), data(kh), data(k1), data(k2),
            jax.random.bits(kh), jax.random.uniform(kh),
            jax.random.uniform(k1), jax.random.uniform(k2))


def test_partitionable_mode_is_what_the_reference_runs():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def test_threefry_matches_jax_random_bit_for_bit():
    seeds, rids, hops = _triples()
    ref = [np.asarray(a) for a in _reference(jnp.asarray(seeds),
                                             jnp.asarray(rids),
                                             jnp.asarray(hops))]
    as_key = lambda row: (int(row[0]), int(row[1]))
    for i, (seed, rid, hop) in enumerate(zip(seeds.tolist(), rids.tolist(),
                                             hops.tolist())):
        key = rng.prng_key(seed)
        kh = rng.fold_in(rng.fold_in(key, rid), hop)
        k1, k2 = rng.split(kh)
        assert key == as_key(ref[0][i]) and kh == as_key(ref[1][i]), i
        assert (k1, k2) == (as_key(ref[2][i]), as_key(ref[3][i])), i
        assert rng.random_bits(kh) == int(ref[4][i]), i
        for k, j in ((kh, 5), (k1, 6), (k2, 7)):
            assert rng.uniform(k).tobytes() == ref[j][i].tobytes(), (i, j)


@pytest.mark.parametrize("lo,hi", [(2.0, 5.0), (-1.0, 3.3)])
def test_scaled_uniform_matches_jax_random(lo, hi):
    """The scale to [minval, maxval) is one fused multiply-add, as XLA's
    CPU compiler contracts it."""
    keys = [rng.fold_in(rng.prng_key(s), d) for s in range(20)
            for d in range(20)]
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, minval=lo, maxval=hi))(jnp.asarray(keys, jnp.uint32)))
    got = np.array([rng.uniform(k, lo, hi) for k in keys], np.float32)
    assert got.tobytes() == want.tobytes()


def test_scaled_index_is_the_reference_pick():
    """``min(int32(u * n), max(n - 1, 0))`` in f32, as ``_route_next``
    computes it, for every neighbour count of a 256-node fleet."""
    keys = [rng.fold_in(rng.prng_key(7), d) for d in range(64)]
    us = np.array([rng.uniform(k) for k in keys], np.float32)
    # the largest u below 1 must not pick past the last neighbour
    us = np.append(us, np.nextafter(np.float32(1), np.float32(0)))
    ns = np.arange(0, 257, dtype=np.int32)
    u2, n2 = (a.ravel() for a in np.meshgrid(us, ns))
    want = np.asarray(jnp.minimum((jnp.asarray(u2) * jnp.asarray(n2)
                                   ).astype(jnp.int32),
                                  jnp.maximum(jnp.asarray(n2) - 1, 0)))
    got = [rng.scaled_index(u, int(n)) for u, n in zip(u2, n2)]
    assert got == want.tolist()
