"""The port's threefry over arrays (``repro_torch.models.prng``) against
``jax.random``: ``random_bits``, ``uniform`` and ``randint`` bit for bit,
``normal`` within ``prng.NORMAL_ULPS`` f32 units (the worst case found is
printed), on the keys the diffusion losses draw from (``fold_in(fold_in(
PRNGKey(0), step), 1 or 2)``) and others, at DiT-XL/2's shapes ((256,)
for ``t`` at ``train_256``'s batch, (256, 32, 32, 4) for ``eps``) and
small ones.  JAX here runs as the reference does
(``jax_threefry_partitionable`` on, jitted draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.fleetsim import rng
from repro_torch.models import prng

STEPS = (0, 1, 999, 2 ** 31 - 1)
SHAPES = ((256,), (3, 5), (2, 1, 7), (1,))
DIT_EPS = (256, 32, 32, 4)


def keys(step, data):
    return (rng.fold_in(rng.fold_in(rng.prng_key(0), step), data),
            jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                  step), data))


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in f32 units (the two's-complement distance of the bit
    patterns, signs ordered)."""
    ia, ib = (np.where(x.view(np.int32) < 0,
                       -(x.view(np.int32).astype(np.int64) & 0x7FFFFFFF),
                       x.view(np.int32).astype(np.int64)) for x in (a, b))
    return np.abs(ia - ib)


@jax.jit
def _draws(key):
    """The reference's draws of the diffusion losses at DiT's shapes."""
    return (jax.random.bits(key, DIT_EPS, jnp.uint32),
            jax.random.uniform(key, DIT_EPS, jnp.float32, -3.0, 5.5),
            jax.random.randint(key, (256,), 0, 1000),
            jax.random.normal(key, DIT_EPS, jnp.float32))


@pytest.mark.parametrize("step", [7])
def test_draws_at_dit_shapes(step):
    key, jkey = keys(step, 2)
    jb, ju, jr, jn = (np.asarray(a) for a in _draws(jkey))
    assert np.array_equal(prng.random_bits(key, DIT_EPS, "cpu").numpy(),
                          jb.astype(np.int64))
    assert np.array_equal(prng.uniform(key, DIT_EPS, -3.0, 5.5, "cpu")
                          .numpy(), ju)
    assert np.array_equal(prng.randint(key, (256,), 0, 1000, "cpu").numpy(),
                          jr.astype(np.int64))
    n = prng.normal(key, DIT_EPS, "cpu")
    assert n.dtype == torch.float32 and n.shape == DIT_EPS
    worst = int(ulps(n.numpy(), jn).max())
    print(f"normal (256, 32, 32, 4) at step {step}: worst {worst} f32 units "
          f"from jax.random.normal")
    assert worst <= prng.NORMAL_ULPS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("step", STEPS)
def test_small_draws_bit_for_bit(step, shape):
    for data in (1, 2):
        key, jkey = keys(step, data)
        assert np.array_equal(
            prng.random_bits(key, shape, "cpu").numpy(),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
            .astype(np.int64))
        assert np.array_equal(
            prng.uniform(key, shape, device="cpu").numpy(),
            np.asarray(jax.random.uniform(jkey, shape)))
        assert np.array_equal(
            prng.randint(key, shape, 0, 1000, "cpu").numpy(),
            np.asarray(jax.random.randint(jkey, shape, 0, 1000)))
        assert ulps(prng.normal(key, shape, "cpu").numpy(),
                    np.asarray(jax.random.normal(jkey, shape))).max() \
            <= prng.NORMAL_ULPS


@pytest.mark.parametrize("lo,hi", [(0, 1), (-5, 3), (0, 2 ** 16 + 3),
                                   (-2 ** 31, 2 ** 31 - 1), (7, 7), (9, 2)])
def test_randint_spans(lo, hi):
    """Spans of one, past 2**16, the whole int32 range and empty ones
    (``maxval <= minval`` gives ``minval``)."""
    key, jkey = keys(5, 1)
    got = prng.randint(key, (64,), lo, hi, "cpu").numpy()
    want = np.asarray(jax.random.randint(jkey, (64,), lo, hi))
    assert np.array_equal(got, want.astype(np.int64))


def test_normal_tails_and_erf_inv():
    """``erf_inv`` against ``jax.lax.erf_inv`` jitted, on both of its
    polynomials (w = -log1p(-x^2) below and above 5) and both of its
    ``log1p`` branches, out to the uniform's ends; and the ends
    themselves (+-1 -> +-inf)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.concatenate([
        np.linspace(lo, 1.0, 200_001, endpoint=False, dtype=np.float32),
        1 - np.logspace(-7, -1, 5_000).astype(np.float32),
        np.float32([0.0, -0.0, 0.5, lo, -1.0, 1.0])]).astype(np.float32)
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    assert ulps(got[fin], want[fin]).max() <= prng.NORMAL_ULPS


def test_draws_follow_the_device_argument():
    key, _ = keys(3, 2)
    assert prng.normal(key, (4,), "cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prng.normal(key, (4,))
