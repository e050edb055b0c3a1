"""JAX's threefry draws over arrays, bit for bit: the noise of the
diffusion models' train losses (``repro/models/dit.py`` and ``unet.py``
``loss_fn``: ``t = randint(fold_in(rng, 1), (B,), 0, 1000)`` and ``eps =
normal(fold_in(rng, 2), latents.shape)``, ``rng = fold_in(PRNGKey(0),
step)``).

Keys stay scalar ``(hi, lo)`` pairs of Python ints, derived on the host
by ``fleetsim.rng``'s ``prng_key`` / ``fold_in`` / ``split``; only the
draws are tensors, on an explicit device (the CPU or the card alike).
The uint32 words are held in int64 tensors and masked to 32 bits, as the
scalar form masks Python ints.  The layout is JAX 0.9's partitionable one
(``jax_threefry_partitionable``, the default since JAX 0.5): element ``i``
of a draw of any shape is ``bits1 ^ bits2`` of ``threefry2x32(key, (hi,
lo))`` at the 64-bit counter ``i`` (``iota_2x32_shape``), in row-major
order.

* :func:`split` is ``jax.random.split(key, num)``: key ``i`` is
  ``threefry2x32(key, (0, i))``, the partitionable layout over a
  ``(num,)`` counter (``fleetsim.rng.split`` is its ``num = 2``);
* :func:`random_bits`, :func:`uniform` and :func:`randint` equal
  ``jax.random.bits`` / ``uniform`` / ``randint`` bit for bit;
* :func:`normal` is ``sqrt(2) * erf_inv(u)``, ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` (``jax._src.random._normal_real``), with
  ``erf_inv`` the f32 polynomial XLA's CPU compiler emits for it, its
  ``log1p`` (a Cephes rational below 0.4142, else ``log(1 + x)`` by
  Cephes' ``logf``) included, operation for operation and with the
  fused multiply-adds where that compiler contracts them
  (``kernels.ref.fma32``).  Within ``NORMAL_ULPS`` f32 units of
  ``jax.random.normal`` (``tests/test_torch_prng.py``).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleetsim.rng import Key, threefry2x32
from repro_torch.kernels.ref import fma32

_MASK = 0xFFFFFFFF
# normal against jax.random.normal, in f32 units of the larger value
NORMAL_ULPS = 0


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` as ``num`` host keys."""
    if not 0 <= num < 2 ** 32:
        raise ValueError(f"split into {num} keys")
    return [threefry2x32(key, 0, i) for i in range(num)]


def random_bits(key: Key, shape: Sequence[int], device: DeviceLike = None
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of the
    words (0 .. 2**32 - 1) on ``device`` (``None``: CUDA): the scalar
    ``threefry2x32``'s masked arithmetic, run on tensors of counters."""
    dev = resolve_device(device)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    b1, b2 = threefry2x32(key, idx >> 32, idx & _MASK)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits of each word under the exponent of 1.0, minus 1.0, scaled by
    one fused multiply-add and clamped to ``minval`` (as
    ``fleetsim.rng.uniform``)."""
    bits = random_bits(key, shape, device)
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    full = lambda v: torch.full_like(one, float(v))  # noqa: E731
    scaled = fma32(one - 1.0, full(hi - lo), full(lo))
    return torch.clamp_min(scaled, float(lo))


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 values,
    as an int64 tensor): two words an element from the keys of
    ``split(key)``, reduced as ``((hi % span) * m + lo % span) % span``
    with ``m = (2**16 % span)**2 % span``, in uint32 arithmetic."""
    if not all(-2 ** 31 <= v < 2 ** 31 for v in (minval, maxval)):
        raise ValueError(f"randint bounds [{minval}, {maxval}) are not "
                         f"int32")
    if maxval <= minval:
        span = 1
    else:
        span = (maxval - minval) & _MASK
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    # minval + offset in int32, wrapping as the reference's does
    return ((minval + off % span + 2 ** 31) & _MASK) - 2 ** 31


# -- XLA's f32 erf_inv, as its CPU compiler emits it ------------------------
# Giles' single-precision polynomials in w = -log1p(-x^2), the first
# coefficient the highest power: (w < 5, on w - 2.5), (w >= 5, on
# sqrt(w) - 3)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# log1p for |x| < sqrt(2) - 1: x - x^2 / 2 + x^3 P(x) / Q(x) (Cephes)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Cephes logf on the mantissa in [sqrt(1/2), sqrt(2)) - 1
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
           -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
           2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375


def _c(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(x, float(np.float32(v)))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``((c0 x + c1) x + c2) ...``, each step one fused multiply-add."""
    p = _c(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma32(p, x, _c(x, c))
    return p


def _logf(v: torch.Tensor) -> torch.Tensor:
    """Natural log of positive f32 ``v`` as XLA's CPU compiler computes
    it: Cephes' ``logf`` (denormals cut to the least normal)."""
    zero = v == 0
    v = torch.clamp_min(v, float(np.uint32(0x00800000).view(np.float32)))
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < float(np.float32(0.707106781186547524))
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    y = fma32(x, _c(x, _LOGF_P[0]), _c(x, _LOGF_P[1]))
    y1 = fma32(x, _c(x, _LOGF_P[3]), _c(x, _LOGF_P[4]))
    y2 = fma32(x, _c(x, _LOGF_P[6]), _c(x, _LOGF_P[7]))
    y = fma32(y, x, _c(x, _LOGF_P[2]))
    y1 = fma32(y1, x, _c(x, _LOGF_P[5]))
    y2 = fma32(y2, x, _c(x, _LOGF_P[8]))
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, e * float(np.float32(_LOGF_Q1)))
    x = (x - 0.5 * x2) + y
    out = x + e * float(np.float32(_LOGF_Q2))
    return torch.where(zero, torch.full_like(v, -math.inf), out)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``log-plus-one`` in f32 (``EmitLog1p``)."""
    x2 = x * x
    small = x * x2 * (_horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q))
    small = x + fma32(_c(x, -0.5), x2, small)
    large = _logf(x + 1.0)
    return torch.where(x.abs() < float(np.float32(math.sqrt(2) - 1)),
                       small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` on f32 ``x`` in [-1, 1], as jitted on the
    CPU."""
    w = -_log1p(x * -x)
    lt5 = w < 5.0
    # the square root correctly rounded (f64, then f32: exact for a square
    # root), as XLA's is; PyTorch's f32 one on the CPU is not always
    z = torch.where(lt5, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt5, _c(x, _ERFINV_SMALL[0]), _c(x, _ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = fma32(p, z, torch.where(lt5, _c(x, cs), _c(x, cl)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: Key, shape: Sequence[int], device: DeviceLike = None
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (within
    ``NORMAL_ULPS``)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return erf_inv(u) * float(np.float32(math.sqrt(2)))
