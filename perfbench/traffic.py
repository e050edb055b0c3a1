"""The general generator of the serving mixes (``traffic/*.json``), frozen
apart from the program.

The surveillance classes are copies of the port's ``launch/serve.py``
(``_surveillance_class``, ``SURVEILLANCE``): each class has a deadline
and a per-frame time in engine units, and the engine's time for a batch
of ``b`` frames is ``proc_time * (1 + slope * (b - 1))`` at the listed
batch sizes.  A mix gives the classes, their shares, the mean
inter-arrival and the replicas.  The stream is Poisson as the port's
``frame_stream`` draws it, but every episode holds the same set of gaps
and the same count of each class.  Their order decides the engine's
batches, and so the work, so episode ``k`` orders them, and seeds the
engine's forwarding, from the mix's own ``stream_seed`` and ``k``: every
run serves the same streams.  The run's seed draws which of the class's
frames each request shows (and, in the drivers, the weights and frames).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

SEED_MOD = 2 ** 64


def batch_times(cls: dict, model: dict) -> Dict[int, float]:
    """Engine time of a batch of each listed size."""
    return {int(b): cls["proc_time"] * (1 + model["slope"] * (int(b) - 1))
            for b in model["sizes"]}


def quantile_gaps(n: int, mean: float) -> np.ndarray:
    """``n`` inter-arrival gaps at the midpoints of the exponential
    distribution's ``n`` quantile bins, scaled to ``mean``: the sizes of a
    Poisson stream, the same set for every seed."""
    g = -np.log1p(-(np.arange(n) + 0.5) / n)
    return g * (mean / g.mean())


def class_counts(weights: Sequence[float], n: int) -> np.ndarray:
    """How many of ``n`` frames each class has: its share of ``n``, the
    frames left over by rounding down to the largest remainders."""
    p = np.asarray(weights, np.float64)
    share = p / p.sum() * n
    counts = np.floor(share).astype(np.int64)
    left = n - counts.sum()
    counts[np.argsort(-(share - counts), kind="stable")[:left]] += 1
    return counts


def episode(mix: dict, seed: int, k: int) -> dict:
    """Episode ``k`` of the mix: arrival times, class of each frame, its
    origin replica (``i % replicas``) and the engine's forwarding seed,
    from ``(stream_seed, k)``; the image index of each frame from
    ``(seed, k)``."""
    order = np.random.default_rng([mix["stream_seed"], k])
    n = mix["episode_frames"]
    gaps = order.permutation(quantile_gaps(n, mix["inter_arrival"]))
    counts = class_counts([c["weight"] for c in mix["classes"]], n)
    cls = order.permutation(np.repeat(np.arange(len(counts)), counts))
    image = np.random.default_rng([seed % SEED_MOD, k]).integers(
        mix["images_per_class"], size=n)
    return dict(arrivals=[float(t) for t in np.cumsum(gaps)],
                cls=[int(c) for c in cls], image=[int(i) for i in image],
                origin=[i % mix["replicas"] for i in range(n)],
                rng_seed=int(order.integers(2 ** 31)))


def resolutions(mix: dict) -> List[int]:
    """The model resolutions the mix serves, largest first."""
    return sorted({c["model_res"] for c in mix["classes"]}, reverse=True)
