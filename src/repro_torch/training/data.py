"""Synthetic data pipeline with background prefetch (the port of
``repro/training/data.py``).

``SyntheticSource`` draws each step's batch with numpy from
``default_rng((seed, step))`` exactly as the reference does, so both
packages train on the same bytes; the pipeline contract (double-buffered
prefetch, deterministic per-step seeding for exact restart) is the
reference's.  A batch spec is a ``Spec`` (shape, numpy dtype) where the
reference has a ``ShapeDtypeStruct``.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np

PyTree = Any


class Spec(NamedTuple):
    """A leaf's shape and dtype: a numpy dtype for a batch entry, a torch
    dtype for a parameter (``models.common.param_specs``)."""
    shape: Tuple[int, ...]
    dtype: Any


class SyntheticSource:
    """Deterministic per-step synthetic batches (restart-reproducible)."""

    def __init__(self, batch_specs: Dict[str, Spec], seed: int = 0,
                 label_range: int = 8):
        self.specs = batch_specs
        self.seed = seed
        self.label_range = label_range

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        out = {}
        for name, spec in self.specs.items():
            dtype = np.dtype(spec.dtype)
            if not spec.shape:      # scalars (e.g. diffusion 'step')
                out[name] = np.asarray(step, dtype)
            elif np.issubdtype(dtype, np.integer):
                out[name] = rng.integers(
                    0, self.label_range, size=spec.shape).astype(dtype)
            else:
                out[name] = (rng.standard_normal(spec.shape) * 0.1
                             ).astype(dtype)
        return out


class PrefetchIterator:
    """Background-thread prefetch with bounded double-buffering; yields
    ``(step, put_fn(batch))`` in step order from ``start_step``."""

    def __init__(self, source: SyntheticSource, start_step: int = 0,
                 prefetch: int = 2,
                 put_fn: Optional[Callable[[PyTree], PyTree]] = None):
        self.source = source
        self.step = start_step
        self.put_fn = put_fn or (lambda x: x)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, self.put_fn(batch)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
