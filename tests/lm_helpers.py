"""Helpers of the language-model goldens, shared by
``tests/make_torch_lm_golden.py`` (the JAX reference's side, on numpy
arrays), the CPU tests and ``chip_smoke.py`` (the port's side, on numpy
arrays or torch tensors).  Imports neither JAX nor the JAX package.

* :func:`sliding_from_full` — a Gemma-3 sliding decode cache (ring
  buffers of ``window`` slots for the local layers, full caches for the
  global ones) holding what a full cache holds at ``length``: neither
  package has such a function, so a ``decode_step_sliding`` run that
  continues a prefill starts from this.
* :func:`logit_views` — a (..., V) logits array as the golden stores it:
  the logits at a fixed set of vocabulary columns, and over the whole
  vocabulary the largest logit, its column and the log-sum-exp.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def layer_split(n_layers: int, global_every: int) -> Tuple[List[int],
                                                          List[int]]:
    """The local and the global layers, each in order: every
    ``global_every``-th layer is global (layers 5, 11, ... for 6)."""
    glob = [i for i in range(n_layers) if (i + 1) % global_every == 0]
    return [i for i in range(n_layers) if i not in glob], glob


def ring_positions(length: int, window: int) -> List[int]:
    """The position each ring slot holds at ``length``: slot ``p %
    window`` holds position ``p`` for ``p`` in ``[length - window,
    length)``; below ``window`` tokens slot ``s`` holds position ``s``
    (the slots at and past ``length`` empty)."""
    if length <= window:
        return list(range(window))
    lo = length - window
    return [lo + (s - lo) % window for s in range(window)]


def sliding_from_full(k, v, length: int, window: int, global_every: int
                      ) -> Dict[str, object]:
    """A sliding cache (``k_local`` / ``v_local`` of ``window`` slots,
    ``k_global`` / ``v_global`` as long as the full cache, ``length``)
    from a full cache's K and V, (L, B, max_len, KV, hd) numpy arrays or
    torch tensors: each local layer's ring built by
    :func:`ring_positions` (empty slots zero), each global layer its full
    cache with the rows at and past ``length`` zero (the prefill's own
    cache has them zero; a decode that wrote past it leaves them
    written).  Copies: the full cache may be dropped after."""
    local, glob = layer_split(k.shape[0], global_every)
    pos = ring_positions(length, window)
    out = {"length": length}
    for name, full in (("k", k), ("v", v)):
        # one copy of the rings' size, then each layer's slots gathered
        # (never a copy of every local layer's whole cache)
        ring = full[local, :, :window]
        for i, layer in enumerate(local):
            ring[i] = full[layer][:, pos]
        if length < window:
            ring[:, :, length:] = 0
        g = full[glob]
        g[:, :, length:] = 0
        out[name + "_local"], out[name + "_global"] = ring, g
    return out


def logit_views(logits, columns) -> Dict[str, np.ndarray]:
    """(..., V) logits (numpy, or anything ``np.asarray`` reads) as the
    golden stores them: ``cols`` the logits at ``columns``, and over the
    whole vocabulary ``max``, ``argmax`` and ``lse`` (the log-sum-exp, in
    float64 from the float32 logits)."""
    a = np.asarray(logits, np.float32)
    m = a.max(-1)
    lse = m.astype(np.float64) + np.log(np.exp(
        a.astype(np.float64) - m[..., None]).sum(-1))
    return {"cols": a[..., np.asarray(columns)], "max": m,
            "argmax": a.argmax(-1).astype(np.int32),
            "lse": lse.astype(np.float32)}
