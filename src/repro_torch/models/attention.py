"""Attention: GQA, RoPE, causal / sliding-window masks, and single-token
decode against a KV cache (the port of ``repro/models/attention.py``).

Three interchangeable implementations (``impl``):

* ``naive``   — materialises the (S, S) score matrix;
* ``chunked`` — online softmax over query chunks and KV chunks in plain
  PyTorch, as the reference writes it in XLA; under grad each KV step is
  checkpointed (recomputed in the backward), as the reference's
  ``jax.checkpoint`` on its ``kv_step`` does, so the backward keeps no
  (q chunk x kv chunk) score block;
* ``pallas``  — the reference's name for its kernel; here it selects
  :func:`repro_torch.kernels.ops.flash_attention`, the hand-written Hopper
  kernel on a CUDA tensor (its plain version on a CPU tensor).

Shapes: q (B, S, H, D); k, v (B, S, KV, D) with H % KV == 0.
``window``: None for full attention; an int w attends to keys in (i-w, i].
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import checkpointed

NEG_INF = -1e30


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """(head_dim / 2,) f32 rotary frequencies ``theta ** (-i / half)``."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at ``positions`` (B, S) or (S,),
    the halves rotated in f32 (angles ``position * frequency``), cast back
    to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]      # (B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(Q, K) f32 additive bias: 0 where attended, -1e30 elsewhere."""
    dist = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(dist.shape, dtype=torch.bool, device=dist.device)
    if causal:
        ok &= dist >= 0
    if window is not None:
        ok &= dist < window
    zero = torch.zeros((), dtype=torch.float32, device=dist.device)
    return torch.where(ok, zero, NEG_INF)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float
                ) -> torch.Tensor:
    """q (B,Sq,KV,G,D), k (B,Sk,KV,D) -> scores (B,KV,G,Sq,Sk) in f32
    (the reference's ``preferred_element_type=f32``: products of the
    inputs accumulated in f32)."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def attention_naive(q, k, v, *, causal=True, window=None,
                    q_offset: int = 0) -> torch.Tensor:
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qg = q.reshape(B, Sq, KV, G, D)
    scores = _gqa_scores(qg, k, scale)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def _kv_step(m, l, acc, q_blk, k_blk, v_blk, q_pos, k0: int, Sk: int,
             scale: float, causal: bool, window):
    """One KV chunk of the online softmax: the running max ``m``, sum
    ``l`` and f32 accumulator ``acc`` updated with keys ``k0 ...``."""
    k_pos = k0 + torch.arange(k_blk.shape[1], device=q_blk.device)
    s = _gqa_scores(q_blk, k_blk, scale)
    s = s + _mask_bias(q_pos, k_pos, causal, window)
    s = torch.where(k_pos < Sk, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(v_blk.dtype), v_blk).float()
    return m_new, l, acc


def attention_chunked(q, k, v, *, causal=True, window=None,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax blocked attention that never materialises S x S:
    a loop over query chunks, and inside it over KV chunks carrying
    (m, l, acc) in f32; the zero-padded KV tail is masked."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    q_pad, k_pad = nq * q_chunk - Sq, nk * kv_chunk - Sk
    qg = q.reshape(B, Sq, KV, G, D)
    if q_pad:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, q_pad))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, k_pad)) if k_pad else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, k_pad)) if k_pad else v
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk]      # (B,qc,KV,G,D)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev) + q_offset
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            m, l, acc = checkpointed(
                _kv_step, m, l, acc, q_blk, kp[:, ki * kv_chunk:
                                               (ki + 1) * kv_chunk],
                vp[:, ki * kv_chunk:(ki + 1) * kv_chunk], q_pos,
                ki * kv_chunk, Sk, scale, causal, window)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))              # (B,qc,KV,G,D)
    out = torch.cat(outs, dim=1)[:, :Sq].reshape(B, Sq, H, D)
    return out.to(q.dtype)


def attention_decode(q, k_cache, v_cache, cache_len, *, window=None
                     ) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, D) against (B, S, KV, D) caches, of
    which the first ``cache_len`` entries (an int, a 0-d tensor or (B,))
    are valid; with ``window`` only the last ``window`` of them.  Linear
    in S, f32 scores and softmax, the probabilities rounded to the cache's
    dtype before the product with V (the reference's plain form: no
    kernel stands behind it)."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = D ** -0.5
    qg = q.reshape(B, 1, KV, G, D)
    s = _gqa_scores(qg, k_cache, scale)[..., 0, :]           # (B,KV,G,S)
    k_pos = torch.arange(S, device=q.device)
    # an int stays a Python scalar (no copy to the device, no wait)
    n = cache_len if isinstance(cache_len, int) else \
        torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = k_pos[None, :] < n                              # (B,S) or (1,S)
    if window is not None:
        valid &= k_pos[None, :] >= n - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, impl="chunked",
              q_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """The reference's dispatcher: a sequence that fits one query chunk
    (``S <= q_chunk``) takes the naive path whatever ``impl`` says."""
    if impl == "naive" or q.shape[1] <= q_chunk:
        return attention_naive(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "chunked":
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=q_chunk,
                                 q_offset=q_offset)
    if impl == "pallas":
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}")
