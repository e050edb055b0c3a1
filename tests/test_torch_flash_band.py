"""The flash kernels' key band on the CPU: the key tiles a launch walks.

Every variant of ``csrc/flash_attention.cu`` walks, for its query rows,
only the key tiles that some row can see
(``repro_torch.kernels.flash_attention.key_tile_band``, the Python
statement of the kernel's ``key_band``).  Here the band is held by brute
force against the mask of the plain version
(``ref.flash_attention_mask``, which ``ref.flash_attention_ref`` applies),
and an online-softmax walk written here, in f32 with the kernel's -1e30
and its rescaling rule, shows that walking the band gives the walk over
every tile bit for bit; both agree with the JAX reference's Pallas kernel
in interpret mode (through ``repro.kernels.ops.flash_attention``, as
``tests/test_torch_attention.py`` runs it) within
``ref.flash_attention_tolerance`` (1e-5 in f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref

KEYS = 64          # keys of a key tile, rows of a query tile (tma_wgmma)
NEG = -1e30        # the kernel's finite mask value


@pytest.mark.parametrize("rows", [64, 128])     # one query tile, or two
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 63, 64, 65, 1024, 1 << 30])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1100, 4097])
def test_key_tile_band_is_the_tiles_some_row_sees(S, window, causal, rows):
    """For every block of ``rows`` query rows: each key tile outside the
    band is masked for every row of the block below S, and each tile
    inside has a live key for some row."""
    ok = ref.flash_attention_mask(S, S, causal, window)
    n_kv = -(-S // KEYS)
    pad = torch.zeros((S, n_kv * KEYS - S), dtype=torch.bool)
    tiles = torch.cat([ok, pad], 1).view(S, n_kv, KEYS).any(-1)
    for q_lo in range(0, S, rows):
        live = tiles[q_lo:q_lo + rows].any(0)
        band = tfa.key_tile_band(q_lo, rows, S, causal, window)
        want = [t for t in range(n_kv) if live[t]]
        assert list(band) == want, (q_lo, list(band), want)
    assert len(tfa.key_tile_band(S, rows, S, causal, window)) == 0


def test_key_tile_band_counts_the_causal_triangle():
    """At Granite's 32k prefill a head's causal bands hold the lower
    triangle of 512 x 512 key tiles (131,328), and under Gemma-3's window
    of 1,024 a query tile's band is at most 17 tiles (64 rows reach
    back over 1,087 keys, the tiles of 64 aligned)."""
    S = 32768
    n_q = S // KEYS
    assert sum(len(tfa.key_tile_band(i * KEYS, KEYS, S, True, None))
               for i in range(n_q)) == n_q * (n_q + 1) // 2
    assert sum(len(tfa.key_tile_band(i * KEYS, KEYS, S, True, 1 << 30))
               for i in range(n_q)) == n_q * (n_q + 1) // 2
    assert max(len(tfa.key_tile_band(i * KEYS, KEYS, S, True, 1024))
               for i in range(n_q)) == 17


def _tile_walk(q, k, v, causal, window, tiles_of):
    """Attention by the kernel's online softmax over the key tiles
    ``tiles_of(query tile)`` in ascending order, in f32: scores masked to
    -1e30, m from -1e30, l and acc from 0, alpha = exp(m - m_new), p =
    exp(s - m_new), l = l alpha + sum p, acc = acc alpha + p v, the
    output acc / max(l, 1e-30)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kh, vh = (x.repeat_interleave(G, dim=2) for x in (k, v))
    ok = ref.flash_attention_mask(S, S, causal, window)
    out = torch.empty_like(q)
    for qt in range(-(-S // KEYS)):
        r = slice(qt * KEYS, min(S, (qt + 1) * KEYS))
        qb = q[:, r]
        n = qb.shape[1]
        m = torch.full((B, H, n), NEG)
        l = torch.zeros((B, H, n))
        acc = torch.zeros((B, H, n, D))
        for t in tiles_of(qt):
            c = slice(t * KEYS, min(S, (t + 1) * KEYS))
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kh[:, c]) * D ** -0.5
            s = torch.where(ok[r, c], s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vh[:, c])
            m = m_new
        out[:, r] = (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)
    return out


def test_band_walk_equals_the_walk_over_every_tile_and_the_reference():
    """(2, 300, 6 / 2, 64) f32, causal, window 70: the walk over each
    query tile's band, and over its full-grid block's band (two query
    tiles), equal the walk over every key tile bit for bit; all three
    agree with the JAX reference's kernel."""
    B, S, H, KV, D, window = 2, 300, 6, 2, 64, 70
    rng = np.random.default_rng(27)
    arrs = [rng.standard_normal((B, S, h, D), dtype=np.float32)
            for h in (H, KV, KV)]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    n_kv = -(-S // KEYS)
    every = _tile_walk(q, k, v, True, window, lambda qt: range(n_kv))
    band = _tile_walk(q, k, v, True, window, lambda qt: tfa.key_tile_band(
        qt * KEYS, KEYS, S, True, window))
    block = _tile_walk(q, k, v, True, window, lambda qt: tfa.key_tile_band(
        qt // 2 * 2 * KEYS, 2 * KEYS, S, True, window))
    # the bands skip tiles past the diagonal and before the window
    bands = [tfa.key_tile_band(i * KEYS, KEYS, S, True, window)
             for i in range(n_kv)]
    assert sum(map(len, bands)) < n_kv * (n_kv + 1) // 2
    assert any(b.start > 0 for b in bands)
    assert torch.equal(band.view(torch.int32), every.view(torch.int32))
    assert torch.equal(block.view(torch.int32), every.view(torch.int32))
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in arrs), causal=True, window=window))
    tol = ref.flash_attention_tolerance(torch.from_numpy(want), v)
    for got in (every, band):
        np.testing.assert_allclose(got.numpy(), want, **tol)
    # the plain version agrees as well, and a walk that starts one tile
    # late (drops the window's first live keys) does not
    np.testing.assert_allclose(
        ref.flash_attention_ref(q, k, v, causal=True, window=window)
        .numpy(), want, **tol)
    late = _tile_walk(q, k, v, True, window, lambda qt: tfa.key_tile_band(
        qt * KEYS, KEYS, S, True, window)[1:])
    assert not np.allclose(late.numpy(), want, **tol)


@pytest.mark.parametrize("block", [64, 100, 1024])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 70),
                                           (False, None), (False, 70)])
def test_plain_version_by_blocks_matches_the_whole_and_the_reference(
        block, causal, window):
    """``ref.flash_attention_ref_by_blocks`` (the plain version a block of
    query rows at a time at its offset, the yardstick of the 32k shapes on
    the card) against the plain version over the whole sequence and the
    JAX reference's kernel, (2, 300, 6 / 2, 64) f32: blocks that split
    query tiles, one block, causal and not, with and without a window."""
    B, S, H, KV, D = 2, 300, 6, 2, 64
    rng = np.random.default_rng(block + 2 * causal + (window or 0))
    arrs = [rng.standard_normal((B, S, h, D), dtype=np.float32)
            for h in (H, KV, KV)]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got = ref.flash_attention_ref_by_blocks(q, k, v, causal=causal,
                                            window=window, block=block)
    whole = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in arrs), causal=causal, window=window))
    tol = ref.flash_attention_tolerance(torch.from_numpy(want), v)
    assert got.shape == whole.shape
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **tol)
    np.testing.assert_allclose(got.numpy(), want, **tol)
