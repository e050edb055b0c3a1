"""StarCoder2-7B and Gemma-3 27B with their real attention heads, narrow
elsewhere, on the port's kernel path against the JAX reference on the CPU.

The full-width models run only on the card (``chip_smoke.py`` phase 4j);
here each keeps its published head geometry, the part that reaches the
flash kernel, and is narrow elsewhere (d_model 256, d_ff 512, vocab 512):

* StarCoder2: 36 query heads on 4 KV heads 128 wide (nine query heads a
  KV head), GELU, 2 layers;
* Gemma-3: 32 on 16, 128 wide, ``global_every`` 6 over 6 layers (layer 5
  global), the window cut to 8.

The port runs ``attn_impl="pallas"`` with ``attn_chunk`` 8, so a prompt
of 12 tokens takes its kernel path (on the CPU the kernel's plain
version), each layer's window as an int; the reference's own pallas LM
path raises (ROADMAP §3), so it is held to the reference's ``chunked``
path, the same function, in f32 within ``ATOL``: logits, the prefill's
last logits and cache, three ``decode_step`` steps and, for Gemma,
``decode_step_sliding`` from a sliding cache built from the prefill's
cache (``tests/lm_helpers.py::sliding_from_full``, on each side's own
cache).  Observed: 1.5e-6 at most.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_helpers import layer_split, ring_positions, sliding_from_full
from repro.configs import get_config as jax_config
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import common, transformer

ATOL = 1e-5
CONSTANT_STD = 0.02
PROMPT, MAX_LEN, CHUNK = 12, 16, 8
NARROW = dict(d_model=256, d_ff=512, vocab_size=512, param_dtype="float32",
              attn_impl="pallas", attn_chunk=CHUNK)
GEOMETRIES = {"starcoder2-7b": dict(n_layers=2),
              "gemma3-27b": dict(n_layers=6, sliding_window=8)}


def configs(arch):
    kw = dict(NARROW, **GEOMETRIES[arch])
    jcfg = dataclasses.replace(jax_config(arch), **kw)
    return dataclasses.replace(jcfg, attn_impl="chunked"), \
        dataclasses.replace(get_config(arch), **kw)


def both_params(tcfg, seed):
    tree = transformer.numpy_params(tcfg, seed, CONSTANT_STD)
    jp = {}
    for path, d in transformer.param_defs(tcfg).items():
        common.assign(jp, path, jnp.asarray(common.nested(tree, path))
                      .astype(d.dtype))
    return jp, transformer.params_from_numpy(tree, tcfg, "cpu")


def tokens(cfg, seed, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def t(a):
    return torch.from_numpy(np.asarray(a)).long()


def close(got, want, atol=ATOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


class FlashSpy:
    """Records the window of each ``ops.flash_attention`` call (the real
    function runs)."""

    def __init__(self):
        self.windows, self.real = [], ops.flash_attention

    def __call__(self, q, k, v, **kw):
        self.windows.append(kw.get("window"))
        assert q.shape[-1] == 128
        return self.real(q, k, v, **kw)

    def __enter__(self):
        ops.flash_attention = self
        return self

    def __exit__(self, *exc):
        ops.flash_attention = self.real


def test_narrow_configs_keep_the_published_heads():
    """The narrow configs keep each published model's heads, MLP and
    layer pattern; only the widths, depth and Gemma's window change."""
    for arch in GEOMETRIES:
        jcfg, tcfg = configs(arch)
        full = get_config(arch)
        assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd, tcfg.mlp_gelu(),
                tcfg.global_every, tcfg.rope_theta) == \
            (full.n_heads, full.n_kv_heads, full.hd, full.mlp_gelu(),
             full.global_every, full.rope_theta)
        assert dataclasses.asdict(jcfg) == dict(
            dataclasses.asdict(tcfg), attn_impl="chunked")
    _, gemma = configs("gemma3-27b")
    assert transformer._layer_windows(gemma) == [8] * 5 + [
        transformer.NO_WINDOW]


@pytest.mark.parametrize("arch", sorted(GEOMETRIES))
def test_kernel_path_logits_match_the_reference(arch):
    """``logits_fn`` through the kernel path: one flash call a layer with
    the layer's window, against the reference's chunked path."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(tcfg, seed=21)
    tok = tokens(tcfg, 22, 2, PROMPT)
    with FlashSpy() as spy:
        got = transformer.logits_fn(tp, t(tok), tcfg)
    assert spy.windows == transformer._layer_windows(tcfg)
    want = jtr.logits_fn(jp, jnp.asarray(tok), jcfg)
    assert float(jnp.abs(want).max()) > 0.5
    close(got, want)


@pytest.mark.parametrize("arch", sorted(GEOMETRIES))
def test_kernel_path_prefill_and_decode_match_the_reference(arch):
    """``prefill`` (its last logits and the whole cache) and three
    ``decode_step`` calls (no flash call), each step's logits and cache."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(tcfg, seed=23)
    tok = tokens(tcfg, 24, 2, PROMPT)
    with FlashSpy() as spy:
        last, cache = transformer.prefill(tp, t(tok), tcfg, MAX_LEN)
        jlast, jc = jtr.prefill(jp, jnp.asarray(tok), jcfg, MAX_LEN)
        assert len(spy.windows) == tcfg.n_layers
        close(last, jlast)
        for name in ("k", "v"):
            close(cache[name], jc[name])
        for s in tokens(tcfg, 25, 3, 2):
            jl, jc = jtr.decode_step(jp, jc, jnp.asarray(s), jcfg)
            logits, cache = transformer.decode_step(tp, cache, t(s), tcfg)
            close(logits, jl)
            for name in ("k", "v"):
                close(cache[name], jc[name])
        assert len(spy.windows) == tcfg.n_layers


def test_sliding_decode_from_the_prefill_matches_the_reference():
    """Gemma-3's ``decode_step_sliding`` from a sliding cache built from
    the prefill's cache (12 tokens past a window of 8: ring slots hold
    positions 4-11), three steps: logits and every cache tensor against
    the reference's on its own cache built alike."""
    jcfg, tcfg = configs("gemma3-27b")
    jp, tp = both_params(tcfg, seed=26)
    tok = tokens(tcfg, 27, 2, PROMPT)
    _, cache = transformer.prefill(tp, t(tok), tcfg, MAX_LEN)
    _, jc = jtr.prefill(jp, jnp.asarray(tok), jcfg, MAX_LEN)
    W, g = tcfg.sliding_window, tcfg.global_every
    sl = sliding_from_full(cache["k"], cache["v"], PROMPT, W, g)
    js = sliding_from_full(np.asarray(jc["k"]), np.asarray(jc["v"]), PROMPT,
                           W, g)
    js = {k: jnp.asarray(v, jnp.int32 if k == "length" else None)
          for k, v in js.items()}
    specs = transformer.sliding_cache_specs(tcfg, 2, MAX_LEN)
    assert {k: tuple(v.shape) for k, v in sl.items() if k != "length"} == \
        {k: s for k, (s, _) in specs.items() if k != "length"}
    for s in tokens(tcfg, 28, 3, 2):
        jl, js = jtr.decode_step_sliding(jp, js, jnp.asarray(s), jcfg)
        logits, sl = transformer.decode_step_sliding(tp, sl, t(s), tcfg)
        close(logits, jl)
        for name in ("k_global", "v_global", "k_local", "v_local"):
            close(sl[name], js[name])
    assert sl["length"] == PROMPT + 3


def test_reference_sliding_decode_agrees_with_its_full_decode():
    """The reference with itself, and the port with itself: from one
    prefill, three ``decode_step_sliding`` steps on the sliding cache
    built from it give ``decode_step``'s logits on the full cache (the
    window of 8 past 12 tokens: the ring drops exactly the keys the
    window masks)."""
    jcfg, tcfg = configs("gemma3-27b")
    jp, tp = both_params(tcfg, seed=29)
    tok = tokens(tcfg, 30, 2, PROMPT)
    steps = tokens(tcfg, 31, 3, 2)
    _, jc = jtr.prefill(jp, jnp.asarray(tok), jcfg, MAX_LEN)
    js = sliding_from_full(np.asarray(jc["k"]), np.asarray(jc["v"]), PROMPT,
                           tcfg.sliding_window, tcfg.global_every)
    js = {k: jnp.asarray(v, jnp.int32 if k == "length" else None)
          for k, v in js.items()}
    _, cache = transformer.prefill(tp, t(tok), tcfg, MAX_LEN)
    sl = sliding_from_full(cache["k"], cache["v"], PROMPT,
                           tcfg.sliding_window, tcfg.global_every)
    for s in steps:
        full, jc = jtr.decode_step(jp, jc, jnp.asarray(s), jcfg)
        slid, js = jtr.decode_step_sliding(jp, js, jnp.asarray(s), jcfg)
        close(slid, full)
        full, cache = transformer.decode_step(tp, cache, t(s), tcfg)
        slid, sl = transformer.decode_step_sliding(tp, sl, t(s), tcfg)
        close(slid, full)


def test_sliding_cache_helper_places_each_position():
    """``sliding_from_full`` on a cache whose rows hold their own
    position: ring slot ``p % W`` holds ``p`` for the last ``W``
    positions, empty slots zero below ``W`` tokens, global layers their
    cache with rows past ``length`` zero; numpy and torch alike."""
    L, B, T, W = 6, 1, 20, 8
    full = np.broadcast_to(np.arange(T, dtype=np.float32)[None, None, :,
                                                           None, None],
                           (L, B, T, 1, 1)).copy()
    full = full + 100 * np.arange(L, dtype=np.float32)[:, None, None, None,
                                                          None]
    local, glob = layer_split(L, 6)
    assert (local, glob) == ([0, 1, 2, 3, 4], [5])
    for n in (5, 8, 13):
        for arr in (full, torch.from_numpy(full)):
            out = sliding_from_full(arr, arr, n, W, 6)
            ring = np.asarray(out["k_local"])[:, 0, :, 0, 0]
            pos = ring_positions(n, W)
            for i, layer in enumerate(local):
                want = np.where(np.arange(W) < n, 100 * layer
                                + np.asarray(pos, np.float32), 0)
                np.testing.assert_array_equal(ring[i], want)
            if n > W:
                assert sorted(pos) == list(range(n - W, n))
                assert all(p % W == s for s, p in enumerate(pos))
            g = np.asarray(out["k_global"])[0, 0, :, 0, 0]
            np.testing.assert_array_equal(
                g, np.where(np.arange(T) < n, 500 + np.arange(T), 0))
            assert out["length"] == n
        assert full[5, 0, 19, 0, 0] == 519          # the input untouched
