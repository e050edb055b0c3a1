"""The port's language models (``repro_torch.models.transformer``,
``attention.{apply_rope, attention_decode}``, ``serving.kv_cache``, the LM
configs) against ``repro.models.transformer`` and friends on the CPU, with
the same weights and inputs: ``transformer.numpy_params`` makes them with
numpy, **every leaf random** (``constant_std``: the norm scales start at
0, and a forward that scaled by ``scale`` instead of ``1 + scale`` would
otherwise pass); the reference consumes the numpy tree, each leaf cast to
its def's dtype, the port gets it through ``params_from_numpy``.

Tolerances (logits of magnitude up to ~4.4, hidden states ~3): f32
``ATOL`` 1e-5 (observed up to 2.4e-6: the same arithmetic, sums in
another order, ~1e-6 relative); the caches' K / V rows 1e-5 (observed
2.3e-6).  bf16: ``BF16_ATOL`` 0.1 and rms 0.02 (observed max 0.055, rms
~0.01: XLA and PyTorch round bf16 intermediates at different places, and
the norms, attention and MoE each round once more).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ops as jax_ops
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.serving.kv_cache import KVCachePool as JaxPool
from repro_torch.configs import (ARCHS, LMConfig, all_cells, get_config,
                                 get_smoke_config)
from repro_torch.kernels import ops
from repro_torch.launch.steps import model_module
from repro_torch.models import attention as attn
from repro_torch.models import common, transformer
from repro_torch.serving import KVCachePool

ATOL = 1e-5
BF16_ATOL, BF16_RMS = 0.1, 0.02
CONSTANT_STD = 0.02
LM_ARCHS = ("granite-moe-3b-a800m", "starcoder2-7b", "gemma3-27b",
            "kimi-k2-1t-a32b")


def reference_params(tree, defs):
    """The numpy tree as the reference's parameters, each leaf in its def's
    dtype."""
    out = {}
    for path, d in defs.items():
        common.assign(out, path, jnp.asarray(common.nested(tree, path))
                      .astype(d.dtype))
    return out


def configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_smoke(arch), param_dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype,
                                **kw))


def both_params(tcfg, seed=0):
    tree = transformer.numpy_params(tcfg, seed, CONSTANT_STD)
    return (reference_params(tree, transformer.param_defs(tcfg)),
            transformer.params_from_numpy(tree, tcfg, "cpu"))


def prompt(cfg, seed, B=2, S=12):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def t(a):
    return torch.from_numpy(np.asarray(a)).long()


def close(got, want, atol=ATOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch):
    """``logits_fn`` and ``hidden_states`` (with the MoE aux loss) of each
    SMOKE config, f32."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(tcfg)
    tok = prompt(tcfg, 1)
    logits = transformer.logits_fn(tp, t(tok), tcfg)
    assert logits.dtype == torch.float32
    want = jtr.logits_fn(jp, jnp.asarray(tok), jcfg)
    assert float(jnp.abs(want).max()) > 1.0
    close(logits, want)
    h, aux = transformer.hidden_states(tp, t(tok), tcfg)
    jh, jaux = jtr.hidden_states(jp, jnp.asarray(tok), jcfg)
    close(h, jh)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))
    assert (float(jaux) > 0) == tcfg.moe


def test_shared_expert_matches_reference():
    """No published config sets ``n_shared_experts`` (Kimi-K2's is 0 in
    the reference too); the branch, a dense SwiGLU beside the routed
    experts, is held on ``kimi-k2-smoke`` with one added: the forward and
    two decode steps."""
    jcfg, tcfg = configs("kimi-k2-1t-a32b", n_shared_experts=1)
    jp, tp = both_params(tcfg, seed=14)
    assert tp["layers"]["ws_gate"].shape == (2, 64, 32)
    tok = prompt(tcfg, 15)
    close(transformer.logits_fn(tp, t(tok), tcfg),
          jtr.logits_fn(jp, jnp.asarray(tok), jcfg))
    jl, jc = jtr.prefill(jp, jnp.asarray(tok), jcfg, max_len=14)
    last, cache = transformer.prefill(tp, t(tok), tcfg, max_len=14)
    close(last, jl)
    for s in ([3, 5], [7, 11]):
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(s, jnp.int32), jcfg)
        logits, cache = transformer.decode_step(tp, cache, t(s), tcfg)
        close(logits, jl)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` (its last logits, the whole K / V cache padded to
    ``max_len``, ``length``) and three ``decode_step`` calls, each step's
    logits and the cache after it."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(tcfg, seed=2)
    tok = prompt(tcfg, 3)
    jlast, jc = jtr.prefill(jp, jnp.asarray(tok), jcfg, max_len=16)
    last, cache = transformer.prefill(tp, t(tok), tcfg, max_len=16)
    close(last, jlast)
    assert cache["length"] == int(jc["length"]) == 12
    for name in ("k", "v"):
        close(cache[name], jc[name])
        assert not cache[name][:, :, 12:].any()
    steps = np.random.default_rng(4).integers(0, tcfg.vocab_size, (3, 2))
    for s in steps:
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(s, jnp.int32), jcfg)
        logits, cache = transformer.decode_step(tp, cache, t(s), tcfg)
        close(logits, jl)
        for name in ("k", "v"):
            close(cache[name], jc[name])
    assert cache["length"] == int(jc["length"]) == 15


def test_sliding_decode_matches_reference():
    """``gemma3-smoke``'s ring-buffer decode, 12 steps from an empty cache,
    past its window of 8 (every local slot rewritten), against the
    reference's: logits and every cache tensor after each step."""
    jcfg, tcfg = configs("gemma3-27b")
    assert tcfg.sliding_window == 8 and tcfg.global_every == 6
    jp, tp = both_params(tcfg, seed=5)
    jc = jtr.init_sliding_cache(jcfg, 2, 16)
    cache = transformer.init_sliding_cache(tcfg, 2, 16, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items() if k != "length"} \
        == {k: tuple(v.shape) for k, v in jc.items() if k != "length"}
    steps = np.random.default_rng(6).integers(0, tcfg.vocab_size, (12, 2))
    for s in steps:
        jl, jc = jtr.decode_step_sliding(jp, jc, jnp.asarray(s, jnp.int32),
                                         jcfg)
        logits, cache = transformer.decode_step_sliding(tp, cache, t(s), tcfg)
        close(logits, jl)
        for name in ("k_global", "v_global", "k_local", "v_local"):
            close(cache[name], jc[name])
    assert cache["length"] == 12


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "gemma3-27b"])
def test_bf16_forward_and_decode_match_reference(arch):
    """bf16 weights and activations: logits of the forward and of two
    decode steps after a prefill within ``BF16_ATOL`` / ``BF16_RMS``."""
    jcfg, tcfg = configs(arch, "bfloat16")
    jp, tp = both_params(tcfg, seed=7)
    tok = prompt(tcfg, 8)

    def held(got, want):
        g = got.float().numpy()
        w = np.asarray(want, np.float32)
        assert np.abs(g - w).max() <= BF16_ATOL
        assert np.sqrt(((g - w) ** 2).mean()) <= BF16_RMS

    held(transformer.logits_fn(tp, t(tok), tcfg),
         jtr.logits_fn(jp, jnp.asarray(tok), jcfg))
    jl, jc = jtr.prefill(jp, jnp.asarray(tok), jcfg, max_len=14)
    last, cache = transformer.prefill(tp, t(tok), tcfg, max_len=14)
    assert cache["k"].dtype == torch.bfloat16 and last.dtype == torch.float32
    held(last, jl)
    for s in ([3, 5], [7, 11]):
        jl, jc = jtr.decode_step(jp, jc, jnp.asarray(s, jnp.int32), jcfg)
        logits, cache = transformer.decode_step(tp, cache, t(s), tcfg)
        held(logits, jl)


def test_kernel_path_matches_the_reference():
    """``attn_impl="pallas"`` with ``attn_chunk`` 8 at 12 tokens: the port
    takes its kernel path (on the CPU the kernel's plain version) with
    each layer's window an int; the reference's own pallas LM path raises
    (its scan passes the window traced into the Pallas kernel), so the
    port is held to the reference's ``chunked`` path, the same function.
    The sliding window reaches the kernel on gemma3's local layers."""
    for arch in ("granite-moe-3b-a800m", "gemma3-27b"):
        jcfg, tcfg = configs(arch, attn_impl="pallas", attn_chunk=8)
        jp, tp = both_params(tcfg, seed=9)
        tok = prompt(tcfg, 10, S=12)
        with pytest.raises(Exception, match="captures constants"):
            jtr.logits_fn(jp, jnp.asarray(tok), jcfg)
        jcfg = dataclasses.replace(jcfg, attn_impl="chunked")
        seen = []
        real = ops.flash_attention

        def spy(q, k, v, **kw):
            seen.append(kw.get("window"))
            return real(q, k, v, **kw)

        ops.flash_attention = spy
        try:
            got = transformer.logits_fn(tp, t(tok), tcfg)
        finally:
            ops.flash_attention = real
        want = jtr.logits_fn(jp, jnp.asarray(tok), jcfg)
        close(got, want)
        assert seen == transformer._layer_windows(tcfg)


# (B, H, KV, D, window): Granite's causal GQA (heads 64 wide, three query
# heads a KV head), StarCoder2-7B's (36 on 4, 128 wide) and Gemma-3 27B's
# (32 on 16, 128 wide, global and local layers); the Granite cases keep
# the ids they had when they were the only ones
FLASH_LM_SHAPES = [
    pytest.param(2, 6, 2, 64, transformer.NO_WINDOW, id="1073741824"),
    pytest.param(2, 6, 2, 64, 5, id="5"),
    pytest.param(1, 36, 4, 128, transformer.NO_WINDOW,
                 id="starcoder2-1073741824"),
    pytest.param(1, 36, 4, 128, 5, id="starcoder2-5"),
    pytest.param(1, 32, 16, 128, transformer.NO_WINDOW,
                 id="gemma3-1073741824"),
    pytest.param(1, 32, 16, 128, 5, id="gemma3-5"),
]


@pytest.mark.parametrize("B,H,KV,D,window", FLASH_LM_SHAPES)
def test_flash_kernel_at_the_lm_shapes_matches_the_reference_kernel(
        B, H, KV, D, window):
    """Causal GQA as the LM prefills give it to the kernel (Granite's
    heads 64 wide, StarCoder2-7B's and Gemma-3 27B's 128 wide; ``NO_WINDOW``
    = 1 << 30 as an int, or a window), narrow: the reference's Pallas
    kernel in interpret mode against the port's entry point on CPU tensors
    (its plain version), f32 within 1e-5; ``window=NO_WINDOW`` equals
    ``window=None``."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((B, 40, h, D), dtype=np.float32)
               for h in (H, KV, KV))
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              window=window)
    close(got, want)
    if window == transformer.NO_WINDOW:
        none = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=None)
        assert torch.equal(got, none)


def test_embedding_scale_is_rounded_to_the_activation_dtype():
    """sqrt(1536) = 39.19 rounds to 39.25 in bf16 before the product, as
    the reference's ``jnp.asarray(d ** 0.5, h.dtype)``."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              vocab_size=4)
    params = {"embed": torch.ones(4, 1536, dtype=torch.bfloat16)}
    h = transformer._embed(params, torch.tensor([[1, 2]]), cfg)
    assert h.dtype == torch.bfloat16
    assert torch.all(h == 39.25) and 1536 ** 0.5 < 39.2


def test_decode_writes_the_cache_in_place_and_logits_stay_f32():
    """The decode step writes its K / V rows into the cache's own tensors
    (no copy of the cache) and returns f32 logits from bf16 weights:
    ``h.float() @ lm_head.float()``, not a bf16 product."""
    _, tcfg = configs("starcoder2-7b", "bfloat16")
    _, tp = both_params(tcfg)
    last, cache = transformer.prefill(tp, t(prompt(tcfg, 1)), tcfg,
                                      max_len=16)
    k0, v0 = cache["k"], cache["v"]
    ptr = k0.data_ptr()
    logits, new = transformer.decode_step(tp, cache, t([1, 2]), tcfg)
    assert new["k"] is k0 and new["v"] is v0 and k0.data_ptr() == ptr
    assert new["length"] == 13 and cache["length"] == 12
    assert k0[:, :, 12].abs().sum() > 0 and not k0[:, :, 13:].any()
    assert logits.dtype == torch.float32
    assert not torch.equal(logits, logits.to(torch.bfloat16).float())


@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_apply_rope_matches_reference(positions):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.arange(7) + 1000 if positions == "1d" else \
        rng.integers(0, 1200, (2, 7))
    pos = pos.astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta)
        # |x| up to ~4, angles up to ~1200 rad: sin / cos of f32 angles
        # that large differ by a few ulp of the angle between libraries
        close(got, want, atol=2e-5)
    close(attn.rope_frequencies(16, 500.0),
          jattn.rope_frequencies(16, 500.0), atol=1e-7)


@pytest.mark.parametrize("cache_len", ["scalar", "per_row"])
@pytest.mark.parametrize("window", [None, 3])
def test_attention_decode_matches_reference(cache_len, window):
    rng = np.random.default_rng(13)
    q = rng.standard_normal((3, 1, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((3, 10, 2, 16), dtype=np.float32)
            for _ in range(2))
    n = 7 if cache_len == "scalar" else np.array([1, 6, 10], np.int32)
    want = jattn.attention_decode(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(n), window=window)
    got = attn.attention_decode(*map(torch.from_numpy, (q, k, v)),
                                torch.as_tensor(n), window=window)
    close(got, want)
    if cache_len == "scalar":
        again = attn.attention_decode(*map(torch.from_numpy, (q, k, v)), n,
                                      window=window)
        assert torch.equal(again, got)


def test_kv_cache_pool_follows_the_reference():
    """A scripted sequence of allocations, advances, releases, a refused
    allocation, an over-long session and deadline evictions: the same
    sessions, slots, lengths and utilisation at every step."""
    pools = (JaxPool(3, 8), KVCachePool(3, 8))
    log = [[], []]
    for i, p in enumerate(pools):
        a = p.allocate(deadline=5.0)
        b = p.allocate()
        c = p.allocate(deadline=2.0)
        log[i].append((a.slot, b.slot, c.slot, p.allocate(), p.active))
        log[i].append((p.advance(a.session_id, 4), p.advance(b.session_id)))
        with pytest.raises(ValueError, match="exceeded max_len"):
            p.advance(a.session_id, 5)
        log[i].append((p.evict_expired(3.0), p.active, p.utilization()))
        p.release(b.session_id)
        p.release(b.session_id)                 # twice: a no-op
        d = p.allocate()
        log[i].append((d.session_id, d.slot, d.length, p.utilization()))
        log[i].append((p.evict_expired(6.0), p.active, p.utilization()))
    assert log[0] == log[1]


def test_configs_and_cells_match_reference():
    """Every reference arch resolves; the four LM configs (and their SMOKE
    configs) equal the reference's field for field, with their parameter
    counts; ``all_cells`` equals the reference's."""
    assert len(ARCHS) == 10
    for arch in LM_ARCHS:
        for port, ref in ((get_config(arch), jax_config(arch)),
                          (get_smoke_config(arch), jax_smoke(arch))):
            assert isinstance(port, LMConfig)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.total_params() == ref.total_params()
            assert port.active_params() == ref.active_params()
            assert (port.hd, port.n_experts_eff, port.mlp_gelu(),
                    port.moe_shard_mode()) == (ref.hd, ref.n_experts_eff,
                                               ref.mlp_gelu(),
                                               ref.moe_shard_mode())
    assert all_cells() == jax_all_cells()
    assert model_module(get_config("gemma3-27b")) is transformer


def test_param_defs_match_the_reference_and_granite_allocates_48_experts():
    """Shapes and dtypes of every def equal the reference's (the router
    f32); Granite as allocated holds 48 experts a layer, 3,978,668,544 values
    (its ``total_params`` counts 40)."""
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        mine = transformer.param_defs(cfg)
        theirs = jtr.param_defs(jax_config(arch))
        assert sorted(mine) == sorted(theirs)
        for path, d in mine.items():
            assert d.shape == theirs[path].shape
            assert np.dtype(jnp.dtype(d.dtype)) == np.dtype(
                theirs[path].dtype)
    defs = transformer.param_defs(get_config("granite-moe-3b-a800m"))
    assert defs["layers/we_gate"].shape == (32, 48, 1536, 512)
    assert defs["layers/router"].dtype == "float32"
    n = sum(int(np.prod(d.shape)) for d in defs.values())
    assert n == 3_978_668_544 and get_config(
        "granite-moe-3b-a800m").total_params() == 3_374_294_016


def test_init_params_count_and_check_finite():
    """``init_params`` draws from the generator it is given (the same seed
    gives the same weights); ``count_params`` and ``check_finite`` as the
    reference's ``common`` helpers."""
    cfg = get_smoke_config("kimi-k2-1t-a32b")
    a = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = transformer.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a["layers"]["we_up"], b["layers"]["we_up"])
    assert not torch.equal(a["layers"]["we_up"], c["layers"]["we_up"])
    assert a["layers"]["router"].dtype == torch.float32
    n = sum(int(np.prod(d.shape))
            for d in transformer.param_defs(cfg).values())
    assert common.count_params(a) == n
    assert bool(common.check_finite(a))
    a["final_norm"][3] = float("inf")
    assert not bool(common.check_finite(a))
    assert torch.equal(common.swiglu(torch.tensor([1.0, -2.0]),
                                     torch.tensor([3.0, 4.0])),
                       torch.nn.functional.silu(torch.tensor([1.0, -2.0]))
                       * torch.tensor([3.0, 4.0]))


def test_init_params_draws_large_leaves_slice_by_slice(monkeypatch):
    """A leaf larger than ``common.INIT_SLICE`` values is drawn slice by
    slice along its leading axis (a row larger than a slice itself sliced)
    into its preallocated result: a spy on ``torch.randn`` sees no draw
    larger than one slice, every value is drawn once, and the leaves keep
    their shapes, dtypes, std ``scale / sqrt(fan_in)`` and determinism."""
    limit = 1000
    monkeypatch.setattr(common, "INIT_SLICE", limit)
    sizes, real = [], torch.randn

    def spy(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    P = common.ParamDef
    defs = {"rows": P((7, 40, 30), dtype="bfloat16"),      # a row > a slice
            "wide": P((90, 50), dtype="float32"),          # 20 rows a slice
            "flat": P((3000,), dtype="float32"),
            "small": P((7, 100), dtype="bfloat16"),
            "norm": P((64,), "zeros", dtype="bfloat16")}
    a = common.init_params(defs, torch.Generator().manual_seed(3), "cpu")
    assert sizes and max(sizes) <= limit
    assert sum(sizes) == sum(int(np.prod(d.shape)) for d in defs.values()
                             if d.init == "normal")
    b = common.init_params(defs, torch.Generator().manual_seed(3), "cpu")
    for name, d in defs.items():
        assert tuple(a[name].shape) == d.shape
        assert a[name].dtype == common.torch_dtype(d.dtype)
        assert torch.equal(a[name], b[name])
    assert not a["norm"].any()
    for name in ("rows", "wide", "flat"):
        x = a[name].float()
        assert abs(float(x.std()) * (defs[name].shape[-2] if x.dim() > 1
                                     else x.shape[0]) ** 0.5 - 1) < 0.05
        assert abs(float(x.mean())) < 0.05 * float(x.std())


def test_layer_windows_and_global_layers():
    for arch in LM_ARCHS:
        for cfg, jcfg in ((get_config(arch), jax_config(arch)),
                          (get_smoke_config(arch), jax_smoke(arch))):
            assert transformer._layer_windows(cfg) == \
                np.asarray(jtr._layer_windows(jcfg)).tolist()
            assert transformer.layer_is_global(cfg).tolist() == \
                np.asarray(jtr.layer_is_global(jcfg)).tolist()
