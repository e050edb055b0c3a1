"""The port's attention against the JAX reference on the CPU.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors runs its plain
version (``ref.flash_attention_ref``); the reference's
``repro.kernels.ops.flash_attention`` runs the Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it.  Inputs are numpy arrays from
a seed, fed to both.  Tolerances: the kernel against its plain version
is held to ``ref.flash_attention_tolerance`` (f32 1e-5; bf16 one unit in
the last place relative and 2^-7 (max|out| + max|v| / 8) absolute, the
rule that holds the CUDA kernel on the card); the chunked path in bf16 to
2e-2, the JAX package's own tolerance for attention in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MASKS = {"causal": (True, None), "full": (False, None),
         "window": (True, 37)}
# GQA alternates with the mask so that every (S, D, dtype) sees both
HEADS = {"causal": (4, 2), "full": (4, 4), "window": (4, 2)}


def _qkv(seed, B, S, H, KV, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, D), dtype=np.float32)
            for h in (H, KV, KV)]
    j = [jnp.asarray(a).astype(dtype) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _close(got: torch.Tensor, want, dtype, tol=None):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or TOLS[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("D", [12, 16, 64])
@pytest.mark.parametrize("S", [17, 130, 200])
def test_flash_attention_matches_reference(S, D, mask, dtype):
    causal, window = MASKS[mask]
    H, KV = HEADS[mask]
    (jq, jk, jv), (tq, tk, tv) = _qkv(S * 131 + D, 2, S, H, KV, D, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (2, S, H, D)
    _close(got, want, dtype, ref.flash_attention_tolerance(got, tv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("D", [72, 80])
def test_flash_attention_matches_reference_at_wide_heads(D, mask, dtype):
    """The head widths the card's tma_wgmma kernel reads narrower than its
    128-wide tiles, DiT-XL/2's 72 and ViT-H/14's 80 (the reference pads
    both to 128), at a ragged S with causal, window and GQA; the plain
    version held to ``ref.flash_attention_tolerance``."""
    causal, window = MASKS[mask]
    H, KV = HEADS[mask]
    (jq, jk, jv), (tq, tk, tv) = _qkv(D * 7 + len(mask), 2, 197, H, KV, D,
                                      dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (2, 197, H, D)
    _close(got, want, dtype, ref.flash_attention_tolerance(got, tv))


def test_bf16_tolerance_rejects_a_dropped_key():
    """The rule that holds the card's kernel to its plain version, at the
    served shape (578 tokens, 12 heads, D 64, bf16): the reference's
    kernel passes it, and a kernel that drops the last key (in the ragged
    tail tile) fails it."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, 1, 578, 12, 12, 64, "bfloat16")
    want = tops.flash_attention(tq, tk, tv, causal=False)
    tol = ref.flash_attention_tolerance(want, tv)
    assert tol["atol"] < 2e-2                   # tighter than the fixed rule
    kernel = np.asarray(jops.flash_attention(jq, jk, jv, causal=False),
                        np.float32)
    assert torch.allclose(torch.from_numpy(kernel), want.float(), **tol)
    dropped = ref.flash_attention_ref(tq, tk[:, :-1], tv[:, :-1],
                                      causal=False)
    assert not torch.allclose(dropped.float(), want.float(), **tol)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("q_chunk", [64, 512])        # S=130: both sides
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 40)])
def test_attention_dispatch_matches_reference(impl, q_chunk, causal, window):
    """``attention()`` under each impl, on both sides of the rule
    ``impl == "naive" or S <= q_chunk -> naive``."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(7, 2, 130, 4, 2, 16, "float32")
    kw = dict(causal=causal, window=window, impl=impl, q_chunk=q_chunk)
    want = jattn.attention(jq, jk, jv, **kw)
    got = tattn.attention(tq, tk, tv, **kw)
    _close(got, want, "float32")


def test_attention_dispatch_rule_picks_the_kernel_only_past_q_chunk(
        monkeypatch):
    calls = []
    real = tops.flash_attention
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, (tq, tk, tv) = _qkv(3, 1, 18, 4, 4, 12, "float32")
    tattn.attention(tq, tk, tv, causal=False, impl="pallas", q_chunk=18)
    assert calls == []
    tattn.attention(tq, tk, tv, causal=False, impl="pallas", q_chunk=16)
    assert calls == [1]
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(tq, tk, tv, impl="flash", q_chunk=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference_with_offset(dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(11, 1, 100, 4, 1, 16, dtype)
    kw = dict(causal=True, window=30, q_chunk=32, kv_chunk=24, q_offset=0)
    _close(tattn.attention_chunked(tq, tk, tv, **kw),
           jattn.attention_chunked(jq, jk, jv, **kw), dtype)


def test_mask_bias_matches_reference():
    qp, kp = np.arange(5, 12), np.arange(14)
    for causal, window in ((True, None), (False, 3), (True, 4)):
        want = np.asarray(jattn._mask_bias(jnp.asarray(qp), jnp.asarray(kp),
                                           causal, window))
        got = tattn._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp),
                               causal, window)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    _, (q, k, v) = _qkv(0, 1, 8, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 8, 4, 130)
        tops.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="multiple"):
        tops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16),
                             v[:, :, :1].expand(1, 8, 3, 16))
    with pytest.raises(TypeError, match="dtypes"):
        tops.flash_attention(q, k.double(), v)
    # the reference's tile sizes are taken for parity and change nothing
    assert torch.equal(tops.flash_attention(q, k, v, block_q=16, block_k=8),
                       tops.flash_attention(q, k, v))
    # the kernel's wrapper launches on CUDA tensors only: no CPU fallback
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before
