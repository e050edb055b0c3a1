"""The benchmark's operation and byte counts against hand counts at
DeiT-B's and ViT-H/14's widths."""
import json

import pytest

from perfbench import counts, peaks, spec


def model(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("name,res,tokens", [
    ("deit_b", 384, 24 * 24 + 2), ("deit_b", 224, 14 * 14 + 2),
    ("vit_h14", 384, 27 * 27 + 1), ("vit_h14", 224, 16 * 16 + 1)])
def test_tokens(name, res, tokens):
    assert counts.vit_tokens(model(name), res) == tokens


# by hand: patch 2 (S - extra) p^2 3 d; a layer 8 S d^2 + 4 S d f + 4 S^2 d;
# the head 2 d 1000
HAND = {
    ("deit_b", 384): 2 * 576 * 768 * 768 + 12 * (
        8 * 578 * 768 ** 2 + 4 * 578 * 768 * 3072 + 4 * 578 ** 2 * 768)
    + 2 * 768 * 1000,
    ("deit_b", 224): 2 * 196 * 768 * 768 + 12 * (
        8 * 198 * 768 ** 2 + 4 * 198 * 768 * 3072 + 4 * 198 ** 2 * 768)
    + 2 * 768 * 1000,
    ("vit_h14", 384): 2 * 729 * 588 * 1280 + 32 * (
        8 * 730 * 1280 ** 2 + 4 * 730 * 1280 * 5120 + 4 * 730 ** 2 * 1280)
    + 2 * 1280 * 1000,
    ("vit_h14", 224): 2 * 256 * 588 * 1280 + 32 * (
        8 * 257 * 1280 ** 2 + 4 * 257 * 1280 * 5120 + 4 * 257 ** 2 * 1280)
    + 2 * 1280 * 1000,
}


@pytest.mark.parametrize("key", sorted(HAND), ids=str)
def test_vit_flops(key):
    assert counts.vit_flops(model(key[0]), key[1]) == HAND[key]


def test_vit_flops_magnitudes():
    # about 110 / 35 GFLOP a DeiT-B frame, 1.0 / 0.33 TFLOP a ViT-H/14 one
    assert 105e9 < counts.vit_flops(model("deit_b"), 384) < 115e9
    assert 33e9 < counts.vit_flops(model("deit_b"), 224) < 37e9
    assert 0.95e12 < counts.vit_flops(model("vit_h14"), 384) < 1.1e12
    assert 0.3e12 < counts.vit_flops(model("vit_h14"), 224) < 0.36e12


@pytest.mark.parametrize("B,S,H,D,flops,nbytes", [
    (8, 578, 12, 64, 4 * 8 * 12 * 578 * 578 * 64, 4 * 8 * 578 * 12 * 64 * 2),
    (8, 730, 16, 80, 4 * 8 * 16 * 730 * 730 * 80, 4 * 8 * 730 * 16 * 80 * 2),
    (1, 578, 12, 64, 4 * 12 * 578 * 578 * 64, 4 * 578 * 12 * 64 * 2)])
def test_attention_counts(B, S, H, D, flops, nbytes):
    assert counts.attention_flops(B, S, H, D) == flops
    assert counts.attention_bytes(B, S, H, D, 2) == nbytes
    assert counts.attention_min_s(B, S, H, D, 2) == max(
        flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def test_attention_bound_at_b8():
    # DeiT-B's (8, 578, 12, 64) bound by bytes, 8.48 us; ViT-H/14's
    # (8, 730, 16, 80) by operations, 22.07 us
    assert counts.attention_min_s(8, 578, 12, 64, 2) == pytest.approx(8.48e-6, rel=0.01)
    assert counts.attention_min_s(8, 730, 16, 80, 2) == pytest.approx(22.07e-6, rel=0.01)
