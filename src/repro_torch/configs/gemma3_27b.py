"""Gemma 3 27B — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified].

62L d_model=5376 32H (GQA kv=16, head_dim 128) d_ff=21504 vocab=262144.
Local layers use a 1024-token sliding window; every 6th layer is global —
this is the sub-quadratic structure that runs the long_500k decode cell.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma3-27b",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    sliding_window=1024, global_every=6, rope_theta=1_000_000.0,
)

SMOKE_CONFIG = LMConfig(
    name="gemma3-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128,
    sliding_window=8, global_every=6,
    remat=False, attn_impl="naive",
)
