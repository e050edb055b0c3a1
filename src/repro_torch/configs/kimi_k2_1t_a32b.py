"""Kimi K2 — trillion-parameter MoE (paper-table) [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 experts top-8.  ZeRO over the pod axis is required to fit optimizer
state in v5e HBM (DESIGN.md §5); moments kept in bf16 for the same reason.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    moe=True, n_experts=384, top_k=8, moe_shard="expert",
    moe_impl="shard_map",   # local dispatch + psum combine (EXPERIMENTS §Perf A)
    zero_over_pods=True, opt_state_dtype="bfloat16",
)

SMOKE_CONFIG = LMConfig(
    name="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=256,
    moe=True, n_experts=8, top_k=2, moe_shard="expert",
    capacity_factor=64.0,  # drop-free at smoke scale (exact KV-cache consistency)
    remat=False, attn_impl="naive",
)
