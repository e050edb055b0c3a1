"""IBM Granite 3.0 MoE — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155, MoE 40e
top-8.  40 experts do not divide the 16-way model axis, so each expert's
d_ff shards instead (moe_shard="ffn", DESIGN.md §5).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    moe=True, n_experts=40, top_k=8,
    # 40 experts don't divide the 16-way model axis; pad to 48 dummy experts
    # so expert parallelism applies — EXPERIMENTS.md §Perf iteration A3.
    # Only the mesh's dispatch (moe_ffn_sharded) masks them; without a mesh
    # the 8 padded experts are routed to like real ones, as the reference's
    # moe_ffn does (models/moe.py).
    moe_shard="expert", n_experts_pad=48, moe_impl="shard_map",
)

SMOKE_CONFIG = LMConfig(
    name="granite-moe-smoke",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=128,
    moe=True, n_experts=5, top_k=2, moe_shard="ffn",
    capacity_factor=64.0,  # drop-free at smoke scale (exact KV-cache consistency)
    remat=False, attn_impl="naive",
)
