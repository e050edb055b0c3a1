"""StarCoder2-7B — GQA, RoPE [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4, head_dim 128) d_ff=18432 vocab=49152.
GELU MLP (two matrices).  36 q-heads shard unevenly over the 16-way model
axis (GSPMD uneven sharding, verified).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152, mlp="gelu",
)

SMOKE_CONFIG = LMConfig(
    name="starcoder2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, mlp="gelu",
    remat=False, attn_impl="naive",
)
