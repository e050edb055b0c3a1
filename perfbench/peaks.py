"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3), from NVIDIA's data
sheet, dense rates without sparsity, at the board's 700 W.  A card set
below 700 W reaches less; the runs print its power limit beside them."""

BF16_FLOPS = 989e12          # FLOP/s, bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12    # bytes/s
