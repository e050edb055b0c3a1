"""Roofline terms of a step from its per-chip costs (the port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), all in *per-chip seconds*:

    compute    = FLOPs (per chip)            / PEAK_FLOPS
    memory     = bytes moved (per chip)      / HBM_BW
    collective = collective bytes (per chip) / LINK_BW

The counts come from :mod:`repro_torch.launch.op_cost` (the operators a
step dispatches, on fake tensors), where the reference reads its
compiled HLO.  The constants are an NVIDIA H100 SXM5's published peaks,
where the reference's are a TPU v5e's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM5 (80 GB HBM3) data sheet, at its 700 W board power:
# dense BF16 tensor-core peak, 989.4 TFLOP/s (1,979 with 2:4 sparsity)
PEAK_FLOPS = 989e12          # bf16 / GPU
# the same data sheet: HBM3 bandwidth, 3.35 TB/s
HBM_BW = 3.35e12             # bytes/s / GPU
# A 16-wide mesh axis spans two 8-GPU hosts, so the collective term takes
# the inter-host rate: one 400 Gb/s NDR InfiniBand port a GPU, as a DGX
# H100 has (NVIDIA DGX H100 data sheet), 50 GB/s.  Inside a host NVLink 4
# gives 450 GB/s each way a GPU (the H100 data sheet's 900 GB/s both
# ways): NVLINK_BW, not used by the terms.
LINK_BW = 50e9               # bytes/s / GPU
NVLINK_BW = 450e9            # bytes/s / GPU, each way


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-chip
    hbm_bytes: float             # per-chip
    coll_bytes: float            # per-chip
    coll_breakdown: Dict[str, float]
    model_flops: float           # napkin useful-FLOPs (global)
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs — remat / redundancy
        overhead."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chip's peak the step achieves if every term
        overlaps perfectly: t_compute / max(all terms)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_estimate(cfg, shape) -> float:
    """Napkin 'useful' FLOPs (global, per step), the reference's
    arithmetic.

    LM: 6·N_active·D train / 2·N_active·D forward (attention quadratic term
    excluded by convention — the ratio column then also exposes attention
    overhead at long context).  Vision/diffusion: 2·params·tokens-style
    estimates, 3x for training.
    """
    fam = cfg.family
    if fam == "lm":
        n = cfg.active_params()
        if shape.kind == "train":
            return 6.0 * n * shape.global_batch * shape.seq_len
        if shape.kind == "prefill":
            return 2.0 * n * shape.global_batch * shape.seq_len
        return 2.0 * n * shape.global_batch          # decode: one token each
    if fam in ("vit",):
        # 2·N·T per image forward (N = block params, T = tokens at this res)
        toks = cfg.n_tokens(shape.img_res or cfg.img_res)
        mult = 6.0 if shape.kind == "train" else 2.0
        return mult * cfg.total_params() * shape.global_batch * toks
    if fam == "resnet":
        base = 8.2e9 * (max(shape.img_res, 1) / 224.0) ** 2   # fwd FLOPs/image
        mult = 3.0 if shape.kind == "train" else 1.0
        return mult * base * shape.global_batch
    if fam == "dit":
        toks = cfg.n_tokens(shape.img_res)
        mult = 6.0 if shape.kind == "train" else 2.0
        return mult * cfg.total_params() * shape.global_batch * toks
    # unet
    lr = (shape.img_res // 8) if shape.img_res else cfg.latent_res
    base = 680e9 * (lr / 64.0) ** 2                  # fwd/image at latent 64
    mult = 3.0 if shape.kind == "train" else 1.0
    return mult * base * shape.global_batch


def analyze(costs, cfg, shape, chips: int) -> RooflineTerms:
    """Roofline terms from a step's per-chip ``op_cost.Costs``."""
    return RooflineTerms(
        flops=costs.flops, hbm_bytes=costs.bytes,
        coll_bytes=costs.coll_bytes,
        coll_breakdown={k: float(v) for k, v in costs.coll_by_kind.items()},
        model_flops=model_flops_estimate(cfg, shape), chips=chips)
