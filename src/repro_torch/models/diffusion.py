"""The diffusion models' forward process in training, shared by DiT-XL/2
and the SD 1.5 UNet (``repro/models/dit.py`` and ``unet.py``
``loss_fn``): the DDPM schedule, the reference's noise at a step (JAX's
threefry draws, bit for bit, ``models.prng``) and the noised latents.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.fleetsim import rng
from repro_torch.models import prng


def ddpm_alphas(n_steps: int = 1000) -> torch.Tensor:
    """The cumulative products of (1 - beta) over the linear beta schedule
    1e-4 .. 0.02, in f32 on the CPU (XLA's linspace and cumulative product
    round otherwise than PyTorch's: within 3.1e-7 relative of the
    reference's)."""
    betas = torch.linspace(1e-4, 0.02, n_steps, dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0)


def diffusion_noise(step, latents: torch.Tensor):
    """The reference's training noise at ``step`` (a host int) for a batch
    of ``latents`` (B, H, W, C): ``t`` (B,) int64, JAX's ``randint(
    fold_in(rng, 1), (B,), 0, 1000)``, and ``eps`` f32 of the latents'
    shape, JAX's ``normal(fold_in(rng, 2), ...)``, with ``rng =
    fold_in(PRNGKey(0), step)`` (keys on the host, draws on the latents'
    device: ``models.prng``)."""
    key = rng.fold_in(rng.prng_key(0), int(step))
    dev = latents.device
    t = prng.randint(rng.fold_in(key, 1), (latents.shape[0],), 0, 1000, dev)
    eps = prng.normal(rng.fold_in(key, 2), latents.shape, dev)
    return t, eps


def noised_latents(batch: Dict[str, Any]):
    """``(t, eps, sqrt(a) lat + sqrt(1 - a) eps)`` of a train batch, its
    latents ``lat`` in f32, ``a = ddpm_alphas()[t]``: the forward process
    both diffusion losses apply."""
    lat = batch["latents"].float()
    t, eps = diffusion_noise(batch["step"], lat)
    a = ddpm_alphas().to(lat.device)[t][:, None, None, None]
    return t, eps, torch.sqrt(a) * lat + torch.sqrt(1 - a) * eps
