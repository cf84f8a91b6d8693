"""DDPM beta schedules and derived constants (port of
egoego_release_tpu/diffusion/schedule.py): float64 numpy math, float32
results, as the reference registers its buffers."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


class DiffusionConstants(NamedTuple):
    """float32 numpy arrays: the sampler reads its scalars on the host."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    p2_loss_weight: np.ndarray


def make_diffusion_constants(timesteps: int = 1000, beta_schedule: str = "cosine",
                             p2_loss_weight_gamma: float = 0.0, p2_loss_weight_k: float = 1.0) -> DiffusionConstants:
    if beta_schedule == "linear":
        betas = linear_beta_schedule(timesteps)
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return DiffusionConstants(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_log_variance_clipped=f32(np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        # (k + snr) ** -gamma; the default gamma 0 gives 1 at every t
        p2_loss_weight=f32((p2_loss_weight_k + alphas_cumprod / (1 - alphas_cumprod)) ** -p2_loss_weight_gamma),
    )
