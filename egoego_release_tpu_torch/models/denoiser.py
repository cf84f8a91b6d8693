"""The stage-2 denoiser (port of egoego_release_tpu/models/denoiser.py):
the Decoder over concat(noisy x, condition), with the diffusion noise level
embedded by a sinusoidal-Fourier MLP and prepended as token 0, whose output
slot is dropped before ``linear_out``."""

from __future__ import annotations

import math

import torch
from torch import nn

from egoego_release_tpu_torch.models.transformer import Decoder


class SinusoidalPosEmb(nn.Module):
    """Noise-level Fourier features: half = dim // 2 frequencies
    exp(-i log(10000) / (half - 1)), then [sin, cos]."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * (-math.log(10000.0) / (half - 1)))
        ang = t.float()[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TransformerDiffusionModel(nn.Module):
    def __init__(self, d_feats: int, d_model: int, n_dec_layers: int, n_head: int,
                 d_k: int, d_v: int, max_timesteps: int, remat: bool = False):
        super().__init__()
        dim = 64
        # time_mlp.1 / time_mlp.3 are the reference's keys; GELU is the exact
        # erf form (torch's default)
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, dim * 4), nn.GELU(), nn.Linear(dim * 4, d_model))
        self.motion_transformer = Decoder(2 * d_feats, d_model, n_dec_layers, n_head, d_k, d_v,
                                          max_timesteps, remat=remat)
        self.linear_out = nn.Linear(d_model, d_feats)

    def forward(self, src: torch.Tensor, noise_t: torch.Tensor,
                padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        """src (B, T, 2 d_feats), noise_t (B,), padding_mask (B, 1, T+1) with
        1 = real. Returns the predicted x0, (B, T, d_feats), f32."""
        bsz, t, _ = src.shape
        emb = self.time_mlp(noise_t)
        if padding_mask is None:
            mask = src.new_ones(bsz, t + 1)
        else:
            mask = padding_mask[:, 0, :].float()
        feat = self.motion_transformer(src, mask, obj_embedding=emb[:, None, :])
        return self.linear_out(feat[:, 1:])


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from an explicit generator (torch's default scheme:
    uniform(+-1/sqrt(fan_in)) for weights and biases, LayerNorm at 1/0)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            for p in (mod.weight, mod.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
