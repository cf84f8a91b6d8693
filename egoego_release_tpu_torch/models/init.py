"""flax's default initializers on the port's modules, drawn from an explicit
``torch.Generator``, for the models that have no released weights
(TrajARNet, VideoRegNet): Linear and convolution kernels LeCun-normal
(truncated at two standard deviations, fan-in scaled, as
``flax.linen.initializers.lecun_normal``), biases zero; GRU and LSTM input
kernels LeCun-normal per gate, recurrent kernels orthogonal per gate, biases
zero (``nn.GRUCell`` / ``nn.OptimizedLSTMCell``). The draws are torch's, not
JAX's: weights for parity come through ``utils.convert``."""

from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    lo, hi = (0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (-2.0, 2.0))
    u = lo + torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo)
    z = torch.erfinv(2 * u - 1) * math.sqrt(2)
    return (z * math.sqrt(1.0 / fan_in) / _TRUNC_STD).float()


def _orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    q, r = torch.linalg.qr(torch.randn(n, n, generator=generator, dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))).float()


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Linear, Conv1d, Conv2d, GRUCell and LSTM of ``model``
    (on the host, then copied to the parameters' device); BatchNorm keeps
    torch's 1 / 0, flax's too."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            w = mod.weight
            w.copy_(_lecun_normal(w.shape, w[0].numel(), generator))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.GRUCell, nn.LSTM)):
            h = mod.hidden_size
            for name, p in mod.named_parameters():
                if name.startswith("bias"):
                    p.zero_()
                elif name.startswith("weight_hh"):
                    p.copy_(torch.cat([_orthogonal(h, generator) for _ in range(p.shape[0] // h)]))
                else:
                    p.copy_(torch.cat([_lecun_normal((h, p.shape[1]), p.shape[1], generator)
                                       for _ in range(p.shape[0] // h)]))
    return model
