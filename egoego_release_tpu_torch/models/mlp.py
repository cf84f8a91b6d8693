"""Plain MLP head (port of egoego_release_tpu/models/mlp.py), with the
reference's ``affine_layers.{i}`` keys."""

from __future__ import annotations

import torch
from torch import nn

_ACT = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: tuple[int, ...], activation: str = "relu"):
        super().__init__()
        self.activation = _ACT[activation]
        dims = (input_dim, *hidden_dims)
        self.affine_layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.out_dim = dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for affine in self.affine_layers:
            x = self.activation(affine(x))
        return x
