"""The post-LN transformer decoder of the stage-2 denoiser (port of
egoego_release_tpu/models/transformer.py), with the reference's torch
module names so its ``state_dict`` keys are the released checkpoint's.

Semantics: post-LN blocks (eps 1e-5); a Conv1d(k=1) input stem; a frozen
sinusoid table with a zero row 0, read at 1-based positions; FFN hidden
width = d_model; the padding mask multiplies the layer outputs only, and
attention leaves padded keys visible (full attention). Inputs are
feature-last, (B, T, C).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from egoego_release_tpu_torch.ops.fused_layer import decoder_layer_plain, layer_params


def sinusoid_position_table(n_position: int, d_hid: int, padding_idx: int | None = 0) -> np.ndarray:
    """angle = pos / 10000^(2 (i // 2) / d): sin on even dims, cos on odd,
    computed in float64, zero row at ``padding_idx``, returned float32."""
    position = np.arange(n_position)[:, None].astype(np.float64)
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(10000.0, 2.0 * (hid // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table.astype(np.float32)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_q = nn.Linear(d_model, n_head * d_k)
        self.w_k = nn.Linear(d_model, n_head * d_k)
        self.w_v = nn.Linear(d_model, n_head * d_v)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int):
        super().__init__()
        self.w_1 = nn.Conv1d(d_in, d_hid, 1)
        self.w_2 = nn.Conv1d(d_hid, d_in, 1)
        self.layer_norm = nn.LayerNorm(d_in, eps=1e-5)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(n_head, d_model, d_k, d_v)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_model)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, d_model), padding_mask (B, T), 1 = real; f32 compute."""
        sa = self.self_attn
        return decoder_layer_plain(x, padding_mask, layer_params(self, bf16=False),
                                   n_head=sa.n_head, d_k=sa.d_k, d_v=sa.d_v)


class Decoder(nn.Module):
    def __init__(self, d_feats: int, d_model: int, n_layers: int, n_head: int,
                 d_k: int, d_v: int, max_timesteps: int):
        super().__init__()
        self.start_conv = nn.Conv1d(d_feats, d_model, 1)
        self.layer_stack = nn.ModuleList(
            [DecoderLayer(d_model, n_head, d_k, d_v) for _ in range(n_layers)])
        self.register_buffer(
            "position_table",
            torch.from_numpy(sinusoid_position_table(max_timesteps + 1, d_model)),
            persistent=False)

    def forward(self, decoder_input: torch.Tensor, padding_mask: torch.Tensor,
                obj_embedding: torch.Tensor | None = None) -> torch.Tensor:
        """decoder_input (B, T, d_feats); padding_mask (B, T_total), 1 = real;
        obj_embedding (B, 1, d_model) is prepended as token 0."""
        x = F.linear(decoder_input, self.start_conv.weight[..., 0], self.start_conv.bias)
        if obj_embedding is not None:
            x = torch.cat([obj_embedding, x], dim=1)
        x = x + self.position_table[1: x.shape[1] + 1]
        for layer in self.layer_stack:
            x = layer(x, padding_mask)
        return x
