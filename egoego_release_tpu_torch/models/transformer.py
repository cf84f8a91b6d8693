"""The post-LN transformer decoder shared by the stage-2 denoiser and the
stage-1 HeadFormer and GravityNet (port of
egoego_release_tpu/models/transformer.py), with the reference's torch
module names so its ``state_dict`` keys are the released checkpoints'.

Semantics: post-LN blocks (eps 1e-5, statistics in f32); a Conv1d(k=1)
input stem; a frozen sinusoid table with a zero row 0, read at 1-based
positions; FFN hidden width = d_model; the padding mask multiplies the
block outputs only, and with full attention padded tokens stay visible
keys; ``use_full_attention=False`` masks every later key (upper-triangular
time mask). Inputs are feature-last, (B, T, C); compute is f32.

Attention routing is the JAX package's ``attention_impl="auto"`` rule with
the card in the TPU's place: 256 or more query tokens and no mask go to
``ops.attention.fused_attention`` (the hand-written kernel on CUDA tensors,
its plain version on CPU tensors); everything else runs the einsum path.
The stage-2 step path (ops/fused_step.py) does not use these forwards.

Training (as the flax modules): dropout at rate 0.1 on the attention
probabilities, after ``fc`` and after ``w_2``, active only in ``train()``
mode. The dropout modules are built in eval mode, as flax defaults to
``deterministic=True``, so a module nobody put in ``train()`` computes
exactly as before; ``model.train()`` turns them on. In train mode with
dropout, attention never goes to ``fused_attention``, which has no
backward (the JAX guard at egoego_release_tpu/models/transformer.py:95-97).
``Decoder(remat=True)`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, which replays the RNG state, so the dropout
masks of the recompute are the forward's).

Tensor parallel (``parallel.mesh.shard_module_``): an attention or FFN with
a ``tp_group`` holds this rank's column shards of w_q/w_k/w_v (its heads)
or w_1 and the row shards of fc or w_2; the row-parallel product is summed
over the group before its bias, which is added once (``row_parallel``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from egoego_release_tpu_torch.ops.attention import fused_attention
from egoego_release_tpu_torch.parallel.mesh import copy_to_tp, row_parallel

LN_EPS = 1e-5
DROPOUT_RATE = 0.1  # egoego_release_tpu/models/transformer.py:69,134
# query tokens from which an unmasked attention goes to the fused kernel
# (egoego_release_tpu/models/transformer.py:93)
FUSED_ATTENTION_MIN_TOKENS = 256


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


def _dropout(p: float) -> nn.Dropout:
    """Off until the owning model is put in ``train()`` mode."""
    return nn.Dropout(p).eval()


def set_dropout_rate(model: nn.Module, p: float) -> nn.Module:
    """Set the rate of every dropout in ``model`` (0 = train mode computes
    exactly as eval mode)."""
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = p
    return model


def _post_ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, LN_EPS)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_q = nn.Linear(d_model, n_head * d_k)
        self.w_k = nn.Linear(d_model, n_head * d_k)
        self.w_v = nn.Linear(d_model, n_head * d_v)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn_dropout = _dropout(DROPOUT_RATE)
        self.dropout = _dropout(DROPOUT_RATE)
        self.tp_group = None

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """q, k, v (B, T, d_model); mask (B, Tq, Tk) bool, True = masked out.
        Returns LayerNorm(fc(attention) + q), (B, Tq, d_model)."""
        bs, n_q, _ = q.shape
        n_k = k.shape[1]
        h = self.n_head
        tp = self.tp_group
        qi, ki, vi = (q, k, v) if tp is None else (copy_to_tp(t, tp) for t in (q, k, v))
        wq = self.w_q(qi).view(bs, n_q, h, self.d_k).transpose(1, 2)
        wk = self.w_k(ki).view(bs, n_k, h, self.d_k).transpose(1, 2)
        wv = self.w_v(vi).view(bs, n_k, h, self.d_v).transpose(1, 2)
        dropout_on = self.attn_dropout.training and self.attn_dropout.p > 0
        if mask is None and n_q >= FUSED_ATTENTION_MIN_TOKENS and not dropout_on:
            out = fused_attention(wq, wk, wv)
        else:
            attn = torch.matmul(wq, wk.transpose(-1, -2)) / np.sqrt(self.d_k)
            if mask is not None:
                attn = attn.masked_fill(mask[:, None], float("-inf"))
            out = torch.matmul(self.attn_dropout(torch.softmax(attn.float(), dim=-1)), wv)
        out = row_parallel(out.transpose(1, 2).reshape(bs, n_q, h * self.d_v), self.fc.weight, self.fc.bias, tp)
        return _post_ln(self.layer_norm, self.dropout(out) + q)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int):
        super().__init__()
        self.w_1 = nn.Conv1d(d_in, d_hid, 1)
        self.w_2 = nn.Conv1d(d_hid, d_in, 1)
        self.layer_norm = nn.LayerNorm(d_in, eps=LN_EPS)
        self.dropout = _dropout(DROPOUT_RATE)
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Dense-ReLU-Dense over the features of x (B, T, d_in), post-LN."""
        xi = x if self.tp_group is None else copy_to_tp(x, self.tp_group)
        out = row_parallel(torch.relu(F.linear(xi, self.w_1.weight[..., 0], self.w_1.bias)),
                           self.w_2.weight[..., 0], self.w_2.bias, self.tp_group)
        return _post_ln(self.layer_norm, self.dropout(out) + x)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(n_head, d_model, d_k, d_v)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_model)

    def forward(self, x: torch.Tensor, time_mask: torch.Tensor | None,
                padding_mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, d_model); time_mask (B, T, T) bool or None; padding_mask
        (B, T), 1 = real, multiplies each block's output."""
        m = padding_mask[..., None].to(x.dtype)
        out = self.self_attn(x, x, x, mask=time_mask) * m
        return self.pos_ffn(out) * m


class Decoder(nn.Module):
    def __init__(self, d_feats: int, d_model: int, n_layers: int, n_head: int,
                 d_k: int, d_v: int, max_timesteps: int, use_full_attention: bool = True,
                 remat: bool = False):
        super().__init__()
        self.use_full_attention = use_full_attention
        self.remat = remat
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
        obj_embedding (B, 1, d_model) is prepended as token 0. Token i reads
        position row i + 1."""
        x = F.linear(decoder_input, self.start_conv.weight[..., 0], self.start_conv.bias)
        if obj_embedding is not None:
            x = torch.cat([obj_embedding, x], dim=1)
        bs, t_total = x.shape[:2]
        time_mask = None
        if not self.use_full_attention:
            time_mask = torch.ones(t_total, t_total, dtype=torch.bool, device=x.device).triu(1)
            time_mask = time_mask[None].expand(bs, -1, -1)
        x = x + self.position_table[1: t_total + 1]
        for layer in self.layer_stack:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, time_mask, padding_mask, use_reentrant=False)
            else:
                x = layer(x, time_mask, padding_mask)
        return x
