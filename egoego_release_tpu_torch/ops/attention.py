"""Unmasked multi-head attention for long sequences (port of
egoego_release_tpu/ops/attention.py ``fused_attention`` / ``_mha_kernel``).

    out = softmax(q k^T / sqrt(d_k)) v   per (batch, head), softmax in f32

Layout: the JAX package's, q and k (B, H, T, d_k) and v (B, H, T, d_v),
with any strides over (B, H, T) and unit stride over the head width. So
``models.transformer.MultiHeadAttention`` hands over its ``w_q``/``w_k``/
``w_v`` products as (B, T, H, d) views transposed to (B, H, T, d), without
a copy, and gets the output as a (B, H, T, d_v) view of a (B, T, H, d_v)
buffer, which flattens to (B, T, H d_v) for ``fc`` without a copy either.

``fused_attention`` launches the hand-written kernel (csrc/mha.cu: f32 in
and out, both products on the tensor cores as three TF32 products each,
which keeps f32 accuracy; K/V streamed with an online softmax) for CUDA
tensors and runs ``fused_attention_plain`` for CPU tensors; it never falls
back from one to the other. The TPU wrapper pads T to 128 and masks the
padded keys; the card kernel masks keys at or past T itself, so nothing is
padded.
"""

from __future__ import annotations

import torch

from egoego_release_tpu_torch.ops import cuda_kernels as ck


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: scores scaled by 1/sqrt(d_k), softmax in f32,
    output in q's dtype."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    p = torch.softmax(s.float(), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def fused_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, h, t, _ = q.shape
    dv = v.shape[-1]
    # (B, H, T, d_v) over a (B, T, H, d_v) buffer
    out = torch.empty_strided((b, h, t, dv), (t * h * dv, dv, h * dv, 1), dtype=torch.float32, device=q.device)
    return ck.mha(q, k, v, out, t_keys=t)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k (B, H, T, d_k); v (B, H, T, d_v) -> (B, H, T, d_v). The kernel
    for CUDA tensors (f32; counted in ``cuda_kernels.launch_counts
    ["fused_attention"]`` once it has launched), the plain version for CPU
    tensors."""
    if q.is_cuda:
        out = fused_attention_cuda(q, k, v)
        ck.launch_counts["fused_attention"] += 1
        return out
    return fused_attention_plain(q, k, v)
