"""One post-LN DecoderLayer as a chain of hand-written CUDA kernels.

Port of egoego_release_tpu/ops/fused_layer.py ``_layer_body`` /
``_layer_kernel`` (the TPU kernel that ``fused_step._call_mid_layer``
launches for every middle layer of a denoise step):

    QKV projection -> per-head attention (f32 softmax) -> fc + residual -> LayerNorm (eps 1e-5) x padding mask
    -> Dense-ReLU-Dense + residual -> LayerNorm x padding mask

On the TPU the whole layer was one kernel with its ~5 MB of bf16 weights
resident in VMEM. An H100 SM has 227 KB of shared memory, so on the card
the layer is five launches (csrc/gemm.cu, csrc/attention.cu): the fused
QKV product, attention (``attention_plain`` is its plain version), fc
with the residual + LayerNorm + mask epilogue, w1 with bias + ReLU, and w2
with the residual + LayerNorm + mask epilogue.
The layer is compute-bound at the main path's shapes (~47 GFLOP against
~40 MB), so the products run on the tensor cores in bf16 mode, on the
wgmma kernel, which reads both operands as bf16 in device memory: the
weights as (N, K) and A as the bf16 copy of the layer input and of h0
that their producers write beside the f32 tensor (the stem's and the
LayerNorms' epilogues). The chain hands the (f32, bf16) pair from layer to
layer; a layer called alone makes the copy of its input.

Rounding points in bf16 mode are those of ``_layer_body``: the layer input
is rounded to bf16 for the QKV product, q/k/v after their bias, p before
p v, ctx before fc, h0 before w1 and h1 before w2 (rounding the input or h0
where it is written is the same round-to-nearest as rounding it at the
product). LayerNorm statistics stay f32. ``bf16=False`` is the f32 parity
mode (no TF32 anywhere).

The inter-layer activations are f32, or bf16 with ``act_bf16``: the TPU
kernels' ``adt`` (their out_shape dtype; ``DiffusionConfig.
fused_step_act_bf16``), independent of the compute dtype. Then the layer's
output leaves as bf16 alone (w2's LayerNorm epilogue writes no f32
output), and a layer whose input arrives as bf16 reads it as f32: fc's
residual add promotes it, as ``attn + x`` does in ``_layer_body``. ``h0``
stays f32 (with its bf16 copy in bf16 compute): the TPU kernel keeps it in
VMEM.

Tensor parallel (a layer of a model that ``parallel.mesh.shard_module_``
put on a mesh; ``layer_params`` then carries its tp group): the QKV
product and the attention run this rank's H / tp heads, w1 its 1 / tp of
the hidden units, and fc and w2, whose products are partial sums over the
tp ranks, run as the ``PARTIAL`` GEMM (the bare f32 product), an
all-reduce over the tp group, then ``cuda_kernels.residual_layernorm``
(bias, residual, LayerNorm and mask, with the same outputs as the fused
epilogue), in place of the LayerNorm epilogue, which needs a row's whole
product.

``decoder_layer`` (a middle layer of the step path) and
``fused_decoder_layer`` (every layer of the ``--fused`` denoiser, port of
``fused_decoder_layer`` and ``fused_denoiser_apply``) run the plain
PyTorch version for CPU tensors and the kernels for CUDA tensors; they
never fall back from one to the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops.cuda_kernels import layer_norm_plain  # noqa: F401 (the tests read it here)


def layer_params(layer, bf16: bool) -> dict:
    """Kernel operands of one ``models.transformer.DecoderLayer``: weight
    matrices as (out, in), ``nn.Linear``'s layout (K-major rows for the
    kernels), in the compute dtype (bf16 or f32), q/k/v fused into one
    (H*(2 dk + dv), d_model) product, biases and LayerNorm rows f32; under
    tensor parallelism "tp", the layer's tp group."""
    wdt = torch.bfloat16 if bf16 else torch.float32
    sa, ff = layer.self_attn, layer.pos_ffn
    w = lambda t: t.detach().contiguous().to(wdt)
    f = lambda t: t.detach().float().contiguous()
    if (sa.tp_group is None) != (ff.tp_group is None):
        raise ValueError("a layer's attention and FFN must both be split over tp, or neither")
    return {
        **({} if sa.tp_group is None else {"tp": sa.tp_group}),
        "wqkv": torch.cat([w(sa.w_q.weight), w(sa.w_k.weight), w(sa.w_v.weight)], 0).contiguous(),
        "bqkv": torch.cat([f(sa.w_q.bias), f(sa.w_k.bias), f(sa.w_v.bias)]).contiguous(),
        "wfc": w(sa.fc.weight), "bfc": f(sa.fc.bias),
        "ln1s": f(sa.layer_norm.weight), "ln1b": f(sa.layer_norm.bias),
        "w1": w(ff.w_1.weight[..., 0]), "b1": f(ff.w_1.bias),
        "w2": w(ff.w_2.weight[..., 0]), "b2": f(ff.w_2.bias),
        "ln2s": f(ff.layer_norm.weight), "ln2b": f(ff.layer_norm.bias),
    }


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def linear_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A W^T for w (N, K), with A rounded to W's dtype first, then an f32
    product: the arithmetic of a bf16 tensor-core product with f32
    accumulation (or a plain f32 product in f32 mode)."""
    return a.to(w.dtype).float() @ w.float().t()


def attention_plain(qkv, *, B, T, t_keys, n_head, d_k, d_v, bf16=False):
    """Plain PyTorch version of the attention launch (csrc/attention.cu):
    qkv (B*T, H (2 dk + dv)) packed as q | k | v, head h at columns h d of
    each; ctx (B*T, H*dv) f32 = softmax(q k^T / sqrt(dk)) v per (batch,
    head), keys at or past t_keys at -inf, in f32; ``bf16`` rounds p before
    p v and ctx after it, as ``_layer_body`` does in bf16 mode."""
    rnd = round_bf16 if bf16 else (lambda a: a)
    hk = n_head * d_k
    qkv = qkv.float()
    heads = lambda a, d: a.reshape(B, T, n_head, d).transpose(1, 2)
    q, k, v = heads(qkv[:, :hk], d_k), heads(qkv[:, hk:2 * hk], d_k), heads(qkv[:, 2 * hk:], d_v)
    s = (q @ k.transpose(-1, -2)) * (1.0 / d_k ** 0.5)
    if t_keys < T:
        s[..., t_keys:] = float("-inf")
    p = rnd(torch.softmax(s, dim=-1))
    return rnd((p @ v).transpose(1, 2).reshape(B * T, n_head * d_v))


def local_heads(lp: dict, n_head: int) -> int:
    """The heads this rank computes: all of them, or its 1 / tp under
    tensor parallelism (the width of its QKV product)."""
    return n_head if "tp" not in lp else n_head // dist.get_world_size(lp["tp"])


def add_layer_norm_plain(a, w, b, res, ln_s, ln_b, mask, tp):
    """LN((a W^T + b) + res) * mask, the plain version of a LayerNorm GEMM;
    under tp the partial product a W^T is summed over the group first."""
    p = linear_plain(a, w)
    if tp is not None:
        dist.all_reduce(p, group=tp)
    return ck.residual_layernorm_plain(p, b, res, ln_s, ln_b, mask)


def decoder_layer_plain(h, mask, lp, *, n_head, d_k, d_v, act_bf16=False):
    """Plain PyTorch version of the kernel chain: h (B, T, dm) f32 or bf16,
    mask (B, T) f32. The mask scales output rows only; every token is a
    key. ``act_bf16`` returns the output rounded to a bf16 tensor."""
    bsz, t, dm = h.shape
    bf16 = lp["wqkv"].dtype == torch.bfloat16
    rnd = round_bf16 if bf16 else (lambda a: a)
    x = h.reshape(bsz * t, dm).float()
    qkv = rnd(linear_plain(x, lp["wqkv"]) + lp["bqkv"])
    ctx = attention_plain(qkv, B=bsz, T=t, t_keys=t, n_head=local_heads(lp, n_head), d_k=d_k, d_v=d_v, bf16=bf16)
    m = mask.reshape(bsz * t).float()
    tp = lp.get("tp")
    h0 = add_layer_norm_plain(ctx, lp["wfc"], lp["bfc"], x, lp["ln1s"], lp["ln1b"], m, tp)
    h1 = rnd(torch.relu(linear_plain(h0, lp["w1"]) + lp["b1"]))
    out = add_layer_norm_plain(h1, lp["w2"], lp["b2"], h0, lp["ln2s"], lp["ln2b"], m, tp)
    return out.reshape(bsz, t, dm).to(torch.bfloat16 if act_bf16 else torch.float32)


def add_layer_norm_cuda(a, w, b, res, ln_s, ln_b, mask, out, out_b, tp):
    """A LayerNorm GEMM on the card: the fused epilogue, or under tp the
    PARTIAL product, the all-reduce over the group and residual_layernorm.
    Returns out, or out_b when out is None."""
    m_rows = a.shape[0]
    if tp is None:
        return ck.gemm(ck.LAYER_NORM, a, w, b, out, M=m_rows, res=res, ln_s=ln_s, ln_b=ln_b, row_mask=mask,
                       out_b=out_b)
    p = torch.empty(m_rows, b.numel(), dtype=torch.float32, device=a.device)
    ck.gemm(ck.PARTIAL, a, w, b, p, M=m_rows)
    dist.all_reduce(p, group=tp)
    return ck.residual_layernorm(p, b, res, ln_s, ln_b, mask, out, out_b)


def decoder_layer_cuda(h, mask, lp, *, n_head, d_k, d_v, hb=None, with_copy=False, act_bf16=False):
    """The layer as five launches on the card; same contract as the plain
    version, and returns (out, its bf16 copy or None). ``mask`` must be a
    contiguous f32 (B, T) tensor. In bf16 mode ``hb`` is h's bf16 copy (made
    here when None) and ``with_copy`` has the last LayerNorm write out's. A
    bf16 ``h`` is its own copy, and fc's LayerNorm reads it as its residual.
    ``act_bf16``: the last LayerNorm writes the bf16 output alone, returned
    as (out, None)."""
    bsz, t, dm = h.shape
    m_rows = bsz * t
    cdt = lp["wqkv"].dtype
    bf16 = cdt == torch.bfloat16
    dev = h.device
    x = h.reshape(m_rows, dm)
    if x.dtype == torch.bfloat16:
        xb = x if bf16 else x.float()  # f32 compute reads A in f32
    else:
        xb = (x.to(torch.bfloat16) if hb is None else hb.reshape(m_rows, dm)) if bf16 else x
    mask = mask.reshape(m_rows)
    tp = lp.get("tp")
    heads = local_heads(lp, n_head)
    copy = lambda: torch.empty(m_rows, dm, dtype=torch.bfloat16, device=dev) if bf16 else None
    qkv = torch.empty(m_rows, lp["wqkv"].shape[0], dtype=cdt, device=dev)
    ck.gemm(ck.BIAS, xb, lp["wqkv"], lp["bqkv"], qkv, M=m_rows)
    ctx = torch.empty(m_rows, heads * d_v, dtype=cdt, device=dev)
    ck.attention(qkv, ctx, B=bsz, T=t, t_keys=t, n_head=heads, d_k=d_k, d_v=d_v)
    h0 = torch.empty(m_rows, dm, dtype=torch.float32, device=dev)
    h0b = copy()
    add_layer_norm_cuda(ctx, lp["wfc"], lp["bfc"], x, lp["ln1s"], lp["ln1b"], mask, h0, h0b, tp)
    h1 = torch.empty(m_rows, lp["w1"].shape[0], dtype=cdt, device=dev)
    ck.gemm(ck.BIAS_RELU, h0 if h0b is None else h0b, lp["w1"], lp["b1"], h1, M=m_rows)
    if act_bf16:
        out = torch.empty(m_rows, dm, dtype=torch.bfloat16, device=dev)
        add_layer_norm_cuda(h1, lp["w2"], lp["b2"], h0, lp["ln2s"], lp["ln2b"], mask, None, out, tp)
        return out.reshape(bsz, t, dm), None
    out = torch.empty(m_rows, dm, dtype=torch.float32, device=dev)
    outb = copy() if with_copy else None
    add_layer_norm_cuda(h1, lp["w2"], lp["b2"], h0, lp["ln2s"], lp["ln2b"], mask, out, outb, tp)
    return out.reshape(bsz, t, dm), None if outb is None else outb.reshape(bsz, t, dm)


def decoder_layer(h, mask, lp, *, n_head, d_k, d_v, hb=None, with_copy=False, act_bf16=False):
    """One DecoderLayer: the kernel chain for CUDA tensors (counted in
    ``cuda_kernels.launch_counts["decoder_layer"]`` once its launches have
    returned), the plain version for CPU tensors. ``hb``, ``with_copy`` and
    ``act_bf16`` are ``decoder_layer_cuda``'s (the step chain's bf16
    copies, its bf16 activations); with_copy returns (out, its bf16 copy or
    None) instead of out."""
    if h.is_cuda or ck.tracing():
        out = decoder_layer_cuda(h, mask, lp, n_head=n_head, d_k=d_k, d_v=d_v, hb=hb, with_copy=with_copy,
                                 act_bf16=act_bf16)
        ck.count("decoder_layer")
    else:
        out = decoder_layer_plain(h, mask, lp, n_head=n_head, d_k=d_k, d_v=d_v, act_bf16=act_bf16), None
    return out if with_copy else out[0]


def fused_decoder_layer(x, padding_mask, lp, *, n_head, d_k, d_v, hb=None, with_copy=False):
    """One DecoderLayer of the ``--fused`` denoiser (port of
    egoego_release_tpu/ops/fused_layer.py ``fused_decoder_layer``): x (B, T,
    d_model) f32, padding_mask (B, T) f32, ``lp`` from ``layer_params`` (bf16
    or f32 compute). The kernel chain of ``decoder_layer`` for CUDA tensors,
    counted in ``cuda_kernels.launch_counts["fused_decoder_layer"]``, the
    plain version for CPU tensors; ``hb`` and ``with_copy`` as there.

    The TPU wrapper pads T to 128 and B to its batch tile, masks the padded
    keys to -inf and slices the padded rows off. Here the attention kernel
    is told the key count T itself (``t_keys = T``), so there are no padded
    keys to mask, and there are no padded rows; padding-mask zeros inside T
    stay visible keys on both. The result is the same function of the real
    tokens."""
    if x.is_cuda or ck.tracing():
        out = decoder_layer_cuda(x, padding_mask, lp, n_head=n_head, d_k=d_k, d_v=d_v, hb=hb, with_copy=with_copy)
        ck.count("fused_decoder_layer")
    else:
        out = decoder_layer_plain(x, padding_mask, lp, n_head=n_head, d_k=d_k, d_v=d_v), None
    return out if with_copy else out[0]


def fused_denoiser_apply(model, src, noise_t, padding_mask, cfg, layers=None, bf16: bool = True):
    """The denoiser forward (models/denoiser.py semantics) with every layer
    through ``fused_decoder_layer`` (port of ``fused_denoiser_apply``).
    src (B, T, 2 d_feats), noise_t (B,), padding_mask (B, 1, T+1) or None;
    returns x0 (B, T, d_feats) f32. ``layers`` are the per-layer operands
    (``layer_params``), prepared here when None. The layers compute in bf16
    by default, as the JAX ``--fused`` path does whatever the configured
    compute dtype (its default ``compute_dtype=jnp.bfloat16``);
    ``bf16=False`` is the f32 parity mode. The noise-level MLP (exact-erf
    GELU), the stem, the position rows 1..T+1 of a ``cfg.window + 2`` row
    table and ``linear_out`` stay plain f32 PyTorch, as they stay jnp."""
    mt = model.motion_transformer
    if layers is None:
        layers = [layer_params(layer, bf16) for layer in mt.layer_stack]
    bsz, t, _ = src.shape
    emb = model.time_mlp(noise_t).float()
    x = F.linear(src.float(), mt.start_conv.weight[..., 0], mt.start_conv.bias)
    x = torch.cat([emb[:, None, :], x], dim=1)
    if mt.position_table.shape[0] != cfg.window + 2:
        raise ValueError(f"position table has {mt.position_table.shape[0]} rows, want window + 2")
    x = (x + mt.position_table[1: t + 2]).contiguous()
    if padding_mask is None:
        mask = x.new_ones(bsz, t + 1)
    else:
        mask = padding_mask[:, 0, :].float().contiguous()
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    xb = None
    for lp in layers[:-1]:
        x, xb = fused_decoder_layer(x, mask, lp, hb=xb, with_copy=True, **kw)
    x = fused_decoder_layer(x, mask, layers[-1], hb=xb, **kw)
    return F.linear(x[:, 1:], model.linear_out.weight, model.linear_out.bias)
