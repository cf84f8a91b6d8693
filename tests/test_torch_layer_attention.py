"""The denoiser layer's attention launch (csrc/attention.cu) as its plain
version ``cuda_kernels.attention_plain`` computes it, against the JAX
package on the CPU, and the wrapper's choice of kernel.

``attention_plain`` takes the packed qkv (B*T, H (2 dk + dv)) that the QKV
GEMM writes. In f32 mode it is held against
``egoego_release_tpu/ops/attention.py`` ``reference_attention`` on q, k, v
split from one numpy qkv, at 2e-5 (the JAX package's own tolerance for
attention): over all T keys, and with t_keys < T over the first t_keys. In
bf16 mode it keeps ``_layer_body``'s rounding points (p and ctx rounded to
bf16), held against the same lines in jnp with bf16 q, k, v at 2e-2 (a
bf16 ulp of O(1) values where the two sum in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax import nn as jnn

import egoego_release_tpu.ops.attention as jattn
from egoego_release_tpu_torch.ops import cuda_kernels as ck

ATOL_ATTN = 2e-5
TOL_BF16 = 2e-2


def _qkv(b, t, h, dk, dv, seed):
    """One numpy qkv (B*T, H (2 dk + dv)) from a seed, and its q, k, v as
    (B, H, T, d) arrays."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b * t, h * (2 * dk + dv)).astype(np.float32)
    split = lambda a, d: np.ascontiguousarray(a.reshape(b, t, h, d).transpose(0, 2, 1, 3))
    hk = h * dk
    return qkv, split(qkv[:, :hk], dk), split(qkv[:, hk:2 * hk], dk), split(qkv[:, 2 * hk:], dv)


@pytest.mark.parametrize("b,t,h,dk,dv,t_keys", [
    (2, 7, 2, 16, 24, 7), (2, 7, 2, 16, 24, 3), (3, 41, 4, 32, 32, 41), (3, 41, 4, 32, 32, 17),
    (1, 121, 2, 64, 64, 121), (1, 121, 2, 64, 64, 65), (2, 31, 2, 64, 48, 1), (1, 130, 1, 32, 32, 129)])
def test_attention_plain_matches_jax_reference(b, t, h, dk, dv, t_keys):
    """f32 mode against reference_attention over the first t_keys keys."""
    qkv, q, k, v = _qkv(b, t, h, dk, dv, seed=t + t_keys)
    ours = ck.attention_plain(torch.from_numpy(qkv), B=b, T=t, t_keys=t_keys, n_head=h, d_k=dk, d_v=dv)
    want = np.asarray(jattn.reference_attention(jnp.asarray(q), jnp.asarray(k[:, :, :t_keys]),
                                                jnp.asarray(v[:, :, :t_keys])))
    assert ours.shape == (b * t, h * dv) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), want.transpose(0, 2, 1, 3).reshape(b * t, h * dv),
                               atol=ATOL_ATTN, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_attention_plain_ignores_keys_past_t_keys(bf16):
    """Keys at or past t_keys get no weight: their k and v rows can hold
    anything finite and ctx does not change by a bit."""
    b, t, h, d, t_keys = 2, 33, 2, 32, 20
    qkv, *_ = _qkv(b, t, h, d, d, seed=5)
    other = qkv.reshape(b, t, -1).copy()
    other[:, t_keys:, h * d:] = 1e3 * np.random.RandomState(6).randn(b, t - t_keys, 2 * h * d)
    kw = dict(B=b, T=t, t_keys=t_keys, n_head=h, d_k=d, d_v=d, bf16=bf16)
    base = ck.attention_plain(torch.from_numpy(qkv), **kw)
    moved = ck.attention_plain(torch.from_numpy(other.reshape(b * t, -1)), **kw)
    assert torch.equal(base, moved)


@pytest.mark.parametrize("b,t,h,d", [(2, 31, 2, 32), (1, 121, 2, 64)])
def test_attention_plain_bf16_keeps_layer_body_rounding(b, t, h, d):
    """bf16 mode against _layer_body's attention lines in jnp (bf16 q, k,
    v; f32 scores and softmax; p and ctx cast to bf16); every ctx value is
    a bf16 value."""
    qkv, q, k, v = _qkv(b, t, h, d, d, seed=t)
    qkv_b = torch.from_numpy(qkv).to(torch.bfloat16).float()
    ours = ck.attention_plain(qkv_b, B=b, T=t, t_keys=t, n_head=h, d_k=d, d_v=d, bf16=True)
    cdt = jnp.bfloat16
    qj, kj, vj = (jnp.asarray(a).astype(cdt) for a in (q, k, v))
    s = lax.dot_general(qj, kj, (((3,), (3,)), ((0, 1), (0, 1))), preferred_element_type=jnp.float32) * (1.0 / d ** 0.5)
    p = jnn.softmax(s, axis=-1).astype(cdt)
    ctx = lax.dot_general(p, vj, (((3,), (2,)), ((0, 1), (0, 1))), preferred_element_type=jnp.float32).astype(cdt)
    want = np.asarray(ctx.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(b * t, h * d)
    np.testing.assert_allclose(ours.numpy(), want, atol=TOL_BF16, rtol=0)
    assert torch.equal(ours, ck.round_bf16(ours))


@pytest.mark.parametrize("dtype,t,d_k,d_v,kernel", [
    (torch.bfloat16, 121, 256, 256, "attention_wgmma"), (torch.bfloat16, 31, 256, 256, "attention_wgmma"),
    (torch.bfloat16, 128, 256, 256, "attention_wgmma"), (torch.bfloat16, 129, 256, 256, "attention_wmma"),
    (torch.float32, 121, 256, 256, "mha"), (torch.float32, 31, 16, 16, "mha"), (torch.float32, 121, 18, 18, "attention"),
    (torch.float32, 121, 512, 512, "attention"), (torch.bfloat16, 121, 32, 32, "attention"),
    (torch.bfloat16, 121, 256, 128, "attention")])
def test_attention_route(dtype, t, d_k, d_v, kernel):
    """bf16 at head width 256 takes the wgmma kernel up to 128 tokens (the
    release window's 121 and its 31-token tail), the WMMA kernel past that;
    f32 mode the 3xTF32 mha kernel at the head widths it takes (multiples of
    4 up to 256), the CUDA-core kernel at other widths, as bf16 does."""
    assert ck.attention_route(dtype, t, d_k, d_v) == kernel
    assert kernel == "mha" or kernel in ck.ATTENTION_KERNELS


@pytest.mark.parametrize("tool,source", [("attention_variants", "attention"), ("gemm_variants", "gemm")])
def test_variant_anchors_are_in_the_sources(tool, source):
    """Every edit of the variants tools (tools/*_variants.py) is anchored on
    a piece of its CUDA source that occurs exactly once, so the tools build
    what they name on the card."""
    import importlib

    variants = importlib.import_module(f"egoego_release_tpu_torch.tools.{tool}").VARIANTS
    text = (ck.CSRC / f"{source}.cu").read_text()
    for name, edits in variants.items():
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)


def test_corrected_reciprocal_quotient_is_the_ieee_quotient():
    """attention_wgmma_kernel's p = e / sum: q = e y with y the correctly
    rounded 1 / sum, then twice q = fma(fma(-q, sum, e), y, q). In float32
    (each fma a float64 sum rounded once to float32) it is the IEEE
    quotient e / sum over a million (e, sum) pairs of the softmax's range:
    e in (2^-40, 1], sum in [1, 128]."""
    f32, f64 = np.float32, np.float64
    fma = lambda a, b, c: (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(f32)
    rng = np.random.RandomState(0)
    n = 1_000_000
    e = (rng.uniform(0, 1, n) * 2.0 ** -rng.randint(0, 40, n)).astype(f32)
    e[e == 0] = 1
    total = rng.uniform(1, 128, n).astype(f32)
    y = f32(1) / total
    q = e * y
    for _ in range(2):
        q = fma(fma(-q, total, e), y, q)
    assert np.array_equal(q, e / total)
