"""The f32 route on the tensor cores, on the CPU (the kernels themselves run
in tests/test_torch_cuda.py on the card):

- the 3xTF32 products of csrc/gemm.cu gemm_tf32x3_kernel, emulated here the
  way the kernel does them (A and W split on the bits into hi + lo, the
  tensor core reading lo truncated to TF32, three products into f32), at
  each f32 product of the step, against float64 and against the f32
  products of JAX's ``_layer_body``; one TF32 pass misses 1e-4 at K = 1024,
  which is why the kernel runs three; and a model of the tensor cores'
  truncating accumulation, which is why the kernel adds each k-tile's
  products into its accumulator on the CUDA cores;
- the split weights of the f32 step parameters;
- the f32 attention's route onto csrc/mha.cu, the views of the packed qkv
  that it hands mha, and the layouts it refuses;
- ``attention_plain`` against mha's plain version on the same packed qkv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.ops import fused_layer as jfl
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_layer as tfl
from egoego_release_tpu_torch.ops import fused_step as tfs

TOL_F32 = 1e-4   # the f32 kernels against their plain versions
TOL_3X = 1e-5    # the emulated 3xTF32 product against float64 and JAX's f32 product
ROWS = 16        # a small M: the error of a product does not depend on it
TF32_MASK = -0x2000  # the 13 low mantissa bits an f32 has beyond TF32's 10

# (K, N) of each f32 product of the step at the release widths: QKV, fc, w1
# and w2, the stem (2 x 198 padded to 400), the update (N 198), and the tp
# shards (QKV and w1 at tp 2 and 4, fc's and w2's K slices)
PRODUCTS = {"qkv": (512, 3072), "fc": (1024, 512), "w1": (512, 512), "w2": (512, 512), "stem": (400, 512),
            "step": (512, 198), "qkv tp2": (512, 1536), "w1 tp4": (512, 128), "fc tp2": (512, 512),
            "fc tp4": (256, 512), "w2 tp2": (256, 512), "w2 tp4": (128, 512)}


def _truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads an f32 operand in TF32: its 13 low
    mantissa bits dropped."""
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def _emulated_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A W^T as gemm_tf32x3_kernel computes it: A split in registers and W
    split once (both by split_tf32's bit rounding), lo read truncated, and
    Alo Whi + Ahi Wlo + Ahi Whi summed in f32. Each TF32 x TF32 product is
    exact in f32 (11 + 11 significant bits), so an f32 matmul of TF32
    values is the tensor core's arithmetic up to the order of its sums."""
    (ah, al), (wh, wl) = ck.split_tf32(a), ck.split_tf32(w)
    al, wl = _truncate_tf32(al), _truncate_tf32(wl)
    return al @ wh.t() + ah @ wl.t() + ah @ wh.t()


def _one_tf32_pass(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A W^T from one TF32 product of the rounded operands."""
    return ck.split_tf32(a)[0] @ ck.split_tf32(w)[0].t()


def _operands(k: int, n: int, seed: int):
    """A like a LayerNorm output, W as nn.Linear initializes it."""
    rng = np.random.RandomState(seed)
    a = rng.randn(ROWS, k).astype(np.float32)
    w = rng.uniform(-1, 1, (n, k)).astype(np.float32) / np.sqrt(k, dtype=np.float32)
    return a, w


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_3xtf32_product_is_f32_accurate(name):
    """The emulated 3xTF32 product at each f32 product's (K, N) within 1e-5
    of float64 and of JAX _layer_body's f32 product (its ``dot`` with
    preferred_element_type f32 on f32 operands)."""
    k, n = PRODUCTS[name]
    a, w = _operands(k, n, seed=k + n)
    got = _emulated_3xtf32(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    want64 = a.astype(np.float64) @ w.astype(np.float64).T
    dot = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(w.T), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got, want64, atol=TOL_3X, rtol=0)
    np.testing.assert_allclose(got, np.asarray(dot), atol=TOL_3X, rtol=0)


def test_one_tf32_pass_misses_the_f32_bound():
    """One TF32 pass at fc's K = 1024 errs past 1e-4 against float64 (the
    check has teeth), where 3xTF32 stays under 1e-5."""
    a, w = _operands(1024, 512, seed=3)
    want64 = a.astype(np.float64) @ w.astype(np.float64).T
    one = _one_tf32_pass(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    three = _emulated_3xtf32(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    assert np.abs(one - want64).max() > TOL_F32
    assert np.abs(three - want64).max() < TOL_3X


def _truncating_sum(terms, promote_every=None) -> torch.Tensor:
    """The sum of the (rows, n) f32 terms in order as a tensor core adds them
    into its f32 accumulator: each add rounded toward zero. With
    ``promote_every`` the terms go into a zeroed chunk that is added into an
    f32 accumulator rounding to nearest after every that many terms, as
    gemm_tf32x3_kernel does once a k-tile (six products)."""
    def add_rz(acc, term):
        exact = acc.double() + term.double()
        near = exact.float()
        over = near.double().abs() > exact.abs()
        return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near)
    acc = torch.zeros_like(terms[0])
    part = torch.zeros_like(terms[0])
    for i, term in enumerate(terms):
        if promote_every is None:
            acc = add_rz(acc, term)
            continue
        part = add_rz(part, term)
        if (i + 1) % promote_every == 0:
            acc, part = acc + part, torch.zeros_like(part)
    return acc + part if promote_every is not None else acc


@pytest.mark.parametrize("k", [512, 1024])
def test_promotion_bounds_the_tensor_cores_truncating_sums(k):
    """A model of why the kernel promotes: the 3xTF32 products of a row (each
    exact in f32) summed with every add rounded toward zero, as the tensor
    cores accumulate, drift from float64 by several times the error of the
    same sums promoted into a round-to-nearest f32 accumulator once a k-tile
    (16 of K: six products of k8), which stays within 1e-5."""
    a, w = _operands(k, 512, seed=k)
    (ah, al), (wh, wl) = ck.split_tf32(torch.from_numpy(a)), ck.split_tf32(torch.from_numpy(w))
    al, wl = _truncate_tf32(al), _truncate_tf32(wl)
    terms = []
    for k0 in range(0, k, 8):  # one k8 step: the small terms first, as the kernel issues them
        sl = slice(k0, k0 + 8)
        terms += [al[:, sl] @ wh[:, sl].t(), ah[:, sl] @ wl[:, sl].t(), ah[:, sl] @ wh[:, sl].t()]
    want64 = a.astype(np.float64) @ w.astype(np.float64).T
    err = lambda x: float(np.abs(x.double().numpy() - want64).max())
    whole, promoted = err(_truncating_sum(terms)), err(_truncating_sum(terms, promote_every=6))
    assert promoted < TOL_3X and whole > 3 * promoted


def test_split_tf32_is_the_kernels_bit_rounding():
    """split_tf32: hi is x rounded to 10 mantissa bits (ties away from zero,
    the kernel's (bits + 0x1000) & ~0x1fff), lo = x - hi exactly, so hi +
    lo == x, |lo| <= 2^-11 |x|; and the sign and the binade's edge come
    through (1.99999 rounds up to 2)."""
    x = torch.tensor([1.0, -1.0, 1.9999999, 3.0e-7, -123.456, 0.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12])
    hi, lo = ck.split_tf32(x)
    assert not bool((hi.view(torch.int32) & ~TF32_MASK).any())
    assert torch.equal(hi + lo, x)
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())
    assert hi[2] == 2.0 and hi[6] == 1.0 + 2.0 ** -10 and hi[7] == 1.0


@pytest.fixture(scope="module")
def small_model():
    cfg = DiffusionConfig(d_model=64, n_head=2, d_k=16, d_v=16, n_dec_layers=3, window=24)
    return cfg, CondGaussianDiffusion(cfg, device="cpu", seed=0).model


@pytest.mark.parametrize("bf16", [False, True])
def test_step_params_hold_each_weight_split_in_f32_only(small_model, bf16):
    """The f32 step parameters hold each GEMM weight also as split_tf32(W):
    hi with its 13 low mantissa bits zero, hi + lo rebuilding W within
    2^-21 relative (exactly); the bf16 parameters have no such keys."""
    _, model = small_model
    prep = tfs.prepare_step_params(model, bf16)
    pairs = [(prep, "wst"), (prep, "lw")] + [(lp, k) for lp in prep["layers"] for k in ("wqkv", "wfc", "w1", "w2")]
    for params, name in pairs:
        if bf16:
            assert f"{name}_split" not in params
            assert tfl.kernel_weight(params, name) is params[name]
            continue
        w, split = params[name], params[f"{name}_split"]
        assert split.shape == (2, *w.shape) and split.dtype == torch.float32 and split.is_contiguous()
        assert tfl.kernel_weight(params, name) is split
        assert not bool((split[0].view(torch.int32) & ~TF32_MASK).any()), name
        rebuilt = split[0] + split[1]
        assert bool(((rebuilt - w).abs() <= 2.0 ** -21 * w.abs()).all()), name


def test_gemm_plain_reads_the_split_weight_as_the_weight(small_model):
    """The plain version of an f32 GEMM given W split computes with hi + lo,
    which is W: bit for bit the product with W itself."""
    _, model = small_model
    lp = tfs.prepare_step_params(model, False)["layers"][1]
    a = torch.from_numpy(np.random.RandomState(5).randn(10, 64).astype(np.float32))
    out_split, out_w = torch.empty(10, 96), torch.empty(10, 96)
    ck.gemm_plain(ck.BIAS, a, lp["wqkv_split"], lp["bqkv"], out_split, M=10)
    ck.gemm_plain(ck.BIAS, a, lp["wqkv"], lp["bqkv"], out_w, M=10)
    assert torch.equal(out_split, out_w)


@pytest.mark.parametrize("b,t,d", [(64, 121, 256), (64, 31, 256), (1, 121, 256), (3, 17, 16)])
def test_f32_attention_views_are_what_mha_takes(b, t, d):
    """The f32 attention goes to mha at head widths that are multiples of 4
    up to 256; the views of the packed qkv (B T, H (2 dk + dv)) and of ctx
    that it hands over have strides (T ld, d, ld, 1), which mha's layout
    checks accept."""
    h = 4
    assert ck.attention_route(torch.float32, t, d, d) == "mha"
    qkv, ctx = torch.zeros(b * t, 3 * h * d), torch.zeros(b * t, h * d)
    q, k, v, out = ck.qkv_heads(qkv, ctx, B=b, T=t, n_head=h, d_k=d, d_v=d)
    ld = 3 * h * d
    for x, base in ((q, 0), (k, h * d), (v, 2 * h * d)):
        assert x.shape == (b, h, t, d) and x.stride() == (t * ld, d, ld, 1)
        assert x.data_ptr() == qkv.data_ptr() + 4 * base
    assert out.shape == (b, h, t, d) and out.stride() == (t * h * d, d, h * d, 1)
    args = ck._mha_args(q, k, v, out, t - 1, on_card=False)
    assert (args.q_sb, args.q_sh, args.q_st, args.o_st, args.t_keys) == (t * ld, d, ld, h * d, t - 1)


@pytest.mark.parametrize("change,match", [
    (dict(d=512), "d_v <= 256"),            # no kernel takes heads past 256
    (dict(offset=1), "16-byte aligned"),    # mha reads 16-byte pieces
    (dict(t_keys=0), "t_keys"),
])
def test_f32_attention_refuses_what_no_kernel_takes(change, match):
    """A layout no attention kernel takes raises before the device is
    looked at (nothing falls back); the release layout passes every check,
    and on CPU tensors only the device check is left to raise."""
    b, t, h = 2, 121, 4
    d, off, t_keys = change.get("d", 256), change.get("offset", 0), change.get("t_keys", t)
    flat = torch.zeros(b * t * 3 * h * d + off)
    qkv, ctx = flat[off:].view(b * t, 3 * h * d), torch.zeros(b * t, h * d)
    with pytest.raises(ValueError, match=match):
        ck.attention(qkv, ctx, B=b, T=t, t_keys=t_keys, n_head=h, d_k=d, d_v=d)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        ck.attention(torch.zeros(b * t, 3 * h * 256), torch.zeros(b * t, h * 256), B=b, T=t, t_keys=t, n_head=h,
                     d_k=256, d_v=256)


@pytest.mark.parametrize("b,t,t_keys", [(64, 121, 121), (4, 31, 26), (1, 121, 100), (3, 17, 5)])
def test_attention_plain_is_mha_plain_on_packed_qkv(b, t, t_keys):
    """attention_plain (the layer's f32 attention: keys at or past t_keys
    hidden) and mha's plain version on the views of the same packed qkv
    agree within 1e-6, t_keys < T included."""
    h, d = 4, 32
    rng = np.random.RandomState(b + t + t_keys)
    qkv = torch.from_numpy(rng.randn(b * t, 3 * h * d).astype(np.float32))
    ctx = torch.empty(b * t, h * d)
    q, k, v, _ = ck.qkv_heads(qkv, ctx, B=b, T=t, n_head=h, d_k=d, d_v=d)
    got = ck._mha_plain(q, k, v, t_keys).transpose(1, 2).reshape(b * t, h * d)
    want = ck.attention_plain(qkv, B=b, T=t, t_keys=t_keys, n_head=h, d_k=d, d_v=d)
    assert float((got - want).abs().max()) < 1e-6


def test_layer_body_attention_matches_the_f32_route():
    """A whole f32 layer, JAX's _layer_body against the port's plain layer
    (whose attention_plain is mha's plain version on the packed qkv, above),
    at small widths with a padding-mask zero: the functions the f32 route's
    kernels are held to agree with the reference within 1e-4."""
    cfg = DiffusionConfig(d_model=64, n_head=2, d_k=16, d_v=16, n_dec_layers=3, window=24)
    model = CondGaussianDiffusion(cfg, device="cpu", seed=0).model
    lp = tfl.layer_params(model.motion_transformer.layer_stack[1], bf16=False)
    rng = np.random.RandomState(2)
    b, t = 3, 25
    x = rng.randn(b, t, 64).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, -3] = 0.0
    hk = 2 * 16
    wq, wk, wv = (lp["wqkv"][i * hk:(i + 1) * hk].t().numpy() for i in range(3))
    bq, bk, bv = (lp["bqkv"][i * hk:(i + 1) * hk].numpy()[None] for i in range(3))
    row = lambda name: lp[name].numpy()[None]
    want = jfl._layer_body(
        jnp.asarray(x), jnp.asarray(mask.reshape(b * t, 1)), wq, bq, wk, bk, wv, bv,
        lp["wfc"].t().numpy(), row("bfc"), row("ln1s"), row("ln1b"), lp["w1"].t().numpy(), row("b1"),
        lp["w2"].t().numpy(), row("b2"), row("ln2s"), row("ln2b"),
        n_head=2, d_k=16, d_v=16, t_real=t, scale=1.0 / 16 ** 0.5, cdt=jnp.float32)
    got = tfl.decoder_layer_plain(torch.from_numpy(x), torch.from_numpy(mask), lp, n_head=2, d_k=16, d_v=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=0)
