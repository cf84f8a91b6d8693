"""The port's attention, Decoder and fused-layer paths against the JAX
package on the CPU, on the same weights and numpy inputs.

The JAX side runs its Pallas kernels in interpret mode with f32 compute,
as tests/test_attention_kernel.py and tests/test_fused_layer.py do; the
port runs the kernels' plain versions (CPU tensors) in f32. Tolerances are
the JAX package's own for these kernels: 2e-5 for attention and one fused
layer, 5e-5 for a Decoder and the fused denoiser (f32 re-association).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egoego_release_tpu.ops.attention as jattn
from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.models.transformer import Decoder as JDecoder
from egoego_release_tpu.models.transformer import DecoderLayer as JDecoderLayer
from egoego_release_tpu.models.transformer import make_pos_idx
from egoego_release_tpu.ops import fused_layer as jfl
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    new_denoiser,
)
from egoego_release_tpu_torch.models import transformer as ttr
from egoego_release_tpu_torch.ops import attention as tattn
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_layer as tfl
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.utils.convert import _decoder, denoiser_state_dict_from_jax, load_denoiser_weights

ATOL_ATTN = 2e-5
ATOL_STACK = 5e-5


@pytest.mark.parametrize("b,h,t,dk,dv", [(1, 2, 7, 16, 24), (2, 4, 121, 32, 32), (1, 2, 256, 32, 32),
                                         (1, 1, 300, 64, 64)])
def test_fused_attention_plain_matches_jax(b, h, t, dk, dv):
    """The wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode and the einsum oracle, on the (B, T, H, d)
    views transposed to (B, H, T, d) that MultiHeadAttention hands over."""
    rng = np.random.RandomState(t)
    q, k = (rng.randn(b, h, t, dk).astype(np.float32) for _ in range(2))
    v = rng.randn(b, h, t, dv).astype(np.float32)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2) for a in (q, k, v)]
    ck.launch_counts.clear()
    ours = tattn.fused_attention(*views).numpy()
    assert not ck.launch_counts  # CPU tensors never reach a kernel
    kern = np.asarray(jattn.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    oracle = np.asarray(jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert ours.shape == (b, h, t, dv)
    np.testing.assert_allclose(ours, kern, atol=ATOL_ATTN, rtol=0)
    np.testing.assert_allclose(ours, oracle, atol=ATOL_ATTN, rtol=0)


def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """f32 values cut to TF32 (10 mantissa bits) on their int32 view: to
    nearest, ties away from zero (cvt.rna, and csrc/mha.cu's split), or
    truncated (what the tensor core does with an operand's low bits)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000 if nearest else bits) & -0x2000).view(torch.float32)


def _matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a b with TF32 operands and f32 sums: one pass, or csrc/mha.cu's three
    (a = hi + lo, lo truncated by the tensor core; lo hi + hi lo + hi hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.matmul(ah, bh)
    al, bl = _tf32(a - ah, nearest=False), _tf32(b - bh, nearest=False)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_tf32_passes_against_float64(passes, within):
    """The numerical case for the card kernel, held on the CPU: attention at
    (1, 4, 256, 256) with both products in TF32 against a float64
    reference. Three TF32 products per f32 product stay under 1e-5, where
    plain f32 lands; one TF32 pass breaks the 1e-4 the stage-1 path is held
    to."""
    rng = np.random.RandomState(256)
    q, k, v = (torch.from_numpy(rng.randn(1, 4, 256, 256).astype(np.float32)) for _ in range(3))
    s = _matmul_tf32(q, k.transpose(-1, -2), passes) * (1.0 / 256 ** 0.5)
    got = _matmul_tf32(torch.softmax(s, -1), v, passes)
    q64, k64, v64 = q.double(), k.double(), v.double()
    want = torch.matmul(torch.softmax(torch.matmul(q64, k64.transpose(-1, -2)) / 16.0, -1), v64)
    err = float((got.double() - want).abs().max())
    assert (err < 1e-5) if within else (err > 1e-4), err


def _port_decoder(jparams, cfg, use_full_attention):
    sd = {}
    _decoder(sd, "d", jparams["params"])
    dec = ttr.Decoder(cfg["d_feats"], cfg["d_model"], cfg["n_layers"], cfg["n_head"], cfg["d_k"], cfg["d_v"],
                      cfg["max_timesteps"], use_full_attention=use_full_attention)
    return load_denoiser_weights(dec, {k[2:]: v for k, v in sd.items()})


@pytest.mark.parametrize("n_q,full,routed", [(8, True, False), (256, True, True), (12, False, False)])
def test_decoder_matches_flax(monkeypatch, n_q, full, routed):
    """The port's Decoder against the flax Decoder: the einsum path at 8
    tokens, the fused-attention route at 256 (JAX: attention_impl="pallas"
    with the kernel in interpret mode), and the upper-triangular time mask;
    padding-mask zeros multiply the block outputs only."""
    cfg = dict(d_feats=12, d_model=16, n_layers=2, n_head=2, d_k=8, d_v=8, max_timesteps=260)
    rng = np.random.RandomState(n_q)
    x = rng.randn(2, n_q, 12).astype(np.float32)
    pm = np.ones((2, n_q), np.float32)
    pm[1, n_q - 3:] = 0.0
    pos = make_pos_idx(2, n_q)
    orig = jattn.fused_attention
    monkeypatch.setattr(jattn, "fused_attention", lambda q, k, v: orig(q, k, v, interpret=True))
    jdec = JDecoder(**cfg, use_full_attention=full, attention_impl="pallas" if routed else "einsum")
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pm), pos)
    out_j, _ = jdec.apply(params, jnp.asarray(x), jnp.asarray(pm), pos)

    calls = []
    monkeypatch.setattr(ttr, "fused_attention", lambda *a: calls.append(1) or tattn.fused_attention(*a))
    with torch.no_grad():
        out_t = _port_decoder(params, cfg, full)(torch.from_numpy(x), torch.from_numpy(pm))
    assert len(calls) == (cfg["n_layers"] if routed else 0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL_STACK, rtol=0)


def _layer(t, bs, seed):
    d_model, n_head, d_k = 64, 2, 32
    jlayer = JDecoderLayer(d_model=d_model, n_head=n_head, d_k=d_k, d_v=d_k, attention_impl="einsum")
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x = np.array(jax.random.normal(k1, (bs, t, d_model), jnp.float32))
    mask = jnp.ones((bs, t), jnp.float32)
    variables = jlayer.init(k2, jnp.asarray(x), None, mask)
    sd = {}
    _decoder(sd, "d", {"start_conv": {"kernel": np.zeros((1, d_model)), "bias": np.zeros(d_model)},
                       "layer_0": variables["params"]})
    layer = ttr.DecoderLayer(d_model, n_head, d_k, d_k)
    layer.load_state_dict({k[len("d.layer_stack.0."):]: v for k, v in sd.items() if "layer_stack" in k})
    return jlayer, variables, x, layer


@pytest.mark.parametrize("t,bs,masked", [(25, 6, False), (19, 4, True), (130, 3, True)])
def test_fused_decoder_layer_matches_jax(t, bs, masked):
    """fused_decoder_layer (plain on the CPU, f32 mode, no padding) against
    the JAX kernel, which pads T to 128 and B to its tile and masks the
    padded keys; padding-mask zeros inside T stay visible keys on both."""
    jlayer, variables, x, layer = _layer(t, bs, seed=t)
    mask = np.ones((bs, t), np.float32)
    if masked:
        mask[:, t - 4:] = 0.0
    out_j = jfl.fused_decoder_layer(
        jnp.asarray(x), jnp.asarray(mask), jfl.layer_params_from_flax(variables["params"], dtype=jnp.float32),
        n_head=2, d_k=32, d_v=32, batch_tile=4, interpret=True, compute_dtype=jnp.float32)
    ref, _ = jlayer.apply(variables, jnp.asarray(x), None, jnp.asarray(mask))
    lp = tfl.layer_params(layer, bf16=False)
    ck.launch_counts.clear()
    out_t = tfl.fused_decoder_layer(torch.from_numpy(x), torch.from_numpy(mask), lp, n_head=2, d_k=32, d_v=32)
    assert not ck.launch_counts
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL_ATTN, rtol=0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref), atol=ATOL_ATTN, rtol=0)
    with torch.no_grad():  # the module's own forward: same function
        out_m = layer(torch.from_numpy(x), None, torch.from_numpy(mask))
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref), atol=ATOL_ATTN, rtol=0)


SMALL = dict(d_feats=12, d_model=64, n_head=2, n_dec_layers=2, d_k=32, d_v=32, window=24, timesteps=6)


@pytest.fixture(scope="module")
def denoisers():
    jcfg = JConfig(**SMALL)
    jdiff = JDiffusion(jcfg)
    params = jdiff.init_params(jax.random.PRNGKey(2), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)), denoiser_state_dict_from_jax(params))
    return jcfg, jdiff, params, model


@pytest.mark.parametrize("masked", [False, True])
def test_fused_denoiser_apply_matches_jax(denoisers, masked):
    """The --fused denoiser forward in f32 mode against the JAX one in
    interpret mode with f32 compute, and against the flax denoiser."""
    jcfg, jdiff, params, model = denoisers
    rng = np.random.RandomState(4)
    bs = 5
    src = rng.randn(bs, jcfg.window, 2 * jcfg.d_feats).astype(np.float32)
    noise_t = np.arange(bs, dtype=np.int32) * 150
    pm = None
    if masked:
        pm = np.ones((bs, 1, jcfg.window + 1), np.float32)
        pm[:, 0, 12:] = 0.0
    jpm = None if pm is None else jnp.asarray(pm)
    out_j = jfl.fused_denoiser_apply(params, jnp.asarray(src), jnp.asarray(noise_t), jpm, cfg=jcfg, batch_tile=4,
                                     interpret=True, compute_dtype=jnp.float32)
    ref = jdiff.denoiser.apply(params, jnp.asarray(src), jnp.asarray(noise_t), jpm)
    with torch.no_grad():
        out_t = tfl.fused_denoiser_apply(model, torch.from_numpy(src), torch.from_numpy(noise_t),
                                         None if pm is None else torch.from_numpy(pm),
                                         DiffusionConfig(**SMALL), bf16=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL_STACK, rtol=0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref), atol=ATOL_STACK, rtol=0)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_fused_transformer_loop_matches_step_loop(denoisers, sampler):
    """The --fused reverse chain (fused_transformer, f32 layers) against the
    step-kernel chain (held against the JAX samplers in
    test_torch_denoiser.py) on the same weights, noise and inpaint: the
    same update written once per step as a1 x0 + a2 x + a3 noise."""
    *_, model = denoisers
    runs = []
    rng = np.random.RandomState(5)
    x_start = torch.from_numpy(rng.randn(3, 20, 12).astype(np.float32))
    cond = torch.from_numpy((rng.rand(3, 20, 12) > 0.3).astype(np.float32))
    ipv = torch.from_numpy(rng.randn(3, 20, 12).astype(np.float32))
    ipm = torch.zeros(3, 20, 1)
    ipm[:, :4] = 1.0
    for fused in (True, False):
        cfg = DiffusionConfig(**SMALL, compute_dtype="float32", fused_transformer=fused)
        diff = CondGaussianDiffusion(cfg, device="cpu", model=model)
        if fused:
            diff._fused_layers = [tfl.layer_params(layer, bf16=False)
                                  for layer in model.motion_transformer.layer_stack]
        loop = (functools.partial(diff.p_sample_loop_ddim, num_steps=3) if sampler == "ddim"
                else diff.p_sample_loop)
        runs.append(loop(x_start, cond, inpaint_value=ipv, inpaint_mask=ipm, noise=TorchNoise("cpu", 9)))
    np.testing.assert_allclose(runs[0].numpy(), runs[1].numpy(), atol=ATOL_STACK, rtol=0)
    np.testing.assert_array_equal(runs[0][:, :4].numpy(), ipv[:, :4].numpy())


@pytest.mark.parametrize("bf16", [False, True])
def test_layer_params_are_the_jax_weights_transposed(bf16):
    """layer_params keeps each weight matrix as (N, K), nn.Linear's layout
    and the wgmma kernel's K-major operand: the transpose of the JAX
    kernel's (K, N) matrix (q, k, v stacked along N), bit for bit in the
    compute dtype; biases and LayerNorm rows stay f32."""
    _, variables, _, layer = _layer(9, 1, seed=3)
    jp = {k: np.asarray(v.astype(jnp.float32)) for k, v in jfl.layer_params_from_flax(
        variables["params"], dtype=jnp.bfloat16 if bf16 else jnp.float32).items()}
    lp = tfl.layer_params(layer, bf16=bf16)
    want = {"wqkv": np.concatenate([jp["wq"], jp["wk"], jp["wv"]], 1).T,
            "bqkv": np.concatenate([jp["bq"], jp["bk"], jp["bv"]], 1)[0],
            **{k: jp[k].T for k in ("wfc", "w1", "w2")},
            **{k: jp[k][0] for k in ("bfc", "ln1s", "ln1b", "b1", "b2", "ln2s", "ln2b")}}
    # f32: each weight also split for the 3xTF32 GEMM, hi + lo the weight exactly
    splits = {} if bf16 else {f"{k}_split": want[k] for k in ("wqkv", "wfc", "w1", "w2")}
    assert lp.keys() == want.keys() | splits.keys()
    for key, w in want.items():
        assert lp[key].dtype == (torch.bfloat16 if bf16 and key[0] == "w" else torch.float32), key
        assert lp[key].is_contiguous()
        np.testing.assert_array_equal(lp[key].float().numpy(), w, err_msg=key)
    for key, w in splits.items():
        assert lp[key].shape == (2, *w.shape) and lp[key].is_contiguous(), key
        np.testing.assert_array_equal((lp[key][0] + lp[key][1]).numpy(), w, err_msg=key)


def test_bf16_copy_at_the_producer_is_the_rounding_at_the_product():
    """The wgmma kernel reads A as the bf16 copy that the producing epilogue
    (the stem's, the LayerNorms') writes beside its f32 output, where
    _layer_body rounds the f32 operand at the product (x.astype(cdt)). Both
    are one round-to-nearest-even of the same f32 value, so the QKV and w1
    products of the plain layer at the release width are the same, bit for
    bit, from the copy as from the f32 tensor; a truncating copy would not
    be."""
    torch.manual_seed(0)
    layer = ttr.DecoderLayer(512, 4, 256, 256)
    lp = tfl.layer_params(layer, bf16=True)
    x = torch.randn(2 * 121, 512)
    h0 = ck.layer_norm_plain(3 * torch.randn(2 * 121, 512), lp["ln1s"], lp["ln1b"])
    for a, w in ((x, lp["wqkv"]), (h0, lp["w1"])):
        copy = a.to(torch.bfloat16)
        assert torch.equal(tfl.linear_plain(copy, w), tfl.linear_plain(a, w))
        truncated = (a.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
        assert not torch.equal(tfl.linear_plain(truncated, w), tfl.linear_plain(a, w))
