"""bf16 inter-layer activations of the step kernels (``act_bf16``,
``DiffusionConfig.fused_step_act_bf16``) against the JAX package on the
CPU, on the same weights and numpy inputs.

JAX runs its step kernels in interpret mode with f32 compute and bf16
activations (``CondGaussianDiffusion(..., fused_step=True,
fused_step_act_bf16=True)``, as tests/test_fused_step.py:73 runs it); the
port runs the kernels' plain versions with the same pair. Both round at the
same points (the outputs of layers 0 .. L-2), so a layer's bf16 output is
JAX's bit for bit unless an f32 sum, taken in another order, lands on the
other side of a bf16 rounding boundary: then that entry differs by one bf16
ulp (at most 2^-7 of its magnitude). Tolerances:

- one layer: every entry equal or one bf16 ulp apart, and at most 1% of
  the entries apart (``_bf16_flips``);
- the chain: 2e-2 absolute, a flipped rounding of an O(1) LayerNorm
  output (2^-7 to 2^-6) carried through the later layers and steps, as the
  chip checks hold a bf16 kernel against its plain version;
- bf16 compute against JAX's bf16 compute: 2e-2, tests/test_torch_denoiser.py's
  bound for bf16 compute;
- against the f32-activation chain: JAX's own bound, 0.08.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.ops import fused_step as jfs
from egoego_release_tpu.ops.fused_layer import _PARAM_ORDER, _layer_body
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    new_denoiser,
)
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_layer as tfl
from egoego_release_tpu_torch.ops import fused_step as tfs
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax, load_denoiser_weights

SMALL = dict(d_feats=12, d_model=64, n_head=2, n_dec_layers=3, d_k=32, d_v=32, window=24, timesteps=6)
JCFG = JConfig(**SMALL)
BS = 5
KW = dict(n_head=SMALL["n_head"], d_k=SMALL["d_k"], d_v=SMALL["d_v"])
CHAIN_TOL = 2e-2
BF16_TOL = 2e-2
JAX_DRIFT = 0.08  # tests/test_fused_step.py:87


class JaxKeyNoise:
    """The JAX samplers' draws: split(key, 3) -> initial, condition and loop
    keys, then one split of the loop key per step (ops/fused_step.py:385-418)."""

    def __init__(self, key):
        self.k_init, self.k_cond, self.k_loop = jax.random.split(key, 3)

    @staticmethod
    def _np(key, shape):
        return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

    def initial(self, shape):
        return self._np(self.k_init, shape)

    def cond(self, shape):
        return self._np(self.k_cond, shape)

    def step(self, shape):
        self.k_loop, sk = jax.random.split(self.k_loop)
        return self._np(sk, shape)


@pytest.fixture(scope="module")
def models():
    params = JDiffusion(JCFG).init_params(jax.random.PRNGKey(0), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)), denoiser_state_dict_from_jax(params))
    return params, model


def _port(model, act_bf16, **kw):
    cfg = DiffusionConfig(**SMALL, compute_dtype="float32", fused_step_act_bf16=act_bf16, **kw)
    return CondGaussianDiffusion(cfg, device="cpu", model=model)


def _chain_inputs(t, inpaint, seed=1):
    rng = np.random.RandomState(seed)
    x_start = rng.randn(BS, t, SMALL["d_feats"]).astype(np.float32)
    cond_mask = (rng.rand(BS, t, SMALL["d_feats"]) > 0.3).astype(np.float32)
    ipv = ipm = None
    if inpaint:
        ipv = rng.randn(BS, t, SMALL["d_feats"]).astype(np.float32)
        ipm = np.zeros((BS, t, 1), np.float32)
        ipm[:, :4] = 1.0
    return x_start, cond_mask, ipv, ipm


def _sample(diff, sampler, inputs, noise):
    x_start, cond_mask, ipv, ipm = (None if a is None else torch.from_numpy(a) for a in inputs)
    if sampler == "ddim":
        return diff.p_sample_loop_ddim(x_start, cond_mask, num_steps=3, inpaint_value=ipv, inpaint_mask=ipm,
                                       noise=noise)
    return diff.p_sample_loop(x_start, cond_mask, inpaint_value=ipv, inpaint_mask=ipm, noise=noise)


def _jax_sample(params, act_bf16, sampler, inputs, key):
    jdiff = JDiffusion(dataclasses.replace(JCFG, fused_step=True, fused_step_act_bf16=act_bf16))
    x_start, cond_mask, ipv, ipm = (None if a is None else jnp.asarray(a) for a in inputs)
    if sampler == "ddim":
        return jdiff.p_sample_loop_ddim(params, key, x_start, cond_mask, num_steps=3, inpaint_value=ipv,
                                        inpaint_mask=ipm)
    return jdiff.p_sample_loop(params, key, x_start, cond_mask, inpaint_value=ipv, inpaint_mask=ipm)


@pytest.mark.parametrize("sampler,t,inpaint", [("ddpm", 24, False), ("ddpm", 13, True), ("ddim", 24, True)])
def test_act_bf16_chain_matches_jax(models, sampler, t, inpaint):
    """The port's act-bf16 chain (plain versions, f32 compute) against JAX's
    (interpret, f32 compute, bf16 activations), JAX's keys replayed."""
    params, model = models
    inputs = _chain_inputs(t, inpaint)
    key = jax.random.PRNGKey(6)
    out_j = np.asarray(_jax_sample(params, True, sampler, inputs, key))
    out_t = _sample(_port(model, True), sampler, inputs, JaxKeyNoise(key)).numpy()
    assert out_t.dtype == np.float32 and out_t.shape == out_j.shape
    err = float(np.abs(out_t - out_j).max())
    assert err < CHAIN_TOL, err


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_act_bf16_drift_from_f32_activations(models, sampler):
    """bf16 activations stay within JAX's bound of the f32-activation chain,
    and they do change the result (the flag reaches the kernels)."""
    _, model = models
    inputs = _chain_inputs(SMALL["window"], False, seed=8)
    key = jax.random.PRNGKey(8)
    ref = _sample(_port(model, False), sampler, inputs, JaxKeyNoise(key))
    out = _sample(_port(model, True), sampler, inputs, JaxKeyNoise(key))
    drift = float((out - ref).abs().max())
    assert 0 < drift < JAX_DRIFT, drift


def _bf16_flips(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    """got and want equal, but for entries one bf16 ulp apart (a rounding
    that flipped), at most 1% of them."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    apart = diff > 0
    assert bool((diff <= 2.0 ** -7 * np.abs(want) + 1e-30).all()), f"{what}: {diff.max()}"
    assert apart.mean() <= 0.01, f"{what}: {apart.sum()} of {apart.size} entries apart"


def _layer_inputs(t, seed=3):
    rng = np.random.RandomState(seed)
    d, dm = SMALL["d_feats"], SMALL["d_model"]
    x, xc, noise, ipv = (rng.randn(BS, t, d).astype(np.float32) for _ in range(4))
    h = torch.from_numpy(rng.randn(BS, t + 1, dm).astype(np.float32)).to(torch.bfloat16)
    mask = np.ones((BS, t + 1), np.float32)
    mask[:, t - 3:] = 0.0
    ipm = np.zeros((BS, t), np.float32)
    ipm[:, :4] = 1.0
    emb = rng.randn(dm).astype(np.float32)
    return dict(x=x, xc=xc, noise=noise, ipv=ipv, ipm=ipm, h=h, mask=mask, emb=emb)


def _jax_layer(h, mask, lp, cdt):
    """JAX's _layer_body on unpadded arrays: h (B, T, dm) in its dtype, mask
    (B, T) -> the f32 layer output."""
    b, t, _ = h.shape
    return _layer_body(jnp.asarray(h), jnp.asarray(mask).reshape(b * t, 1), *[lp[n] for n in _PARAM_ORDER],
                       t_real=t, scale=1.0 / SMALL["d_k"] ** 0.5, cdt=cdt, **KW)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("which", ["stem_layer", "decoder_layer", "layer_epilogue"])
def test_plain_step_pieces_match_layer_body(models, which, bf16):
    """stem_layer_plain / decoder_layer_plain / layer_epilogue_plain with
    bf16 activations against a direct composition of JAX's _layer_body: the
    stem's tokens f32 into layer 0, its output rounded to bf16; a bf16 input
    into a middle layer, its output rounded to bf16; a bf16 input into the
    last layer, whose f32 output feeds linear_out, the clip and the
    update."""
    params, model = models
    t, d = SMALL["window"], SMALL["d_feats"]
    cdt = jnp.bfloat16 if bf16 else jnp.float32
    jprep = jfs.prepare_step_params(params, JCFG, cdt, 128)
    prep = tfs.prepare_step_params(model, bf16)
    inp = _layer_inputs(t)
    t_ = torch.from_numpy
    mask = t_(inp["mask"])
    h_np = inp["h"].float().numpy()
    if which == "stem_layer":
        pad = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (0, 128 - d)))
        stem = (jnp.dot(pad(inp["x"]).astype(cdt), jprep["wsx"], preferred_element_type=jnp.float32)
                + jnp.dot(pad(inp["xc"]).astype(cdt), jprep["wsc"], preferred_element_type=jnp.float32)
                + jprep["bst"])
        pos = jprep["pos_table"][1: t + 2]
        h0 = jnp.concatenate([jnp.broadcast_to(inp["emb"], (BS, 1, SMALL["d_model"])), stem], 1) + pos
        want = _jax_layer(h0, inp["mask"], jprep["layers"][0], cdt).astype(jnp.bfloat16)
        got = tfs.stem_layer_plain(t_(inp["x"]), t_(inp["xc"]), t_(inp["emb"]), t_(np.asarray(pos)), mask, prep,
                                   act_bf16=True, **KW)
    elif which == "decoder_layer":
        want = _jax_layer(jnp.asarray(h_np, jnp.bfloat16), inp["mask"], jprep["layers"][1], cdt).astype(jnp.bfloat16)
        got = tfl.decoder_layer_plain(inp["h"], mask, prep["layers"][1], act_bf16=True, **KW)
    else:
        hl = _jax_layer(jnp.asarray(h_np, jnp.bfloat16), inp["mask"], jprep["layers"][-1], cdt)
        feat = hl[:, 1:].astype(cdt)
        x0 = jnp.clip(jnp.dot(feat, jprep["lw"], preferred_element_type=jnp.float32) + jprep["lb"], -1, 1)[..., :d]
        a1, a2, a3 = 0.7, 0.2, 0.1
        xn = a1 * x0 + a2 * inp["x"] + a3 * inp["noise"]
        want = xn + inp["ipm"][..., None] * (inp["ipv"] - xn)
        got = tfs.layer_epilogue_plain(inp["h"], mask, t_(inp["x"]), t_(inp["noise"]), (a1, a2, a3), t_(inp["ipv"]),
                                       t_(inp["ipm"]), prep, **KW)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    if which != "layer_epilogue":
        assert got.dtype == torch.bfloat16
    if bf16:
        err = float(np.abs(got.float().numpy() - want).max())
        assert err < BF16_TOL, err
    elif which == "layer_epilogue":  # f32 out: summation order only
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    else:
        _bf16_flips(got, want, which)


def test_layer_reads_a_bf16_input_as_its_f32_value(models):
    """A bf16 layer input is the f32 input it rounds to: same output, bit
    for bit, in either activation mode."""
    _, model = models
    prep = tfs.prepare_step_params(model, False)
    inp = _layer_inputs(13)
    mask = torch.from_numpy(inp["mask"])
    for act_bf16 in (False, True):
        a = tfl.decoder_layer_plain(inp["h"], mask, prep["layers"][1], act_bf16=act_bf16, **KW)
        b = tfl.decoder_layer_plain(inp["h"].float(), mask, prep["layers"][1], act_bf16=act_bf16, **KW)
        assert torch.equal(a, b)


def test_default_keeps_f32_activations_bit_for_bit(models):
    """The flag off (the default) is the f32-activation chain, bit for bit:
    the default config samples as fused_p_sample_loop without the flag, and
    every step piece returns f32, equal to an explicit act_bf16=False."""
    params, model = models
    assert DiffusionConfig().fused_step_act_bf16 is JConfig().fused_step_act_bf16 is False
    inputs = _chain_inputs(13, True)
    key = jax.random.PRNGKey(2)
    diff = CondGaussianDiffusion(DiffusionConfig(**SMALL, compute_dtype="float32"), device="cpu", model=model)
    out = _sample(diff, "ddpm", inputs, JaxKeyNoise(key))
    x_start, cond_mask, ipv, ipm = (torch.from_numpy(a) for a in inputs)
    loop = tfs.fused_p_sample_loop(diff, x_start, cond_mask, None, ipv, ipm, noise=JaxKeyNoise(key))
    assert torch.equal(out, loop)
    prep = diff.step_params()
    inp = _layer_inputs(13)
    h = inp["h"].float()
    mask = torch.from_numpy(inp["mask"])
    default = tfl.decoder_layer_plain(h, mask, prep["layers"][1], **KW)
    assert default.dtype == torch.float32
    assert torch.equal(default, tfl.decoder_layer_plain(h, mask, prep["layers"][1], act_bf16=False, **KW))
    assert torch.equal(tfl.decoder_layer(h, mask, prep["layers"][1], **KW), default)


def _gemm_operands(bf16_compute, m=16, n=64, k=64):
    """CPU tensors of a LAYER_NORM product (the refusals are checked before
    the device is); in f32 compute W arrives split for the 3xTF32 kernel."""
    wdt = torch.bfloat16 if bf16_compute else torch.float32
    w = torch.zeros(n, k, dtype=wdt)
    return dict(a=torch.zeros(m, k, dtype=wdt), w=w if bf16_compute else ck.split_tf32(w), bias=torch.zeros(n),
                res=torch.zeros(m, n, dtype=torch.bfloat16), ln_s=torch.ones(n), ln_b=torch.zeros(n),
                row_mask=torch.ones(m), out=torch.zeros(m, n), out_b=torch.zeros(m, n, dtype=torch.bfloat16), M=m)


def _call_gemm(mode, o):
    return ck.gemm(mode, o["a"], o["w"], o["bias"], o["out"], M=o["M"], res=o["res"], ln_s=o["ln_s"],
                   ln_b=o["ln_b"], row_mask=o["row_mask"], out_b=o["out_b"])


@pytest.mark.parametrize("bf16_compute,change", [
    (True, dict(out=None, out_b=None)),      # no output at all
    (False, dict()),                         # f32 compute: an f32 out and a bf16 copy
    (False, dict(out_b=None, out=None)),
    (True, dict(res=torch.zeros(16, 64, dtype=torch.float16))),  # a residual neither f32 nor bf16
    (True, dict(res=torch.zeros(16, 32, dtype=torch.bfloat16))),  # a residual of the wrong shape
    (True, dict(res=torch.zeros(16 * 64 + 2, dtype=torch.bfloat16)[2:].reshape(16, 64))),  # 4 bytes off 16
    (True, dict(out=None, out_b=torch.zeros(16, 64))),   # an f32 out_b
    (True, dict(out=None, out_b=torch.zeros(16, 72, dtype=torch.bfloat16)[:, :64])),  # strided out_b
])
def test_gemm_refuses_layouts_outside_the_new_checks(bf16_compute, change):
    """ck.gemm refuses, before any launch, the LAYER_NORM layouts the bf16
    activations do not open: no output, an f32 output beside a bf16 one in
    f32 compute, a residual of another type or shape or off 16-byte
    alignment in bf16, an out_b that is not a contiguous bf16 (M, N)."""
    o = dict(_gemm_operands(bf16_compute), **change)
    with pytest.raises(ValueError) as err:
        _call_gemm(ck.LAYER_NORM, o)
    assert "CUDA tensors" not in str(err.value)


@pytest.mark.parametrize("mode", [ck.BIAS, ck.BIAS_RELU])
def test_gemm_refuses_a_missing_out_outside_layer_norm(mode):
    o = _gemm_operands(True)
    with pytest.raises(ValueError, match="only LAYER_NORM"):
        ck.gemm(mode, o["a"], o["w"], o["bias"], None, M=o["M"], out_b=o["out_b"])


@pytest.mark.parametrize("bf16_compute,change", [
    (True, dict(out=None)),                   # w2_ln of the act-bf16 chain: bf16 out alone
    (True, dict()),                           # fc_ln of layers 1 .. L-1: bf16 residual, f32 h0 and its copy
    (False, dict(out=None)),                  # the same in f32 compute
    (False, dict(out_b=None)),
])
def test_gemm_takes_the_bf16_activation_layouts(bf16_compute, change):
    """The layouts of the act-bf16 chain pass every layout check (on CPU
    tensors only the device check is left to raise)."""
    o = dict(_gemm_operands(bf16_compute), **change)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        _call_gemm(ck.LAYER_NORM, o)
