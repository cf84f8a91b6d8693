"""The port's denoiser, step kernels (plain versions) and samplers against
the JAX package on the CPU, on the same weights and numpy inputs.

The JAX side runs its Pallas step kernels in interpret mode with f32
compute, as tests/test_fused_step.py does; the port runs the kernels'
plain versions (CPU tensors) with f32 compute. Tolerance 5e-5 absolute,
the JAX package's own fused-step vs XLA-loop bound
(tests/test_fused_step.py:48): f32 matmul re-association only.
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
from egoego_release_tpu.ops.fused_layer import _round_up
from egoego_release_tpu.utils import torch_ckpt
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    new_denoiser,
)
from egoego_release_tpu_torch.ops import fused_layer as tfl
from egoego_release_tpu_torch.ops import fused_step as tfs
from egoego_release_tpu_torch.utils.convert import (
    denoiser_state_dict_from_jax,
    load_denoiser_weights,
    load_stage2_diffusion_ckpt,
)

ATOL = 5e-5
SMALL = dict(d_feats=12, d_model=64, n_head=2, n_dec_layers=3, d_k=32, d_v=32, window=24, timesteps=6)
JCFG = JConfig(**SMALL)
TCFG = DiffusionConfig(**SMALL, compute_dtype="float32")
BS = 5


class JaxKeyNoise:
    """Replays the JAX samplers' draws: split(key, 3) -> initial, condition
    and loop keys, then one split of the loop key per step
    (ops/fused_step.py:385-418)."""

    def __init__(self, key):
        self.k_init, self.k_cond, self.k_loop = jax.random.split(key, 3)

    @staticmethod
    def _np(key, shape):
        return torch.from_numpy(np.asarray(jax.random.normal(key, shape, jnp.float32)))

    def initial(self, shape):
        return self._np(self.k_init, shape)

    def cond(self, shape):
        return self._np(self.k_cond, shape)

    def step(self, shape):
        self.k_loop, sk = jax.random.split(self.k_loop)
        return self._np(sk, shape)


@pytest.fixture(scope="module")
def models():
    jdiff = JDiffusion(JCFG)
    params = jdiff.init_params(jax.random.PRNGKey(0), bs=1)
    model = load_denoiser_weights(new_denoiser(TCFG), denoiser_state_dict_from_jax(params))
    tdiff = CondGaussianDiffusion(TCFG, device="cpu", model=model)
    return jdiff, params, tdiff


def _inputs(t, seed=1, d=12):
    rng = np.random.RandomState(seed)
    x_start = rng.randn(BS, t, d).astype(np.float32)
    cond_mask = (rng.rand(BS, t, d) > 0.3).astype(np.float32)
    return x_start, cond_mask


@pytest.mark.parametrize("masked", [False, True])
def test_denoiser_forward_matches_flax(models, masked):
    jdiff, params, tdiff = models
    rng = np.random.RandomState(2)
    t = 20
    src = rng.randn(BS, t, 24).astype(np.float32)
    noise_t = rng.randint(0, 1000, BS).astype(np.int32)
    pm = None
    if masked:
        pm = np.ones((BS, 1, t + 1), np.float32)
        pm[:, :, 15:] = 0.0
    out_j = jdiff.denoiser.apply(params, jnp.asarray(src), jnp.asarray(noise_t),
                                 None if pm is None else jnp.asarray(pm))
    with torch.no_grad():
        out_t = tdiff.model(torch.from_numpy(src), torch.from_numpy(noise_t),
                            None if pm is None else torch.from_numpy(pm))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)


def test_weight_round_trip(models):
    """flax params -> port state_dict -> the JAX package's own torch
    converter -> the same flax params, bit for bit."""
    _, params, _ = models
    sd = {k: v.numpy() for k, v in denoiser_state_dict_from_jax(params).items()}
    back = torch_ckpt.convert_denoiser(sd, n_layers=JCFG.n_dec_layers, prefix="")
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


@pytest.mark.parametrize("layout", ["ema", "model"])
def test_load_released_checkpoint_layout(models, tmp_path, layout):
    """A synthetic stage2 .pt in the released layout ({step, model, ema})
    loads into the port with the EMA weights by default."""
    _, params, tdiff = models
    sd = {f"denoise_fn.{k}": v for k, v in denoiser_state_dict_from_jax(params).items()}
    sd["denoise_fn.motion_transformer.position_vec.weight"] = torch.zeros(26, 64)
    other = {k: torch.zeros_like(v) for k, v in sd.items()}
    if layout == "ema":
        ckpt = {"step": 7, "model": other, "ema": {f"ema_model.{k}": v for k, v in sd.items()}}
    else:
        ckpt = {"step": 7, "model": sd}
    path = tmp_path / "stage2.pt"
    torch.save(ckpt, path)
    loaded, step = load_stage2_diffusion_ckpt(str(path))
    assert step == 7
    model = load_denoiser_weights(new_denoiser(TCFG), loaded)
    for k, v in tdiff.model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def _padded_step_inputs(jdiff, params, t, inpaint, masked):
    """Both packages' step operands for one reverse step: the JAX ones
    padded as fused_p_sample_loop pads them (frames to 8, tokens to 8,
    features to 128, batch to the tile of 4), the port's unpadded."""
    rng = np.random.RandomState(3)
    d, dm = JCFG.d_feats, JCFG.d_model
    x, xc, noise = (rng.randn(BS, t, d).astype(np.float32) for _ in range(3))
    ipv = rng.randn(BS, t, d).astype(np.float32) if inpaint else None
    ipm = np.zeros((BS, t), np.float32)
    ipm[:, :4] = 1.0
    mask = np.ones((BS, t + 1), np.float32)
    if masked:
        mask[:, t - 3:] = 0.0  # padding-mask zeros stay visible keys
    td_p, dp, bp = _round_up(t, 8), _round_up(d, 128), _round_up(BS, 4)
    tp = _round_up(td_p + 1, 8)
    jprep = jfs.prepare_step_params(params, JCFG, jnp.float32, dp)
    pad3 = lambda a: jnp.pad(jnp.asarray(a), ((0, bp - BS), (0, td_p - t), (0, dp - d)))
    m = jnp.pad(jnp.asarray(mask), ((0, bp - BS), (0, tp - t - 1)))
    mask_lanes = jnp.broadcast_to(m.reshape(bp * tp, 1), (bp * tp, 128))
    pos = jnp.zeros((tp, dm)).at[: t + 1].set(jprep["pos_table"][1: t + 2])
    emb = jfs._noise_level_embedding(jnp.int32(4), jprep)
    scal = jnp.asarray([0.7, 0.2, 0.1], jnp.float32)
    jax_in = dict(x=pad3(x), xc=pad3(xc), noise=pad3(noise), emb=emb, pos=pos, mask=mask_lanes,
                  scal=scal, prep=jprep,
                  ipv=None if ipv is None else pad3(ipv),
                  ipm=None if ipv is None else pad3(np.broadcast_to(ipm[..., None], (BS, t, d))))
    t_ = torch.from_numpy
    port_in = dict(x=t_(x), xc=t_(xc), noise=t_(noise), emb=t_(np.asarray(emb)[0]),
                   pos=t_(np.asarray(pos[: t + 1])), mask=t_(mask), scal=(0.7, 0.2, 0.1),
                   ipv=None if ipv is None else t_(ipv), ipm=None if ipv is None else t_(ipm))
    return jax_in, port_in


@pytest.mark.parametrize("t,masked,inpaint", [(24, False, False), (24, True, True), (13, False, True),
                                              (13, True, False)])
def test_step_kernels_match_jax(models, t, masked, inpaint):
    """stem_layer / decoder_layer / layer_epilogue (plain versions) against
    _call_stem_layer / _call_mid_layer / _call_epilogue_layer, at the full
    window and a ragged 13-frame one; then the whole step."""
    jdiff, params, tdiff = models
    jin, pin = _padded_step_inputs(jdiff, params, t, inpaint, masked)
    prep = tdiff.step_params()
    kw = dict(n_head=JCFG.n_head, d_k=JCFG.d_k, d_v=JCFG.d_v)
    jkw = dict(kw, t_tokens=t + 1, bt=4, interpret=True, cdt=jnp.float32)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)

    h_j = jfs._call_stem_layer(jin["x"], jin["xc"], jin["emb"], jin["pos"], jin["mask"], jin["prep"], **jkw)
    h_t = tfs.stem_layer(pin["x"], pin["xc"], pin["emb"], pin["pos"], pin["mask"], prep, **kw)
    close(h_t, h_j[:BS, : t + 1])

    h2_j = jfs._call_mid_layer(h_j, jin["mask"], jin["prep"]["layers"][1], **jkw)
    h2_t = tfl.decoder_layer(h_t, pin["mask"], prep["layers"][1], **kw)
    close(h2_t, h2_j[:BS, : t + 1])

    x_j = jfs._call_epilogue_layer(h2_j, jin["mask"], jin["x"], jin["noise"], jin["scal"], jin["ipv"],
                                   jin["ipm"], jin["prep"], **jkw)
    x_t = tfs.layer_epilogue(h2_t, pin["mask"], pin["x"], pin["noise"], pin["scal"], pin["ipv"],
                             pin["ipm"], prep, **kw)
    close(x_t, x_j[:BS, :t, :JCFG.d_feats])

    step_t = tfs.fused_denoise_step(pin["x"], pin["xc"], pin["emb"], pin["pos"], pin["mask"],
                                    pin["noise"], pin["scal"], pin["ipv"], pin["ipm"], prep, **kw)
    torch.testing.assert_close(step_t, x_t, rtol=0, atol=0)


def test_layer_padding_mask_scales_rows_only(models):
    """decoder_layer: a padding-mask zero zeroes its own output row and
    stays a visible key (as _layer_body does), so the other rows equal the
    unmasked layer's exactly (same arithmetic, so atol 0)."""
    _, _, tdiff = models
    lp = tdiff.step_params()["layers"][0]
    kw = dict(n_head=JCFG.n_head, d_k=JCFG.d_k, d_v=JCFG.d_v)
    rng = np.random.RandomState(4)
    h = torch.from_numpy(rng.randn(2, 16, 64).astype(np.float32))
    mask = torch.ones(2, 16)
    mask[:, 11:] = 0.0
    part = tfl.decoder_layer(h, mask, lp, **kw)
    full = tfl.decoder_layer(h, torch.ones(2, 16), lp, **kw)
    assert float(part[:, 11:].abs().max()) == 0.0
    torch.testing.assert_close(part[:, :11], full[:, :11], rtol=0, atol=0)


@pytest.mark.parametrize("sampler,t,inpaint", [("ddpm", 24, False), ("ddpm", 13, True),
                                               ("ddim", 24, True)])
def test_sample_loops_match_jax(models, sampler, t, inpaint):
    """The port's DDPM/DDIM loops against the JAX fused_p_sample_loop
    (interpret, f32) with the JAX key stream replayed."""
    jdiff, params, tdiff = models
    x_start, cond_mask = _inputs(t)
    ipv = ipm = None
    if inpaint:
        ipv = np.random.RandomState(5).randn(BS, t, 12).astype(np.float32)
        ipm = np.zeros((BS, t, 1), np.float32)
        ipm[:, :4] = 1.0
    key = jax.random.PRNGKey(6)
    jfused = JDiffusion(dataclasses.replace(JCFG, fused_step=True))
    ddim = 3 if sampler == "ddim" else None
    out_j = jfs.fused_p_sample_loop(
        jfused, params, key, jnp.asarray(x_start), jnp.asarray(cond_mask),
        inpaint_value=None if ipv is None else jnp.asarray(ipv),
        inpaint_mask=None if ipm is None else jnp.asarray(ipm),
        ddim_steps=ddim, interpret=True, compute_dtype=jnp.float32)
    t_ = lambda a: None if a is None else torch.from_numpy(a)
    if ddim:
        out_t = tdiff.p_sample_loop_ddim(t_(x_start), t_(cond_mask), num_steps=ddim,
                                         inpaint_value=t_(ipv), inpaint_mask=t_(ipm),
                                         noise=JaxKeyNoise(key))
    else:
        out_t = tdiff.p_sample_loop(t_(x_start), t_(cond_mask), inpaint_value=t_(ipv),
                                    inpaint_mask=t_(ipm), noise=JaxKeyNoise(key))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("timesteps,steps", [(1000, 50), (6, 3), (1000, 7)])
def test_ddim_timesteps_match_jax(timesteps, steps):
    ts_j = np.asarray(jnp.linspace(0, timesteps - 1, steps).astype(jnp.int32)[::-1])
    np.testing.assert_array_equal(tfs.ddim_timesteps(timesteps, steps), ts_j)


def test_bf16_plain_layer_tracks_jax_bf16(models):
    """bf16 mode: the port's plain layer keeps _layer_body's rounding
    points, so it lands within bf16 rounding of the JAX kernel run with
    bf16 compute (2e-2: a few bf16 ulps of O(1) LayerNorm outputs)."""
    jdiff, params, _ = models
    t = 24
    jin, pin = _padded_step_inputs(jdiff, params, t, False, True)
    jprep = jfs.prepare_step_params(params, JCFG, jnp.bfloat16, 128)
    tprep = tfs.prepare_step_params(load_denoiser_weights(new_denoiser(TCFG),
                                                          denoiser_state_dict_from_jax(params)), bf16=True)
    kw = dict(n_head=JCFG.n_head, d_k=JCFG.d_k, d_v=JCFG.d_v)
    h_j = jfs._call_stem_layer(jin["x"], jin["xc"], jin["emb"], jin["pos"], jin["mask"], jprep,
                               t_tokens=t + 1, bt=4, interpret=True, cdt=jnp.bfloat16, **kw)
    h_t = tfs.stem_layer(pin["x"], pin["xc"], pin["emb"], pin["pos"], pin["mask"], tprep, **kw)
    err = float(np.abs(h_t.numpy() - np.asarray(h_j[:BS, : t + 1])).max())
    assert err < 2e-2, err
