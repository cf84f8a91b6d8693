"""A ``pred_noise`` stage-2 model on the port's samplers, and the p2 loss
weight, against the JAX package on the CPU.

The port converts a noise prediction to x0 = r1 x_t - r2 out (r1 =
sqrt_recip_alphas_cumprod[t], r2 = sqrt_recipm1_alphas_cumprod[t]) before
the clip on all three DDPM routes: the f32 step kernels (the default), the
bf16 step kernels (``--fused_step``, ``compute_dtype="bfloat16"``) and the
``--fused`` layer loop; here each runs its plain version. JAX's default
DDPM route converts in ``_p_mean_variance``; its DDIM route and its
``fused_step`` route treat the output as x0 whatever the objective, so the
port's DDIM refuses a pred_noise model (tests/test_torch_training.py::
test_samplers_refuse_pred_noise).

Tolerances: the canonical DDPM chain within tests/test_torch_chain.py's
1e-4 of JAX's default DDPM chain; the bf16 routes' reverse chains within
JAX's bf16 drift bound 0.08 (tests/test_fused_step.py:89) of the port's f32
chain on the same inputs and noise, over 100 steps (the test says why);
the f32 update's plain versions (the step's and the GEMM wrapper's) within
1e-6 of the conversion written out;
the loss at p2 gamma 0.5 within 1e-6 relative of JAX's and its gradients
within 1e-5 of each tensor's max (tests/test_torch_training.py's bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.diffusion.gaussian_diffusion import NormStats as JStats
from egoego_release_tpu.diffusion.gaussian_diffusion import head_condition_mask as jhead_mask
from egoego_release_tpu.diffusion.schedule import make_diffusion_constants as jconstants
from egoego_release_tpu.eval import pipeline as jpipeline
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    NormStats,
    head_condition_mask,
    new_denoiser,
)
from egoego_release_tpu_torch.diffusion.schedule import make_diffusion_constants
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_step as fs
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax, load_denoiser_weights
from test_torch_chain import ATOL, SMALL, JaxChainNoise, _motion, _rest
from test_torch_training import LossKeys, _batch, _close, _zero_grad

PRED_NOISE = dict(SMALL, objective="pred_noise")
DRIFT_BF16 = 0.08


@pytest.fixture(scope="module")
def pair():
    jdiff = JDiffusion(JConfig(**PRED_NOISE))
    params = jdiff.init_params(jax.random.PRNGKey(0), bs=1)
    sd = denoiser_state_dict_from_jax(params)
    make = lambda **kw: CondGaussianDiffusion(dataclasses.replace(DiffusionConfig(**PRED_NOISE), **kw), device="cpu",
                                              model=load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)), sd))
    return jdiff, params, make


def test_ddpm_pred_noise_chain_matches_jax(pair):
    """The canonical sliding-window chain (three windows of a 40-frame
    sequence, the last ragged) on the f32 step route against JAX's default
    DDPM route, JAX's keys replayed."""
    jdiff, params, make = pair
    tdiff = make()
    rng = np.random.RandomState(0)
    rest = _rest(rng)
    trans, root_orient, body_pose = _motion(rng, 3, 40)
    jp = type("P", (), {"rest_offsets": jnp.asarray(rest), "extras": {}})()
    head = np.asarray(jpipeline.gt_from_smpl_params_batched(jp, trans, root_orient, body_pose)[2])
    lo = rng.uniform(-1.5, -0.5, (22, 3)).astype(np.float32)
    hi = rng.uniform(0.5, 1.5, (22, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    aa_j, root_j = jdiff.sample_sliding_window_w_canonical(
        params, key, jnp.asarray(head[..., :3]), jnp.asarray(head[..., 3:]),
        JStats(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(rest))
    aa_t, root_t = tdiff.sample_sliding_window_w_canonical(
        torch.from_numpy(head[..., :3]), torch.from_numpy(head[..., 3:]),
        NormStats(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(rest), noise=JaxChainNoise(key))
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(trot.axis_angle_to_matrix(aa_t).numpy(),
                               np.asarray(jrot.axis_angle_to_matrix(aa_j)), atol=ATOL, rtol=0)


def _reverse_inputs(bs=3, t=24, seed=1):
    rng = np.random.RandomState(seed)
    x_start = torch.from_numpy(rng.uniform(-1, 1, (bs, t, 198)).astype(np.float32))
    ipv = torch.from_numpy(rng.uniform(-1, 1, (bs, t, 198)).astype(np.float32))
    ipm = torch.zeros(bs, t, 1)
    ipm[:, :10] = 1.0
    return x_start, head_condition_mask(bs, t), ipv, ipm


@pytest.mark.parametrize("route", ["fused", "bf16_step"])
def test_bf16_routes_within_drift_of_f32(pair, route):
    """The reverse chain (with the overlap inpaint) on the --fused layer loop
    and on the bf16 step route against the f32 step route, same noise, over
    a 100-step schedule. At SMALL's 6 steps r1 and r2 reach tens in the
    first steps, where a bf16 rounding of the output moves a few elements
    across the clip: JAX's own --fused chain of this model drifts 0.36
    from its f32 chain there (0.09 at 20 steps), both packages' mean drift
    staying 3e-4 to 2e-3; the release schedule has 1000 steps."""
    _, _, make = pair
    x_start, cond, ipv, ipm = _reverse_inputs()
    kw = {"fused": dict(fused_transformer=True), "bf16_step": dict(compute_dtype="bfloat16")}[route]
    kw["timesteps"] = 100
    want = make(timesteps=100).p_sample_loop(x_start, cond, None, ipv, ipm, noise=fs.TorchNoise("cpu", 3))
    got = make(**kw).p_sample_loop(x_start, cond, None, ipv, ipm, noise=fs.TorchNoise("cpu", 3))
    drift = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()) and drift <= DRIFT_BF16, drift
    # the inpainted frames are forced on every route (the step routes by
    # x + m (v - x), one rounding off)
    for out in (got, want):
        assert float((out[:, :10] - ipv[:, :10]).abs().max()) <= 1e-6


def test_step_update_converts_before_the_clip():
    """step_update_plain and gemm_plain's STEP with the five scalars against
    the conversion written out; three scalars keep the pred_x0 update."""
    g = torch.Generator().manual_seed(4)
    bsz, t, d, dm = 2, 5, 198, 32
    h = torch.randn(bsz, t + 1, dm, generator=g)
    x, noise, ipv = (torch.randn(bsz, t, d, generator=g) for _ in range(3))
    ipm = (torch.rand(bsz, t, generator=g) > 0.5).float()
    prep = {"lw": torch.randn(d + 2, dm, generator=g) * 0.3, "lb": torch.randn(d, generator=g) * 0.1}
    out = h[:, 1:] @ prep["lw"][:d].t() + prep["lb"]
    a1, a2, a3, r1, r2 = 0.7, 0.2, 0.05, 1.3, 0.6
    for scal, x0 in (((a1, a2, a3, r1, r2), (r1 * x - r2 * out).clamp(-1, 1)), ((a1, a2, a3), out.clamp(-1, 1))):
        xn = a1 * x0 + a2 * x + a3 * noise
        want = xn + ipm[..., None] * (ipv - xn)
        got = fs.step_update_plain(h, x, noise, scal, ipv, ipm, prep)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        res = torch.empty(bsz * t, d)
        ck.gemm_plain(ck.STEP, h.reshape(-1, dm), prep["lw"], prep["lb"], res, M=bsz * t, x=x, noise=noise, ipv=ipv,
                      ipm=ipm, t_data=t, scal=scal)
        torch.testing.assert_close(res.reshape(bsz, t, d), want, rtol=0, atol=1e-6)


def test_ddpm_scalars_carry_the_conversion():
    consts = make_diffusion_constants(8)
    plain, noise = fs.ddpm_scalars(consts, 8), fs.ddpm_scalars(consts, 8, pred_noise=True)
    assert [t for t, _ in plain] == [t for t, _ in noise] == list(range(7, -1, -1))
    for (t, s3), (_, s5) in zip(plain, noise):
        assert s5[:3] == s3 and s5[3:] == (float(consts.sqrt_recip_alphas_cumprod[t]),
                                           float(consts.sqrt_recipm1_alphas_cumprod[t]))


def test_p2_schedule_matches_jax():
    for gamma, k in ((0.5, 1.0), (1.0, 2.0)):
        got, want = make_diffusion_constants(50, "cosine", gamma, k), jconstants(50, "cosine", gamma, k)
        for name in got._fields:
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
        assert got.p2_loss_weight.min() < 1.0


def test_p_losses_at_p2_gamma_half_matches_jax():
    cfg = dict(d_feats=198, d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=12, timesteps=8,
               p2_loss_weight_gamma=0.5)
    jdiff = JDiffusion(JConfig(**cfg))
    params = jdiff.init_params(jax.random.PRNGKey(0))
    tdiff = CondGaussianDiffusion(DiffusionConfig(**cfg), device="cpu")
    model = load_denoiser_weights(new_denoiser(tdiff.cfg), denoiser_state_dict_from_jax(params))
    b = _batch()
    key = jax.random.PRNGKey(3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdiff.p_losses(p, key, jnp.asarray(b["motion"]), jhead_mask(4, 12))))(params)
    tloss = tdiff.p_losses(model, torch.from_numpy(b["motion"]), head_condition_mask(4, 12), noise=LossKeys(key))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    unweighted = CondGaussianDiffusion(DiffusionConfig(**dict(cfg, p2_loss_weight_gamma=0.0)), device="cpu")
    assert abs(unweighted.p_losses(model, torch.from_numpy(b["motion"]), head_condition_mask(4, 12),
                                   noise=LossKeys(key)).item() - tloss.item()) > 1e-3 * abs(tloss.item())
    want = denoiser_state_dict_from_jax(jgrads)
    got = {k: p.grad for k, p in model.named_parameters()}
    g_max = max(float(v.abs().max()) for v in want.values())
    for k in want:
        if _zero_grad(k):
            assert max(float(got[k].abs().max()), float(want[k].abs().max())) < 1e-6 * g_max, k
        else:
            _close(got[k], want[k], 1e-5, k)
