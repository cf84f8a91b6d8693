"""The port's parallel-window sampler (``sample_sliding_window_parallel``)
against the JAX package's on the CPU, at the small widths of
test_torch_chain (window 24, overlap 10, 6 timesteps), in f32, with JAX's
keys replayed: one noise source per ``_sample_window`` call, the stacked
full windows first and then each ragged window.

T = 24: one full window; 40: two full windows and a ragged 12-frame one;
52: three full windows; 58: three full windows and a ragged 16-frame one.
Tolerance 1e-4 absolute on root positions and rotation matrices, as for
the chained sampler: f32 rounding through canonicalization and IK."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chain import ATOL, SMALL, JaxChainNoise, _motion, _rest

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.diffusion.gaussian_diffusion import NormStats as JStats
from egoego_release_tpu.eval import pipeline as jpipeline
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    NormStats,
    new_denoiser,
)
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax, load_denoiser_weights

B = 2
# frames -> (full-window starts, ragged-window starts) at window 24, overlap 10
WINDOWS = {24: ([0], []), 40: ([0, 14], [28]), 52: ([0, 14, 28], []), 58: ([0, 14, 28], [42])}


def _setup(sampler, frames, seed=0):
    rng = np.random.RandomState(seed + frames)
    kw = dict(sampler=sampler, ddim_steps=3)
    jdiff = JDiffusion(JConfig(**SMALL, **kw))
    params = jdiff.init_params(jax.random.PRNGKey(seed), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)), denoiser_state_dict_from_jax(params))
    tdiff = CondGaussianDiffusion(DiffusionConfig(**SMALL, **kw, compute_dtype="float32"), device="cpu",
                                  model=model)
    rest = _rest(rng)
    trans, root_orient, body_pose = _motion(rng, B, frames)
    jp = SimpleNamespace(rest_offsets=jnp.asarray(rest), extras={})
    head = np.array(jpipeline.gt_from_smpl_params_batched(jp, trans, root_orient, body_pose)[2])
    lo = rng.uniform(-1.5, -0.5, (22, 3)).astype(np.float32)
    hi = rng.uniform(0.5, 1.5, (22, 3)).astype(np.float32)
    return jdiff, params, tdiff, head, lo, hi, rest


@pytest.mark.parametrize("frames", sorted(WINDOWS))
@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_parallel_window_matches_jax(sampler, frames):
    jdiff, params, tdiff, head, lo, hi, rest = _setup(sampler, frames)
    key = jax.random.PRNGKey(11)
    aa_j, root_j = jdiff.sample_sliding_window_parallel(
        params, key, jnp.asarray(head[..., :3]), jnp.asarray(head[..., 3:]),
        JStats(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(rest))

    rows = []
    sample_window = tdiff._sample_window
    tdiff._sample_window = lambda jpos, *a: rows.append(tuple(jpos.shape[:2])) or sample_window(jpos, *a)
    aa_t, root_t = tdiff.sample_sliding_window_parallel(
        torch.from_numpy(head[..., :3]), torch.from_numpy(head[..., 3:]),
        NormStats(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(rest),
        noise=JaxChainNoise(key))

    full, ragged = WINDOWS[frames]
    w = SMALL["window"]
    assert rows == [(len(full) * B, w)] + [(B, frames - t) for t in ragged]
    assert tuple(aa_t.shape) == tuple(aa_j.shape) == (B, frames, 22, 3)
    assert tuple(root_t.shape) == tuple(root_j.shape) == (B, frames, 3)
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(trot.axis_angle_to_matrix(aa_t).numpy(),
                               np.asarray(jrot.axis_angle_to_matrix(aa_j)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_single_window_needs_no_stitch(sampler):
    """A sequence of one window is that window's decoded sample, bit for
    bit: nothing is shifted, blended or cut."""
    _, _, tdiff, head, lo, hi, rest = _setup(sampler, 24)
    jpos, jquat = torch.from_numpy(head[..., :3]), torch.from_numpy(head[..., 3:])
    stats = NormStats(torch.from_numpy(lo), torch.from_numpy(hi))
    key = jax.random.PRNGKey(5)
    aa, root = tdiff.sample_sliding_window_parallel(jpos, jquat, stats, torch.from_numpy(rest),
                                                    noise=JaxChainNoise(key))
    aa_w, root_w, _ = tdiff._sample_window(jpos, jquat, stats, None, JaxChainNoise(key).window())
    assert torch.equal(aa, aa_w) and torch.equal(root, root_w)


def test_parallel_window_runs_microbatched():
    """sample_microbatch applies to the stacked call as to any chain: 3 full
    windows x 2 sequences in chunks of 4 give finite output of the
    sequence's shape."""
    _, _, tdiff, head, lo, hi, rest = _setup("ddim", 52)
    tdiff.cfg = dataclasses.replace(tdiff.cfg, sample_microbatch=4)
    aa, root = tdiff.sample_sliding_window_parallel(
        torch.from_numpy(head[..., :3]), torch.from_numpy(head[..., 3:]),
        NormStats(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(rest),
        noise=TorchNoise("cpu", seed=0))
    assert aa.shape == (B, 52, 22, 3) and root.shape == (B, 52, 3)
    assert torch.isfinite(aa).all() and torch.isfinite(root).all()
