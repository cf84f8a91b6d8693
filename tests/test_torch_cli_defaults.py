"""The port's CLIs compute with the JAX CLIs' numerics: f32 with no
``--fused`` / ``--fused_step`` (JAX: the flax denoiser, ``compute_dtype``
float32), bf16 under either flag (``--fused_step`` wins over ``--fused``),
and ``run_egoego``, which has neither flag in either package, f32.

The configurations are read off each package's ``build_pipeline`` as its
CLI calls it with the same arguments (the diffusion object is replaced by a
stub that records its config). The f32 chain that the no-flag CLI
configures matches the JAX no-flag chain on the same weights and replayed
noise within test_canonical_chain_matches_jax's tolerance (1e-4), at that
test's small widths."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chain import ATOL, SMALL, JaxChainNoise, _amass, _motion, _rest

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion.gaussian_diffusion import NormStats as JStats
from egoego_release_tpu.eval import build as jbuild
from egoego_release_tpu.eval import eval_egoego as jegoego
from egoego_release_tpu.eval import eval_stage2 as jstage2
from egoego_release_tpu.eval import pipeline as jpipeline
from egoego_release_tpu.eval import run_egoego as jrun
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    NormStats,
    new_denoiser,
)
from egoego_release_tpu_torch.eval import build as tbuild
from egoego_release_tpu_torch.eval import eval_egoego, eval_stage2, run_egoego
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax, load_denoiser_weights

FLAG_SETS = [[], ["--fused_step"], ["--fused"], ["--fused", "--fused_step"]]


class _Built(Exception):
    """Raised by the stub diffusion: carries the config build_pipeline made."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg


def _stub(cfg, *args, **kwargs):
    raise _Built(cfg)


def _config_of(module, run, argv, monkeypatch):
    """The DiffusionConfig that ``run(parse_opt(argv))`` hands to
    ``module.CondGaussianDiffusion`` (module: a package's eval.build)."""
    monkeypatch.setattr(module, "CondGaussianDiffusion", _stub)
    with pytest.raises(_Built) as built:
        run(argv)
    return built.value.cfg


def _jax_numerics(cfg) -> str:
    """What the JAX sampler computes in: fused_step (the bf16 step kernels)
    wins over fused_transformer (the bf16 fused layer); otherwise the flax
    denoiser in cfg.compute_dtype."""
    return "bfloat16" if cfg.fused_step or cfg.fused_transformer else cfg.compute_dtype


def _port_numerics(cfg) -> str:
    """fused_transformer: the bf16 fused_decoder_layer; otherwise the step
    kernels in cfg.compute_dtype."""
    return "bfloat16" if cfg.fused_transformer else cfg.compute_dtype


@pytest.fixture
def files(tmp_path):
    return _amass(tmp_path, np.random.RandomState(4), n=1)


def _argv(cli, paths, flags):
    if cli == "eval_stage2":
        return ["--test_data_path", paths["data.p"], "--stats_path", paths["stats.p"],
                "--rest_offsets", paths["rest.npy"], *flags]
    return ["--data_root_folder", paths["out"], "--full_body_gt_path", paths["data.p"],
            "--stats_path", paths["stats.p"], "--rest_offsets", paths["rest.npy"], *flags]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["none", "fused_step", "fused", "both"])
@pytest.mark.parametrize("cli", ["eval_stage2", "eval_egoego"])
def test_cli_flags_select_the_jax_numerics(files, monkeypatch, cli, flags):
    """Same argv into both packages' CLIs: the port computes in f32 exactly
    where JAX does, and its route matches (--fused_step wins)."""
    jmod, tmod = {"eval_stage2": (jstage2, eval_stage2), "eval_egoego": (jegoego, eval_egoego)}[cli]
    argv = _argv(cli, files, flags)
    jcfg = _config_of(jbuild, lambda a: jmod.run(jmod.parse_opt(a)), argv, monkeypatch)
    tcfg = _config_of(tbuild, lambda a: tmod.run(tmod.parse_opt(a + ["--device", "cpu"])), argv, monkeypatch)
    assert _port_numerics(tcfg) == _jax_numerics(jcfg) == ("bfloat16" if flags else "float32")
    assert tcfg.fused_transformer == (jcfg.fused_transformer and not jcfg.fused_step)
    if not flags:
        assert tcfg.compute_dtype == jcfg.compute_dtype == "float32"


def test_run_egoego_and_build_pipeline_default_to_f32(files, monkeypatch):
    """run_egoego has no numerics flag in either package, and both run it
    in f32; so does the port's build_pipeline called with its defaults."""
    argv = ["--data_root_folder", files["out"], "--stats_path", files["stats.p"],
            "--rest_offsets", files["rest.npy"]]
    jcfg = _config_of(jbuild, lambda a: jrun.run(jrun.parse_opt(a)), argv, monkeypatch)
    tcfg = _config_of(tbuild, lambda a: run_egoego.run(run_egoego.parse_opt(a + ["--device", "cpu"])), argv,
                      monkeypatch)
    assert _port_numerics(tcfg) == _jax_numerics(jcfg) == "float32"
    cfg = _config_of(tbuild, lambda _: tbuild.build_pipeline(
        stats_path=files["stats.p"], rest_offsets_path=files["rest.npy"], device="cpu"), None, monkeypatch)
    assert cfg.compute_dtype == "float32" and not cfg.fused_transformer


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_cli_default_chain_matches_jax_default_chain(files, monkeypatch, sampler):
    """The chain that each no-flag eval_stage2 configures, cut to the small
    widths of test_canonical_chain_matches_jax: the port's step kernels in
    f32 (plain versions on the CPU) against JAX's flax sampler in f32, on
    the same weights and the replayed key stream, within 1e-4."""
    argv = _argv("eval_stage2", files, [] if sampler == "ddpm" else ["--ddim_steps", "3"])
    jcfg = _config_of(jbuild, lambda a: jstage2.run(jstage2.parse_opt(a)), argv, monkeypatch)
    tcfg = _config_of(tbuild, lambda a: eval_stage2.run(eval_stage2.parse_opt(a + ["--device", "cpu"])), argv,
                      monkeypatch)
    monkeypatch.undo()
    jcfg, tcfg = dataclasses.replace(jcfg, **SMALL), dataclasses.replace(tcfg, **SMALL)
    assert (jcfg.sampler, jcfg.fused_step, jcfg.compute_dtype) == (sampler, False, "float32")
    assert (tcfg.sampler, tcfg.fused_transformer, tcfg.compute_dtype) == (sampler, False, "float32")
    rng = np.random.RandomState(9)
    jdiff = JDiffusion(jcfg)
    params = jdiff.init_params(jax.random.PRNGKey(3), bs=1)
    model = load_denoiser_weights(new_denoiser(tcfg), denoiser_state_dict_from_jax(params))
    tdiff = CondGaussianDiffusion(tcfg, device="cpu", model=model)
    rest = _rest(rng)
    trans, root_orient, body_pose = _motion(rng, 2, 30)
    jp = SimpleNamespace(rest_offsets=jnp.asarray(rest), extras={})
    _, _, head = jpipeline.gt_from_smpl_params_batched(jp, trans, root_orient, body_pose)
    head = np.asarray(head)
    lo = rng.uniform(-1.5, -0.5, (22, 3)).astype(np.float32)
    hi = rng.uniform(0.5, 1.5, (22, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    aa_j, root_j = jdiff.sample_sliding_window_w_canonical(
        params, key, jnp.asarray(head[..., :3]), jnp.asarray(head[..., 3:]),
        JStats(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(rest))
    aa_t, root_t = tdiff.sample_sliding_window_w_canonical(
        torch.from_numpy(head[..., :3]), torch.from_numpy(head[..., 3:]),
        NormStats(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(rest),
        noise=JaxChainNoise(key))
    assert aa_t.shape == aa_j.shape == (2, 30, 22, 3)
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(trot.axis_angle_to_matrix(aa_t).numpy(),
                               np.asarray(jrot.axis_angle_to_matrix(aa_j)), atol=ATOL, rtol=0)


def test_eval_stage2_cli_without_flags_on_cpu(tmp_path):
    """The no-flag CLI (f32 step chain) at a tiny size, as
    test_eval_stage2_cli_on_cpu runs --fused_step: it finishes, and every
    metric is finite."""
    paths = _amass(tmp_path, np.random.RandomState(6))
    result = eval_stage2.run(eval_stage2.parse_opt([
        "--test_data_path", paths["data.p"], "--stats_path", paths["stats.p"],
        "--rest_offsets", paths["rest.npy"], "--window", "16", "--timesteps", "4",
        "--batch_seqs", "4", "--out_dir", paths["out"], "--device", "cpu"]))
    assert result["num_seqs"] == 5
    assert all(np.isfinite(v) for v in result["mean"].values())
    assert all(np.isfinite(v) for entry in result["per_seq"].values() for v in entry.values())
