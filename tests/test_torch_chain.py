"""The port's canonical sliding-window chain, GT preparation and the
eval_stage2 CLI against the JAX package on the CPU (small widths, f32).

The chain runs three windows of a 40-frame sequence (window 24, overlap
10: the last window is a ragged 12 frames) with the JAX key stream
replayed window by window (diffusion/gaussian_diffusion.py:698). Tolerance
1e-4 absolute on positions and rotation matrices: f32 rounding carried
through canonicalization, FK re-projection and IK across three windows.
"""

import json
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.diffusion.gaussian_diffusion import NormStats as JStats
from egoego_release_tpu.eval import metrics as jmetrics
from egoego_release_tpu.eval import pipeline as jpipeline
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    NormStats,
    new_denoiser,
)
from egoego_release_tpu_torch.eval import eval_stage2
from egoego_release_tpu_torch.eval import pipeline as tpipeline
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax, load_denoiser_weights

SMALL = dict(d_model=64, n_head=2, n_dec_layers=3, d_k=32, d_v=32, window=24, timesteps=6,
             overlap_frames=10)
ATOL = 1e-4


class JaxChainNoise:
    """Per window: key, k_win = split(key); inside the window split(k_win, 3)
    and one split of the loop key per step, as the JAX samplers do."""

    def __init__(self, key):
        self.key = key

    def window(self):
        self.key, k_win = jax.random.split(self.key)
        self.k_init, self.k_cond, self.k_loop = jax.random.split(k_win, 3)
        return self

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


def _motion(rng, n, t):
    return (np.cumsum(rng.randn(n, t, 3) * 0.01, 1).astype(np.float32) + np.float32([0, 0, 0.9]),
            (rng.randn(n, t, 3) * 0.2).astype(np.float32),
            (rng.randn(n, t, 63) * 0.2).astype(np.float32))


def _rest(rng):
    return np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_canonical_chain_matches_jax(sampler):
    rng = np.random.RandomState(0)
    jdiff = JDiffusion(JConfig(**SMALL, sampler=sampler, ddim_steps=3))
    params = jdiff.init_params(jax.random.PRNGKey(0), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)),
                                  denoiser_state_dict_from_jax(params))
    tdiff = CondGaussianDiffusion(DiffusionConfig(**SMALL, sampler=sampler, ddim_steps=3,
                                                  compute_dtype="float32"), device="cpu", model=model)
    # head trajectories from GT FK of random motion, 40 frames
    rest = _rest(rng)
    trans, root_orient, body_pose = _motion(rng, 3, 40)
    jp = SimpleNamespace(rest_offsets=jnp.asarray(rest), extras={})
    _, _, head = jpipeline.gt_from_smpl_params_batched(jp, trans, root_orient, body_pose)
    head = np.asarray(head)
    lo = rng.uniform(-1.5, -0.5, (22, 3)).astype(np.float32)
    hi = rng.uniform(0.5, 1.5, (22, 3)).astype(np.float32)

    key = jax.random.PRNGKey(7)
    aa_j, root_j = jdiff.sample_sliding_window_w_canonical(
        params, key, jnp.asarray(head[..., :3]), jnp.asarray(head[..., 3:]),
        JStats(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(rest))
    aa_t, root_t = tdiff.sample_sliding_window_w_canonical(
        torch.from_numpy(head[..., :3]), torch.from_numpy(head[..., 3:]),
        NormStats(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(rest),
        noise=JaxChainNoise(key))
    assert aa_t.shape == aa_j.shape == (3, 40, 22, 3)
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(trot.axis_angle_to_matrix(aa_t).numpy(),
                               np.asarray(jrot.axis_angle_to_matrix(aa_j)), atol=ATOL, rtol=0)


def _pipelines(rng):
    rest = _rest(rng)
    stats = NormStats(-torch.ones(22, 3), torch.ones(22, 3))
    tp = tpipeline.EgoEgoPipeline(
        CondGaussianDiffusion(DiffusionConfig(**SMALL, compute_dtype="float32"), device="cpu"),
        stats, torch.from_numpy(rest))
    jp = SimpleNamespace(rest_offsets=jnp.asarray(rest), extras={})
    return tp, jp


def test_gt_preparation_matches_jax():
    """Per-sequence (host DBSCAN floor) and batched (device floor) GT prep."""
    rng = np.random.RandomState(1)
    tp, jp = _pipelines(rng)
    trans, root_orient, body_pose = _motion(rng, 3, 30)
    trans[:, 10:20] = trans[:, 10:11]  # still stretches, so the toes rest
    for out_t, out_j in [
        (tpipeline.gt_from_smpl_params(tp, trans[0], root_orient[0], body_pose[0]),
         jpipeline.gt_from_smpl_params(jp, trans[0], root_orient[0], body_pose[0])),
        (tpipeline.gt_from_smpl_params_batched(tp, trans, root_orient, body_pose),
         jpipeline.gt_from_smpl_params_batched(jp, trans, root_orient, body_pose)),
    ]:
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def _amass(tmp_path, rng, n=5, t=20):
    trans, root_orient, body_pose = _motion(rng, n, t)
    data = {i: {"seq_name": f"HumanEva-seq{i}", "trans": trans[i], "root_orient": root_orient[i],
                "body_pose": body_pose[i]} for i in range(n)}
    data[n] = {"seq_name": "CMU-train-seq", "trans": trans[0], "root_orient": root_orient[0],
               "body_pose": body_pose[0]}
    paths = {k: str(tmp_path / k) for k in ("data.p", "stats.p", "rest.npy", "out")}
    with open(paths["data.p"], "wb") as f:
        pickle.dump(data, f)
    with open(paths["stats.p"], "wb") as f:
        pickle.dump({"global_jpos_min": -np.ones((22, 3), np.float32),
                     "global_jpos_max": np.ones((22, 3), np.float32)}, f)
    np.save(paths["rest.npy"], _rest(rng))
    return paths


@pytest.mark.parametrize("batch_seqs", [1, 4])
def test_eval_stage2_cli_on_cpu(tmp_path, batch_seqs):
    """The port's CLI on the CPU writes the JAX CLI's JSON layout, with the
    metric keys of the JAX metric suite."""
    paths = _amass(tmp_path, np.random.RandomState(2))
    opt = eval_stage2.parse_opt([
        "--test_data_path", paths["data.p"], "--stats_path", paths["stats.p"],
        "--rest_offsets", paths["rest.npy"], "--window", "16", "--timesteps", "4",
        "--batch_seqs", str(batch_seqs), "--sample_bs", "2", "--fused_step",
        "--out_dir", paths["out"], "--device", "cpu"])
    result = eval_stage2.run(opt)
    z = jnp.zeros((16, 22, 3))
    q = jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (16, 22, 1))
    want = set(jmetrics.compute_metrics_for_smpl(q, z, 0.0, q, z, 0.0)) - {"single_jpe"}
    saved = json.load(open(f"{paths['out']}/stage2_diffusion_model_res_on_amass_test.json"))
    assert set(saved) == {"mean", "per_seq", "num_seqs"} and saved["num_seqs"] == 5
    assert set(result["mean"]) == want
    for name, entry in saved["per_seq"].items():
        assert name.startswith("HumanEva") and set(entry) == want
        assert all(np.isfinite(v) for v in entry.values())


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"]])
def test_eval_stage2_unported_flags_raise(tmp_path, flag):
    paths = _amass(tmp_path, np.random.RandomState(3), n=1)
    opt = eval_stage2.parse_opt(["--test_data_path", paths["data.p"], "--stats_path", paths["stats.p"],
                                 "--rest_offsets", paths["rest.npy"], "--device", "cpu", *flag])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eval_stage2.run(opt)


@pytest.mark.parametrize("route", [[], ["--fused"]])
def test_eval_stage2_sample_microbatch_on_cpu(tmp_path, route):
    """--sample_microbatch 2 on both routes, 5 sequences in chunks of 3: the
    first chain's 3 rows are padded to 4 and run as two chunks of 2, the
    second's 2 rows run whole; finite metrics for every sequence."""
    paths = _amass(tmp_path, np.random.RandomState(4))
    result = eval_stage2.run(eval_stage2.parse_opt([
        "--test_data_path", paths["data.p"], "--stats_path", paths["stats.p"],
        "--rest_offsets", paths["rest.npy"], "--window", "16", "--timesteps", "3", "--batch_seqs", "3",
        "--sample_microbatch", "2", *route, "--out_dir", paths["out"], "--device", "cpu"]))
    assert result["num_seqs"] == 5
    assert all(np.isfinite(v) for e in result["per_seq"].values() for v in e.values())


def test_rest_offsets_from_smplh_npz_match_jax(tmp_path):
    """The port's numpy rest offsets from a SMPL-H model npz against the JAX
    package's rest_offsets_22 (synthetic model, zero betas)."""
    from egoego_release_tpu.ops import smpl as jsmpl
    from egoego_release_tpu_torch.eval.build import load_rest_offsets

    rng = np.random.RandomState(5)
    v, j = 40, 24
    parents = np.concatenate([[-1], rng.randint(0, np.arange(1, j))])
    parents[:22] = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19]
    model = {
        "v_template": rng.randn(v, 3), "shapedirs": rng.randn(v, 3, 16),
        "posedirs": rng.randn(v, 3, (j - 1) * 9), "J_regressor": rng.rand(j, v) / v,
        "weights": rng.rand(v, j), "kintree_table": np.stack([parents, np.arange(j)]),
        "f": rng.randint(0, v, (10, 3)),
    }
    (tmp_path / "male").mkdir()
    np.savez(tmp_path / "male" / "model.npz", **model)
    ours = load_rest_offsets(str(tmp_path), None)
    ref = np.asarray(jsmpl.rest_offsets_22(jsmpl.load_smpl_npz(str(tmp_path / "male" / "model.npz"))))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
