"""The port's batched and pipelined eval paths against the JAX package on
the CPU, at small widths, on the same weights (carried across by
``utils/convert.py``) and numpy inputs from a seed: the batched stage 1
(``stage1_head_pose_batched``, with its bf16 and int8 OF uploads), the
batched qpos GT prep, ``run_batches_pipelined`` and ``--sample_microbatch``.

Tolerances, each stated where it is used:
- stage 1: 1e-4 absolute, as tests/test_torch_stage1.py (f32 rounding
  through the transformers, the host integration and a 3x3 SVD in float64
  against JAX's f32);
- the qpos GT prep: 1e-5 absolute, as the SMPL-params GT prep in
  tests/test_torch_chain.py;
- the reverse chain: 1e-4 absolute, as tests/test_torch_chain.py;
- the pipelined loop's metrics: see ``test_run_batches_pipelined_matches_jax``;
- the port's pipelined loop against its own sequential composition:
  bit for bit (the same ops on the same inputs and noise).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.diffusion.gaussian_diffusion import NormStats as JStats
from egoego_release_tpu.diffusion.gaussian_diffusion import head_condition_mask as j_cond_mask
from egoego_release_tpu.eval import pipeline as jpipeline
from egoego_release_tpu.models import gravitynet as jgn
from egoego_release_tpu.models import headnet as jhn
from egoego_release_tpu.ops import alignment as jal
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    NormStats,
    head_condition_mask,
    new_denoiser,
)
from egoego_release_tpu_torch.eval import pipeline as tpipeline
from egoego_release_tpu_torch.models import gravitynet as tgn
from egoego_release_tpu_torch.models import headnet as thn
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.utils.convert import (
    denoiser_state_dict_from_jax,
    gravitynet_state_dict_from_jax,
    headformer_state_dict_from_jax,
    load_denoiser_weights,
)

SMALL = dict(d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=12, timesteps=6, overlap_frames=4)
HN = dict(d_model=32, n_layers=2, n_head=2, d_k=16, d_v=16, mlp_hsize=(64, 32))
GN = dict(d_model=32, n_layers=2, n_head=2, d_k=16, d_v=16, window=24, mlp_hsize=(48, 32))
T = 20  # frames a sequence: HeadNet blocks of 8 (3, the last of 4) or 16 (2, the last of 4)


class JaxKeyNoise:
    """The draws of one JAX sampler call from its key: split(key, 3) into
    the initial, condition and loop keys, one split of the loop key per
    step; ``split(k)`` gives the chunk keys of JAX's ``_microbatched``."""

    def __init__(self, key):
        self.key = key
        self.k_init, self.k_cond, self.k_loop = jax.random.split(key, 3)

    def split(self, k):
        return [JaxKeyNoise(c) for c in jax.random.split(self.key, k)]

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


class JaxChainNoise:
    """The sliding-window chain's draws from its key: key, k_win =
    split(key) per window (diffusion/gaussian_diffusion.py:698)."""

    def __init__(self, key):
        self.key = key

    def window(self):
        self.key, k_win = jax.random.split(self.key)
        return JaxKeyNoise(k_win)


def _unit_quats(rng, *shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rest(rng):
    return np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pipelines(headnet_window=8, **jax_flags):
    """A JAX pipeline (flax denoiser, f32) and the port's (f32 step kernels,
    plain on the CPU) on the same random weights; built once per setting,
    so the JAX programs compile once for the module."""
    jdiff = JDiffusion(JConfig(**SMALL))
    params = jdiff.init_params(jax.random.PRNGKey(0), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)), denoiser_state_dict_from_jax(params))
    jh = jhn.HeadFormer(**HN, window=headnet_window)
    hp = jh.init(jax.random.PRNGKey(1), jnp.zeros((1, headnet_window, 512)), jnp.ones((1, headnet_window)))
    jg = jgn.HeadNormalFormer(**GN)
    gp = jg.init(jax.random.PRNGKey(2), jnp.zeros((1, GN["window"], 18)), jnp.ones((1, GN["window"])))
    rest = _rest(np.random.RandomState(0))
    lo, hi = np.full((22, 3), -3.0, np.float32), np.full((22, 3), 3.0, np.float32)
    jp = jpipeline.EgoEgoPipeline(
        diffusion=jdiff, diffusion_params=params, stats=JStats(jnp.asarray(lo), jnp.asarray(hi)),
        rest_offsets=jnp.asarray(rest), headnet=jh, headnet_params=hp, gravitynet=jg, gravitynet_params=gp,
        **jax_flags)
    tp = tpipeline.EgoEgoPipeline(
        CondGaussianDiffusion(DiffusionConfig(**SMALL, compute_dtype="float32"), device="cpu", model=model),
        NormStats(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(rest),
        headnet=load_denoiser_weights(thn.HeadFormer(**HN, window=headnet_window),
                                      headformer_state_dict_from_jax(hp)).eval(),
        gravitynet=load_denoiser_weights(tgn.HeadNormalFormer(**GN), gravitynet_state_dict_from_jax(gp)).eval(),
        **jax_flags)
    return jp, tp


def _records(rng, n, t=T):
    """Stage-1 eval records: OF (t, 512), GT head pose and SLAM (t+1, ...)."""
    out = []
    for _ in range(n):
        head = np.concatenate([np.cumsum(rng.randn(t + 1, 3) * 0.02, 0) + [0, 0, 1.5], _unit_quats(rng, t + 1)],
                              -1).astype(np.float32)
        slam_q = _unit_quats(rng, t + 1)
        slam_t = np.cumsum(rng.randn(t + 1, 3) * 0.05, 0).astype(np.float32)
        aligned, _, _ = jal.align_slam_to_first_frame_np(slam_t, slam_q, head[0])
        out.append({"of": rng.randn(t, 512).astype(np.float32), "head_pose": head, "aligned_slam_trans": aligned,
                    "ori_slam_trans": slam_t, "ori_slam_rot_mat": jrot.quat_to_matrix_np(slam_q).astype(np.float32)})
    return out


def _qpos(rng, n, t):
    """Kinpoly qpos (n, t, 76) of a standing, swaying body, still in
    stretches so that the toes rest and the floor clustering has work."""
    q = np.zeros((n, t, 76), np.float32)
    q[..., :2] = np.cumsum(rng.uniform(-0.01, 0.01, (n, t, 2)), 1)
    q[:, t // 3: 2 * t // 3, :2] = q[:, t // 3: t // 3 + 1, :2]
    q[..., 2] = 0.92
    q[..., 3:7] = [0.7071, 0.7071, 0, 0]
    q[..., 7:] = rng.uniform(-0.2, 0.2, (n, 1, 69)) + rng.randn(n, t, 69) * 0.01
    return q


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("window", [8, 16])
def test_stage1_head_pose_batched_matches_jax(window):
    """Three records of 20 frames: at window 8, 3 blocks each (the last of
    4 frames), at window 16, 2 (the last of 4), all 9 or 6 through HeadNet
    at once. Against JAX's batched stage 1 at 1e-4, and against the port's
    own per-record stage 1 at JAX's bounds for that comparison (head pose
    2e-4, pred_scale rtol 1e-4; tests/test_eval_pipeline.py:124-139)."""
    jp, tp = _pipelines(headnet_window=window)
    records = _records(np.random.RandomState(window), 3)
    out_t = tp.stage1_head_pose_batched(records)
    out_j = jp.stage1_head_pose_batched(records)
    assert out_t["head_pose"].shape == (3, T + 1, 7) and out_t["pred_scale"].shape == (3,)
    for k in ("head_pose", "pred_scale", "pred_normal"):
        _close(out_t[k], out_j[k], 1e-4)
    for i, rec in enumerate(records):
        single = tp.stage1_head_pose(rec)
        _close(out_t["head_pose"][i], single["head_pose"], 2e-4)
        np.testing.assert_allclose(float(out_t["pred_scale"][i]), float(single["pred_scale"]), rtol=1e-4)


@pytest.mark.parametrize("mode", ["of_bf16", "of_int8"])
def test_stage1_of_uploads_match_jax(mode):
    """The bf16 and int8 OF uploads: the same rounding as JAX's (RNE to
    bf16; the same absmax / 127 int8 code), so within 1e-4 of JAX's output
    in the same mode; and within JAX's bounds of the f32 upload (head pose
    2e-2 / 5e-2, pred_scale rtol 2e-2 atol 5e-3 / rtol 5e-2 atol 1e-2;
    tests/test_eval_pipeline.py:142-198)."""
    jp, tp = _pipelines(**{mode: True})
    _, tp_f32 = _pipelines()
    records = _records(np.random.RandomState(3), 3)
    out_t = tp.stage1_head_pose_batched(records)
    out_j = jp.stage1_head_pose_batched(records)
    for k in ("head_pose", "pred_scale", "pred_normal"):
        _close(out_t[k], out_j[k], 1e-4)
    ref = tp_f32.stage1_head_pose_batched(records)
    hp_atol, s_rtol, s_atol = (2e-2, 2e-2, 5e-3) if mode == "of_bf16" else (5e-2, 5e-2, 1e-2)
    assert torch.isfinite(out_t["head_pose"]).all()
    _close(out_t["head_pose"], ref["head_pose"], hp_atol)
    np.testing.assert_allclose(out_t["pred_scale"].numpy(), ref["pred_scale"].numpy(), rtol=s_rtol, atol=s_atol)
    assert not torch.equal(out_t["head_pose"], ref["head_pose"])  # the upload mode took effect


def test_gt_prep_from_qpos_matches_jax():
    """qpos -> SMPL codec -> FK -> device floor -> snap -> head pose over
    (3, 30, 76) against JAX's ``_gt_prep_qpos`` at 1e-5."""
    rng = np.random.RandomState(4)
    rest = _rest(rng)
    qpos = _qpos(rng, 3, 30)
    jp = SimpleNamespace(rest_offsets=jnp.asarray(rest), extras={})
    jpipeline._ensure_gt_programs(jp)
    out_j = jp.extras["_gt_prep_qpos"](jnp.asarray(qpos), jp.rest_offsets)
    tp = SimpleNamespace(rest_offsets=torch.from_numpy(rest), _upload=torch.as_tensor)
    out_t = tpipeline.gt_from_qpos_batched(tp, qpos)
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        _close(a, b, 1e-5)


def _batches(rng, kind, n_b=2, n=3, t=16):
    """n_b batches of n sequences of t frames: "stage1" = stage-1 records
    with kinpoly qpos GT and the record head pose (eval_egoego), "gt_head"
    = SMPL-params GT and no records (eval_stage2)."""
    out = []
    for _ in range(n_b):
        if kind == "gt_head":
            out.append({"gt_trans": (np.cumsum(rng.randn(n, t, 3) * 0.02, 1) + [0, 0, 0.9]).astype(np.float32),
                        "gt_root_orient": (rng.randn(n, t, 3) * 0.2).astype(np.float32),
                        "gt_body_pose": (rng.randn(n, t, 63) * 0.2).astype(np.float32)})
        else:
            recs = _records(rng, n, t)
            out.append({"records": recs, "gt_qpos": _qpos(rng, n, t),
                        "gt_head_pose": np.stack([r["head_pose"][:t] for r in recs])})
    return out


@pytest.mark.parametrize("kind,sample_bs", [("stage1", 1), ("gt_head", 1), ("stage1", 2)])
def test_run_batches_pipelined_matches_jax(kind, sample_bs):
    """Two batches of three sequences of 16 frames (two stage-2 windows of
    12 with overlap 4) through both packages, the port replaying JAX's
    per-batch key split(K, 2)[k]. Metrics within 1e-3 relative and 0.05
    absolute (mm-scale metrics; the chain's 1e-4 m carried through FK, the
    device floor and the metric suite) and the unitless pose distances
    within 1e-4; the stage-1 triple within 1e-3 relative, 1e-4 absolute."""
    jp, tp = _pipelines()
    batches = _batches(np.random.RandomState(5), kind)
    key = jax.random.PRNGKey(9)
    got_j = jpipeline.run_batches_pipelined(jp, batches, key, sample_bs=sample_bs)
    noises = [JaxChainNoise(k) for k in jax.random.split(key, len(batches))]
    got_t = tpipeline.run_batches_pipelined(tp, batches, noises, sample_bs=sample_bs)
    assert len(got_t) == len(got_j) == 2
    for bt, bj in zip(got_t, got_j):
        assert len(bt["metrics"]) == len(bj["metrics"]) == 3
        for mt, mj in zip(bt["metrics"], bj["metrics"]):
            assert set(mt) == set(mj)
            for name in mj:
                atol = 1e-4 if name.endswith("_dist") and "trans" not in name else 0.05
                np.testing.assert_allclose(mt[name], np.asarray(mj[name]), rtol=1e-3, atol=atol, err_msg=name)
        if kind == "gt_head":
            assert bt["s1"] is None and bj["s1"] is None
        else:
            for a, b in zip(bt["s1"], bj["s1"]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["stage1", "gt_head"])
def test_run_batches_pipelined_matches_sequential(kind):
    """The pipelined loop against the port's own sequential composition
    (GT prep + stage1_head_pose_batched + the floor-align + evaluate_batch
    per batch) with the same noise sources: bit for bit, as JAX's
    tests/test_eval_pipeline.py:281. run_batches_pipelined takes a TorchNoise and
    splits it; the sequential run takes the same split."""
    _, tp = _pipelines()
    batches = _batches(np.random.RandomState(6), kind)
    got = tpipeline.run_batches_pipelined(tp, batches, TorchNoise("cpu", seed=3))
    noises = TorchNoise("cpu", seed=3).split(len(batches))
    for k, batch in enumerate(batches):
        if kind == "gt_head":
            gq, gp, head = tpipeline.gt_from_smpl_params_batched(
                tp, batch["gt_trans"], batch["gt_root_orient"], batch["gt_body_pose"])
            hp = head.numpy()
        else:
            gq, gp, head = tpipeline.gt_from_qpos_batched(tp, batch["gt_qpos"])
            s1 = tp.stage1_head_pose_batched(batch["records"])
            hp = s1["head_pose"].numpy()[:, :batch["gt_head_pose"].shape[1]].copy()
            hp[:, :, :3] += gp[:, 0:1, 15].numpy() - hp[:, 0:1, :3]
            for i in range(len(hp)):
                want = tpipeline.stage1_metrics(s1["head_pose"][i].numpy(), batch["gt_head_pose"][i])
                np.testing.assert_allclose([v[i] for v in got[k]["s1"]], want, rtol=1e-5, atol=1e-5)
        want = tpipeline.evaluate_batch(tp, hp, gq, gp, noises[k])
        assert len(got[k]["metrics"]) == len(want)
        for g, w in zip(got[k]["metrics"], want):
            assert set(g) == set(w)
            for name in w:
                np.testing.assert_array_equal(g[name], w[name])
        assert (got[k]["s1"] is None) == (kind == "gt_head")


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_sample_microbatch_matches_jax_chunks(sampler):
    """sample_microbatch=2 over a batch of 5 (padded to 6 by repeating the
    last row, three chunks, sliced back) against JAX's ``_microbatched``,
    each chunk on its own key of split(K, 3); the DDIM case with the
    overlap inpaint. 1e-4 absolute (the chain tolerance)."""
    jdiff = JDiffusion(JConfig(**SMALL, sample_microbatch=2))
    params = jdiff.init_params(jax.random.PRNGKey(0), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)), denoiser_state_dict_from_jax(params))
    tdiff = CondGaussianDiffusion(DiffusionConfig(**SMALL, compute_dtype="float32", sample_microbatch=2),
                                  device="cpu", model=model)
    bs, t = 5, SMALL["window"]
    rng = np.random.RandomState(7)
    x_start = rng.uniform(-1, 1, (bs, t, 198)).astype(np.float32)
    value = np.zeros((bs, t, 198), np.float32)
    value[:, :3] = 0.4
    mask = np.zeros((bs, t, 1), np.float32)
    mask[:, :3] = 1.0
    key = jax.random.PRNGKey(10)
    if sampler == "ddpm":
        out_j = jdiff.p_sample_loop(params, key, jnp.asarray(x_start), j_cond_mask(bs, t))
        out_t = tdiff.p_sample_loop(torch.from_numpy(x_start), head_condition_mask(bs, t), noise=JaxKeyNoise(key))
    else:
        out_j = jdiff.p_sample_loop_ddim(params, key, jnp.asarray(x_start), j_cond_mask(bs, t), num_steps=3,
                                         inpaint_value=jnp.asarray(value), inpaint_mask=jnp.asarray(mask))
        out_t = tdiff.p_sample_loop_ddim(torch.from_numpy(x_start), head_condition_mask(bs, t), num_steps=3,
                                         inpaint_value=torch.from_numpy(value), inpaint_mask=torch.from_numpy(mask),
                                         noise=JaxKeyNoise(key))
        _close(out_t[:, :3], 0.4, 1e-6)
    assert out_t.shape == (bs, t, 198)
    _close(out_t, out_j, 1e-4)
