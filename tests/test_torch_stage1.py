"""The port's stage 1 (HeadNet, GravityNet, alignment, the qpos codec, the
head-pose metrics and EgoEgoPipeline.stage1_head_pose) against the JAX
package on the CPU, on the same weights (carried across by
``*_state_dict_from_jax``) and numpy inputs, at small widths.

Tolerance 1e-4 absolute: f32 rounding carried through two transformer
blocks, a sequential quaternion integration over the sequence and a 3x3
SVD (float64 on the port's side, f32 on the JAX side).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.eval import metrics as jmetrics
from egoego_release_tpu.eval import pipeline as jpipeline
from egoego_release_tpu.models import gravitynet as jgn
from egoego_release_tpu.models import headnet as jhn
from egoego_release_tpu.ops import alignment as jal
from egoego_release_tpu.ops import geometry as jgeo
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu.utils import torch_ckpt
from egoego_release_tpu_torch.eval import metrics as tmetrics
from egoego_release_tpu_torch.eval import pipeline as tpipeline
from egoego_release_tpu_torch.models import gravitynet as tgn
from egoego_release_tpu_torch.models import headnet as thn
from egoego_release_tpu_torch.ops import alignment as tal
from egoego_release_tpu_torch.ops import geometry as tgeo
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.utils.convert import (
    gravitynet_state_dict_from_jax,
    headformer_state_dict_from_jax,
    load_denoiser_weights,
    load_stage1_ckpt,
)

ATOL = 1e-4
HN = dict(d_model=32, n_layers=2, n_head=2, d_k=16, d_v=16, mlp_hsize=(64, 32))
GN = dict(d_model=32, n_layers=2, n_head=2, d_k=16, d_v=16, window=24, mlp_hsize=(48, 32))

t_ = lambda a: torch.from_numpy(np.array(a, np.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def _unit_quats(rng, *shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _models(window):
    jh = jhn.HeadFormer(**HN, window=window)
    hp = jh.init(jax.random.PRNGKey(1), jnp.zeros((1, window, 512)), jnp.ones((1, window)))
    th = load_denoiser_weights(thn.HeadFormer(**HN, window=window), headformer_state_dict_from_jax(hp)).eval()
    jg = jgn.HeadNormalFormer(**GN)
    gp = jg.init(jax.random.PRNGKey(2), jnp.zeros((1, GN["window"], 18)), jnp.ones((1, GN["window"])))
    tg = load_denoiser_weights(tgn.HeadNormalFormer(**GN), gravitynet_state_dict_from_jax(gp)).eval()
    return (jh, hp, th), (jg, gp, tg)


def test_va2rot_and_rescale_match_jax():
    """Large angular velocities, so that w changes sign and the
    standardization feeds back through the integration."""
    rng = np.random.RandomState(0)
    init = _unit_quats(rng, 3)
    vels = (rng.randn(3, 40, 3) * 30.0).astype(np.float32)
    _close(thn.va2rot(t_(init), t_(vels)), jhn.va2rot(jnp.asarray(init), jnp.asarray(vels)))
    trans = np.cumsum(rng.randn(41, 3), 0).astype(np.float32)
    dist = rng.rand(45).astype(np.float32)
    for a, b in zip(thn.rescale_slam_trans(t_(trans), t_(dist)),
                    jhn.rescale_slam_trans(jnp.asarray(trans), jnp.asarray(dist))):
        _close(a, b)


def test_headformer_forward_for_eval_matches_jax():
    """Two blocks of window 8 through the transformer at once, the second
    ragged (13 frames)."""
    (jh, hp, th), _ = _models(8)
    rng = np.random.RandomState(1)
    of = rng.randn(1, 13, 512).astype(np.float32)
    init = _unit_quats(rng, 1)
    slam = np.cumsum(rng.randn(14, 3) * 0.05, 0).astype(np.float32)
    out_j = jhn.headformer_forward_for_eval(jh, hp, jnp.asarray(of), jnp.asarray(init), jnp.asarray(slam))
    with torch.no_grad():
        out_t = thn.headformer_forward_for_eval(th, t_(of), t_(init), t_(slam)[None])
    assert out_t["head_pose"].shape == (1, 14, 7) and out_t["pred_scale"].shape == (1,)
    _close(out_t["head_pose"], out_j["head_pose"])
    _close(out_t["pred_scale"][0], out_j["pred_scale"])


def _slam(rng, t):
    quat = _unit_quats(rng, t)
    return np.cumsum(rng.randn(t, 3) * 0.05, 0).astype(np.float32), quat, jrot.quat_to_matrix_np(quat)


@pytest.mark.parametrize("t_plus_1", [17, 31])
def test_gravitynet_matches_jax(t_plus_1):
    """prep_gravitynet_input (padded below the window of 24, cropped above),
    HeadNormalFormer and gravitynet_eval_transform."""
    _, (jg, gp, tg) = _models(8)
    rng = np.random.RandomState(t_plus_1)
    trans, _, mat = _slam(rng, t_plus_1)
    feats_j, mask_j = jgn.prep_gravitynet_input(jnp.asarray(mat)[None], jnp.asarray(trans)[None], GN["window"])
    feats_t, mask_t = tgn.prep_gravitynet_input(t_(mat)[None], t_(trans)[None], GN["window"])
    _close(feats_t, feats_j, atol=1e-6)
    _close(mask_t, mask_j, atol=0)
    with torch.no_grad():
        normal_t = tg(feats_t, mask_t)[0]
    normal_j = jg.apply(gp, feats_j, mask_j)[0]
    _close(normal_t, normal_j)
    gt = np.concatenate([np.cumsum(rng.randn(t_plus_1 - 2, 3) * 0.05, 0), _unit_quats(rng, t_plus_1 - 2)],
                        -1).astype(np.float32)
    out_t = tgn.gravitynet_eval_transform(normal_t, t_(mat), t_(trans), torch.tensor(1.7), t_(gt))
    out_j = jgn.gravitynet_eval_transform(jnp.asarray(normal_t.numpy()), jnp.asarray(mat), jnp.asarray(trans),
                                          jnp.float32(1.7), jnp.asarray(gt))
    assert set(out_t) == set(out_j)
    for k in out_j:
        _close(out_t[k], out_j[k], atol=1e-4)


def _umeyama_case(case, rng):
    src = rng.randn(30, 3).astype(np.float32)
    if case == "reflection":  # dst is a mirror image: the det correction must flip the last axis
        dst = (src * np.float32([1.0, 1.0, -1.0])) @ jrot.quat_to_matrix_np(_unit_quats(rng, 1))[0].T + 0.3
        return src, dst.astype(np.float32)
    r = jrot.quat_to_matrix_np(_unit_quats(rng, 1))[0]
    if case == "z_pinned":  # rank-2 covariance: both z columns pinned to 1, dst turned about z
        src[:, 2] = 1.0
        c, s = np.cos(0.7), np.sin(0.7)
        r = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    dst = (1.7 * src @ r.T + np.float32([0.5, -0.2, 1.0]) + rng.randn(30, 3) * 0.01).astype(np.float32)
    if case == "z_pinned":
        dst[:, 2] = 1.0
    return src, dst


@pytest.mark.parametrize("case", ["general", "reflection", "z_pinned"])
def test_umeyama_matches_jax(case):
    src, dst = _umeyama_case(case, np.random.RandomState(3))
    out_t = tal.umeyama(t_(src), t_(dst))
    out_j = jal.umeyama(jnp.asarray(src), jnp.asarray(dst))
    for a, b in zip(out_t, out_j):
        _close(a, b)
    r = out_t[0].double()
    assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5
    if case == "z_pinned":
        _close(r[2].numpy(), [0.0, 0.0, 1.0], atol=1e-6)  # a rotation about z


def test_align_xy_plane_and_first_frame_match_jax():
    rng = np.random.RandomState(4)
    est = np.concatenate([np.cumsum(rng.randn(25, 3) * 0.1, 0), _unit_quats(rng, 25)], -1).astype(np.float32)
    ref = np.concatenate([np.cumsum(rng.randn(25, 3) * 0.1, 0), _unit_quats(rng, 25)], -1).astype(np.float32)
    for a, b in zip(tal.align_xy_plane_traj(t_(est), t_(ref)),
                    jal.align_xy_plane_traj(jnp.asarray(est), jnp.asarray(ref))):
        _close(a, b)
    trans, quat, _ = _slam(rng, 12)
    for a, b, c in zip(tal.align_slam_to_first_frame(t_(trans), t_(quat), t_(ref[0])),
                       tal.align_slam_to_first_frame_np(trans, quat, ref[0]),
                       jal.align_slam_to_first_frame(jnp.asarray(trans), jnp.asarray(quat), jnp.asarray(ref[0]))):
        _close(a, c, atol=1e-5)
        _close(b, c, atol=1e-5)
    _close(tal.rotation_from_floor_normal(t_([0.1, -0.3, 0.9])),
           jal.rotation_from_floor_normal(jnp.asarray([0.1, -0.3, 0.9])), atol=1e-6)


def test_qpos_codec_and_head_pose_metrics_match_jax():
    rng = np.random.RandomState(5)
    qpos = rng.uniform(-0.5, 0.5, (9, 76)).astype(np.float32)
    qpos[:, 3:7] = _unit_quats(rng, 9)
    for a, b in zip(tgeo.qpos_to_smpl(t_(qpos)), jgeo.qpos_to_smpl(jnp.asarray(qpos))):
        _close(a, b, atol=1e-5)
    assert np.array_equal(tgeo.MUJOCO2SMPL_JOINT_IDX, jgeo.MUJOCO2SMPL_JOINT_IDX)
    pred = np.concatenate([rng.randn(20, 3), _unit_quats(rng, 20)], -1).astype(np.float32)
    gt = np.concatenate([rng.randn(22, 3), _unit_quats(rng, 22)], -1).astype(np.float32)
    args = (pred[:, :3], jrot.quat_to_matrix_np(pred[:, 3:]), gt[:20, :3], jrot.quat_to_matrix_np(gt[:20, 3:]))
    for a, b in zip(tmetrics.compute_head_pose_metrics(*map(t_, args)),
                    jmetrics.compute_head_pose_metrics(*map(jnp.asarray, args))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-6)  # mm: f32 ulps
    np.testing.assert_allclose(tpipeline.stage1_metrics(pred, gt), jpipeline.stage1_metrics(pred, gt),
                               atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("window", [8, 256])
def test_stage1_head_pose_matches_jax(window, monkeypatch):
    """EgoEgoPipeline.stage1_head_pose end to end: HeadNet blocks of 8
    frames (einsum attention), and of 256 (the port routes every HeadNet
    layer to fused_attention, plain on the CPU; JAX runs its einsum path on
    the CPU, the same function)."""
    from egoego_release_tpu_torch.models import transformer as ttr

    (jh, hp, th), (jg, gp, tg) = _models(window)
    rng = np.random.RandomState(window)
    t = 270 if window == 256 else 20
    trans, quat, mat = _slam(rng, t + 1)
    head_pose = np.concatenate([np.cumsum(rng.randn(t + 1, 3) * 0.02, 0) + [0, 0, 1.5], _unit_quats(rng, t + 1)],
                               -1).astype(np.float32)
    a_trans, _, _ = jal.align_slam_to_first_frame_np(trans, quat, head_pose[0])
    record = {"of": rng.randn(t, 512).astype(np.float32), "head_pose": head_pose,
              "aligned_slam_trans": a_trans, "ori_slam_trans": trans, "ori_slam_rot_mat": mat}
    jp = jpipeline.EgoEgoPipeline(diffusion=None, diffusion_params=None, stats=None, rest_offsets=None,
                                  headnet=jh, headnet_params=hp, gravitynet=jg, gravitynet_params=gp)
    tp = tpipeline.EgoEgoPipeline(diffusion=SimpleNamespace(device=torch.device("cpu")), stats=None,
                                  rest_offsets=None, headnet=th, gravitynet=tg)
    calls = []
    orig = ttr.fused_attention
    monkeypatch.setattr(ttr, "fused_attention", lambda *a: calls.append(1) or orig(*a))
    out_t = tp.stage1_head_pose(record)
    out_j = jp.stage1_head_pose(record)
    assert len(calls) == (HN["n_layers"] if window == 256 else 0)
    assert out_t["head_pose"].shape == (t + 1, 7)
    for k in ("head_pose", "pred_scale", "pred_normal"):
        _close(out_t[k], out_j[k])


@pytest.mark.parametrize("kind", ["headnet", "gravitynet"])
def test_load_stage1_ckpt_matches_jax_loader(kind, tmp_path):
    """A synthetic released .pt ({epoch, transformer_encoder_state_dict}
    with the reference's keys, plus its position table) loads into the same
    model through the port's loader as through the JAX one; a layer-count
    or width mismatch is refused."""
    (jh, hp, _), (jg, gp, _) = _models(8)
    sd = headformer_state_dict_from_jax(hp) if kind == "headnet" else gravitynet_state_dict_from_jax(gp)
    sd["action_transformer.position_vec.weight"] = torch.zeros(9, HN["d_model"])
    path = tmp_path / f"{kind}.pt"
    torch.save({"epoch": 3, "transformer_encoder_state_dict": sd}, path)
    dims = dict(d_model=32, n_head=2, d_k=16, d_v=16)
    params = torch_ckpt.load_stage1_ckpt(str(path), kind, 2, **dims)
    rng = np.random.RandomState(6)
    if kind == "headnet":
        model = load_denoiser_weights(thn.HeadFormer(**HN, window=8), load_stage1_ckpt(str(path), kind, 2, **dims))
        x, mask = rng.randn(2, 8, 512).astype(np.float32), np.ones((2, 8), np.float32)
        want = jh.apply(params, jnp.asarray(x), jnp.asarray(mask))
    else:
        model = load_denoiser_weights(tgn.HeadNormalFormer(**GN), load_stage1_ckpt(str(path), kind, 2, **dims))
        x, mask = rng.randn(2, 24, 18).astype(np.float32), np.ones((2, 24), np.float32)
        want = (jg.apply(params, jnp.asarray(x), jnp.asarray(mask)),)
    with torch.no_grad():
        got = model(t_(x), t_(mask))
    for a, b in zip(got if kind == "headnet" else (got,), want):
        _close(a, b, atol=1e-5)
    with pytest.raises(ValueError, match="layer-count"):
        load_stage1_ckpt(str(path), kind, 3, **dims)
    with pytest.raises(ValueError, match="dims mismatch"):
        load_stage1_ckpt(str(path), kind, 2, d_model=32, n_head=2, d_k=8, d_v=16)
