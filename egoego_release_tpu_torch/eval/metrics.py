"""Stage-2 metric suite on torch tensors (port of
egoego_release_tpu/eval/metrics.py ``compute_metrics_for_smpl``,
``compute_metrics_for_qpos`` and their helpers). Every function takes one
sequence with T leading, or a batch of sequences with any leading dims
before T (the JAX package vmaps instead): one batched call costs a few
dozen launches whatever the batch size."""

from __future__ import annotations

import torch

from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops import rotations as rot
from egoego_release_tpu_torch.ops.fk import HEAD_IDX


def pose_to_mat4(trans: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """(..., 3) + (..., 4) -> homogeneous (..., 4, 4); quaternions normalized."""
    m = trans.new_zeros(trans.shape[:-1] + (4, 4))
    m[..., :3, :3] = rot.quat_to_matrix(rot.quat_normalize(quat))
    m[..., :3, 3] = trans
    m[..., 3, 3] = 1.0
    return m


def _rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    rt = m[..., :3, :3].transpose(-1, -2)
    inv = torch.zeros_like(m)
    inv[..., :3, :3] = rt
    inv[..., :3, 3] = -torch.einsum("...ij,...j->...i", rt, m[..., :3, 3])
    inv[..., 3, 3] = 1.0
    return inv


def frobenius_norm_4x4(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean_t ||I - x_t y_t^-1||_F over (..., T, 4, 4)."""
    err = torch.eye(4, dtype=x.dtype, device=x.device) - x @ _rigid_inverse(y)
    return torch.sqrt((err * err).sum((-2, -1))).mean(-1)


def frobenius_norm_rot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    err = torch.eye(3, dtype=x.dtype, device=x.device) - x @ y.transpose(-1, -2)
    return torch.sqrt((err * err).sum((-2, -1))).mean(-1)


def compute_accel(joints: torch.Tensor) -> torch.Tensor:
    """mean over t, j of ||j[t+2] - 2 j[t+1] + j[t]||; joints (..., T, J, 3)."""
    accel = joints[..., 2:, :, :] - 2 * joints[..., 1:-1, :, :] + joints[..., :-2, :, :]
    return torch.linalg.norm(accel, dim=-1).mean((-2, -1))


def compute_error_accel(joints_gt: torch.Tensor, joints_pred: torch.Tensor) -> torch.Tensor:
    a_gt = joints_gt[..., :-2, :, :] - 2 * joints_gt[..., 1:-1, :, :] + joints_gt[..., 2:, :, :]
    a_pr = joints_pred[..., :-2, :, :] - 2 * joints_pred[..., 1:-1, :, :] + joints_pred[..., 2:, :, :]
    return torch.linalg.norm(a_pr - a_gt, dim=-1).mean((-2, -1))


def compute_foot_sliding(global_jpos: torch.Tensor, floor_height) -> torch.Tensor:
    """Displacement-weighted foot sliding in mm; global_jpos (..., T, 22, 3),
    floor_height a scalar or (...,)."""
    seq_len = global_jpos.shape[-3]
    floor = torch.as_tensor(floor_height, dtype=global_jpos.dtype, device=global_jpos.device)
    height = global_jpos[..., 2] - floor[..., None, None]

    def one_joint(j, thresh):
        p, h_all = global_jpos[..., j, :], height[..., j]
        disp = torch.linalg.norm(p[..., 1:, :2] - p[..., :-1, :2], dim=-1)
        h = h_all[..., :-1]
        stat = torch.abs(disp * (2.0 - 2.0 ** (h / thresh)))
        return torch.where(h < thresh, stat, torch.zeros_like(stat)).sum(-1) / seq_len * 1000.0

    return (one_joint(7, 0.08) + one_joint(10, 0.04) + one_joint(8, 0.08) + one_joint(11, 0.04)) / 4.0


def compute_metrics_for_smpl(gt_global_quat, gt_global_jpos, gt_floor_height,
                             pred_global_quat, pred_global_jpos, pred_floor_height) -> dict:
    """Full metric dict: quats (..., T, 22, 4), jpos (..., T, 22, 3), floor
    heights scalar or (...,). Each value has the leading dims (single_jpe
    adds a trailing 22)."""
    root_mat_pred = pose_to_mat4(pred_global_jpos[..., 0, :], pred_global_quat[..., 0, :])
    root_mat_gt = pose_to_mat4(gt_global_jpos[..., 0, :], gt_global_quat[..., 0, :])
    head_mat_pred = pose_to_mat4(pred_global_jpos[..., HEAD_IDX, :], pred_global_quat[..., HEAD_IDX, :])
    head_mat_gt = pose_to_mat4(gt_global_jpos[..., HEAD_IDX, :], gt_global_quat[..., HEAD_IDX, :])

    jpos_pred = pred_global_jpos - pred_global_jpos[..., 0:1, :]
    jpos_gt = gt_global_jpos - gt_global_jpos[..., 0:1, :]
    per_joint = torch.linalg.norm(jpos_pred - jpos_gt, dim=-1)  # (..., T, 22)
    single_jpe = per_joint.mean(-2) * 1000.0

    res = {
        "root_dist": frobenius_norm_4x4(root_mat_pred, root_mat_gt),
        "root_rot_dist": frobenius_norm_rot(root_mat_pred[..., :3, :3], root_mat_gt[..., :3, :3]),
        "root_trans_dist": torch.linalg.norm(
            pred_global_jpos[..., 0, :] - gt_global_jpos[..., 0, :], dim=-1).mean(-1) * 1000.0,
        "head_dist": frobenius_norm_4x4(head_mat_pred, head_mat_gt),
        "head_rot_dist": frobenius_norm_rot(head_mat_pred[..., :3, :3], head_mat_gt[..., :3, :3]),
        "head_trans_dist": torch.linalg.norm(
            pred_global_jpos[..., HEAD_IDX, :] - gt_global_jpos[..., HEAD_IDX, :], dim=-1).mean(-1) * 1000.0,
        "mpjpe": per_joint.mean((-2, -1)) * 1000.0,
        "mpjpe_wo_hand": single_jpe[..., :18].mean(-1),
        "single_jpe": single_jpe,
        "accel_pred": compute_accel(pred_global_jpos) * 1000.0,
        "accel_gt": compute_accel(gt_global_jpos) * 1000.0,
        "accel_err": compute_error_accel(pred_global_jpos, gt_global_jpos) * 1000.0,
        "pred_fs": compute_foot_sliding(pred_global_jpos, pred_floor_height),
        "gt_fs": compute_foot_sliding(gt_global_jpos, gt_floor_height),
    }
    for i in range(single_jpe.shape[-1]):
        res[f"jpe_{i}"] = single_jpe[..., i]
    return res


def compute_head_pose_metrics(head_trans, head_rot, gt_head_trans, gt_head_rot):
    """Stage-1 head metrics: head_trans (..., T, 3) and head_rot (..., T, 3,
    3) against the GT -> (mean ||I - P G^-1||_F over the 4x4 poses, the same
    over the rotations, mean translation error in mm), each (...)."""
    def mat4(trans, rot_m):
        m = trans.new_zeros(trans.shape[:-1] + (4, 4))
        m[..., :3, :3] = rot_m
        m[..., :3, 3] = trans
        m[..., 3, 3] = 1.0
        return m

    head_dist = frobenius_norm_4x4(mat4(head_trans, head_rot), mat4(gt_head_trans, gt_head_rot))
    head_rot_dist = frobenius_norm_rot(head_rot, gt_head_rot)
    head_trans_err = torch.linalg.norm(head_trans - gt_head_trans, dim=-1).mean(-1) * 1000.0
    return head_dist, head_rot_dist, head_trans_err


def compute_metrics_for_qpos(gt_qpos: torch.Tensor, pred_qpos: torch.Tensor, rest_offsets: torch.Tensor,
                             gt_floor_height=0.0, pred_floor_height=0.0) -> dict:
    """The metric suite over kinpoly qpos records (T, 76): each record goes
    through the qpos codec and the SMPL FK on ``rest_offsets`` (22, 3), then
    ``compute_metrics_for_smpl`` (JAX ``eval/metrics.py:161-189``)."""
    def fk(qpos):
        trans, aa24 = geometry.qpos_to_smpl(qpos)
        return fk_mod.fk_smpl(trans, aa24[:, :fk_mod.NUM_JOINTS], rest_offsets)

    gt_q, gt_p = fk(gt_qpos)
    pr_q, pr_p = fk(pred_qpos)
    return compute_metrics_for_smpl(gt_q, gt_p, float(gt_floor_height), pr_q, pr_p, float(pred_floor_height))
