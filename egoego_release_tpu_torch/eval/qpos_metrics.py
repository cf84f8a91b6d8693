"""The kinpoly qpos-record metric suite (port of
egoego_release_tpu/eval/qpos_metrics.py): the reference's ``compute_metrics``
(kinpoly/scripts/eval_metrics_imu_rec.py:123-221) with its qpos-space foot
sliding, whose FK goes through ``ops.mujoco_xml.qpos_fk`` instead of a
simulator. The records are host numpy, as in JAX; the FK of each take runs
on the skeleton's device in f32, the rest in float64 numpy.

Input: {take: {"qpos" (T, 76), "qpos_gt" (T, 76), "head_pose_gt" (T, 7)}}.
"""

from __future__ import annotations

import numpy as np
import torch

from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops import rotations as rot
from egoego_release_tpu_torch.ops.mujoco_xml import MujocoSkeleton, qpos_fk

# qpos-space foot-sliding constants (eval_metrics_imu_rec.py:385-386)
FS_H = 0.033
FS_Z_THRESHOLD = 0.65


def norm_qpos(qpos: np.ndarray) -> np.ndarray:
    """Unit-normalize the root quaternion columns of a (T, 76) record
    (JAX ``eval/qpos_metrics.py:30``)."""
    out = np.asarray(qpos, np.float64).copy()
    out[:, 3:7] /= np.linalg.norm(out[:, 3:7], axis=1)[:, None]
    return out


def trans_to_velocity(root_trans: np.ndarray) -> np.ndarray:
    """Root translation (T, 3) -> per-frame velocity (T-1, 3) (JAX
    ``eval/qpos_metrics.py:39``)."""
    root_trans = np.asarray(root_trans)
    return root_trans[1:] - root_trans[:-1]


def velocity_to_trans(init_root_trans: np.ndarray, root_velocity: np.ndarray) -> np.ndarray:
    """Integrate per-frame root velocities from ``init_root_trans`` (JAX
    ``eval/qpos_metrics.py:46``)."""
    init = np.asarray(init_root_trans, np.float64)
    vel = np.asarray(root_velocity, np.float64)
    return np.concatenate([init[None], init[None] + np.cumsum(vel, axis=0)])


def qvel_fd_heading(qpos: np.ndarray, dt: float) -> np.ndarray:
    """Per-frame qvel (T-1, 75): the root's linear velocity in the heading
    frame, its angular velocity in the root frame, the joints' finite
    differences; f32, as JAX (JAX ``eval/qpos_metrics.py:55``)."""
    q = torch.as_tensor(np.asarray(qpos), dtype=torch.float32)
    v = geometry.transform_vec((q[1:, :3] - q[:-1, :3]) / dt, q[:-1, 3:7], "heading")
    qrel = rot.quat_multiply(q[1:, 3:7], rot.quat_invert(q[:-1, 3:7]))
    rv = geometry.transform_vec(rot.quat_to_axis_angle(rot.standardize_quat(qrel)) / dt, q[:-1, 3:7], "root")
    return torch.cat([v, rv, (q[1:, 7:] - q[:-1, 7:]) / dt], dim=-1).numpy()


def qpos_foot_sliding(foot_pos: np.ndarray, qpos: np.ndarray) -> float:
    """Foot displacement weighted by 2 - 2^(h/H), the foot grounded by its
    first three frames' mean height, counted only while it is low and the
    root is up (JAX ``eval/qpos_metrics.py:68``)."""
    seq_len = len(qpos)
    z = qpos[1:, 2]
    foot = np.asarray(foot_pos, np.float64).copy()
    foot[:, -1] -= np.mean(foot[:3, -1])
    disp = np.linalg.norm(foot[1:, :2] - foot[:-1, :2], axis=1)
    avg_h = (foot[:-1, -1] + foot[1:, -1]) / 2
    subset = np.logical_and(avg_h < FS_H, z > FS_Z_THRESHOLD)
    stats = np.abs(disp * (2 - 2 ** (avg_h / FS_H)))[subset]
    return float(np.sum(stats) / seq_len * 1000)


def _pose_mat4(trans: np.ndarray, quat: np.ndarray) -> np.ndarray:
    """(T, 3) + (T, 4) -> (T, 4, 4); the rotation in f32 (JAX
    ``eval/qpos_metrics.py:84``)."""
    mats = np.tile(np.eye(4), (trans.shape[0], 1, 1))
    mats[:, :3, :3] = rot.quat_to_matrix(torch.as_tensor(np.asarray(quat), dtype=torch.float32)).numpy()
    mats[:, :3, 3] = trans
    return mats


def _frob(x: np.ndarray, y: np.ndarray) -> float:
    """mean_t ||I - x_t y_t^-1||_F (JAX ``eval/qpos_metrics.py:91``)."""
    err = np.matmul(x, np.linalg.inv(y))
    return float(np.linalg.norm(np.eye(x.shape[-1]) - err, ord="fro", axis=(1, 2)).mean())


def _fk_take(skeleton: MujocoSkeleton, qpos: np.ndarray):
    """Body positions, the head pose and both toes of one take (JAX
    ``eval/qpos_metrics.py:98``)."""
    quat, pos = qpos_fk(skeleton, torch.as_tensor(np.asarray(qpos), dtype=torch.float32,
                                                  device=skeleton.offsets.device))
    quat, pos = quat.cpu().numpy(), pos.cpu().numpy()
    head, l_toe, r_toe = (skeleton.body_names.index(n) for n in ("Head", "L_Toe", "R_Toe"))
    return pos, np.concatenate([pos[:, head], quat[:, head]], axis=-1), pos[:, l_toe], pos[:, r_toe]


def compute_metrics_for_qpos_records(results: dict, skeleton: MujocoSkeleton, dt: float = 1.0 / 30.0) -> dict:
    """The reference's ``compute_metrics`` over {take: {qpos, qpos_gt,
    head_pose_gt}}: the mean of the per-take metrics (JAX
    ``eval/qpos_metrics.py:108``)."""
    agg: dict[str, list] = {}

    def add(key, val):
        agg.setdefault(key, []).append(val)

    for res in results.values():
        traj_pred = np.asarray(res["qpos"], np.float64)
        traj_gt = np.asarray(res["qpos_gt"], np.float64)
        head_pose_gt = np.asarray(res["head_pose_gt"], np.float64)

        vels_gt = qvel_fd_heading(traj_gt, dt)
        vels_pred = qvel_fd_heading(traj_pred, dt)
        jpos_pred, head_pose, l_toe_p, r_toe_p = _fk_take(skeleton, traj_pred)
        jpos_gt, _, l_toe_g, r_toe_g = _fk_take(skeleton, traj_gt)

        root_pred = _pose_mat4(traj_pred[:, :3], traj_pred[:, 3:7])
        root_gt = _pose_mat4(traj_gt[:, :3], traj_gt[:, 3:7])
        head_pred = _pose_mat4(head_pose[:, :3], head_pose[:, 3:])
        head_gt = _pose_mat4(head_pose_gt[:, :3], head_pose_gt[:, 3:])
        add("root_dist", _frob(root_pred, root_gt))
        add("root_rot_dist", _frob(root_pred[:, :3, :3], root_gt[:, :3, :3]))
        add("head_dist", _frob(head_pred, head_gt))
        add("head_rot_dist", _frob(head_pred[:, :3, :3], head_gt[:, :3, :3]))
        add("vel_dist", float(np.linalg.norm(vels_pred - vels_gt, axis=1).mean()))

        accel_gt = jpos_gt[:-2] - 2 * jpos_gt[1:-1] + jpos_gt[2:]
        accel_pr = jpos_pred[:-2] - 2 * jpos_pred[1:-1] + jpos_pred[2:]
        add("accel_dist", float(np.linalg.norm(accel_pr - accel_gt, axis=2).mean() * 1000))

        per_joint = np.linalg.norm((jpos_pred - jpos_pred[:, 0:1]) - (jpos_gt - jpos_gt[:, 0:1]), axis=2)
        single_jpe = per_joint.mean(axis=0) * 1000
        add("mpjpe", float(per_joint.mean() * 1000))
        add("mpjpe_wo_hand", float(single_jpe[:18].mean()))
        add("single_jpe", single_jpe)
        for i in range(single_jpe.shape[0]):
            add(f"jpe_{i}", float(single_jpe[i]))

        add("root_trans_dist", float(np.linalg.norm(traj_pred[:, :3] - traj_gt[:, :3], axis=1).mean() * 1000))
        add("head_trans_dist", float(np.linalg.norm(head_pose[:, :3] - head_pose_gt[:, :3], axis=1).mean() * 1000))
        add("slide_pred", (qpos_foot_sliding(l_toe_p, traj_pred) + qpos_foot_sliding(r_toe_p, traj_pred)) / 2)
        add("slide_gt", (qpos_foot_sliding(l_toe_g, traj_gt) + qpos_foot_sliding(r_toe_g, traj_gt)) / 2)

    return {k: np.mean(v) for k, v in agg.items()}
