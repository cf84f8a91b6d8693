"""Trajectory alignment (Umeyama) and SLAM-trajectory preparation (port of
egoego_release_tpu/ops/alignment.py).

The 3x3 SVD of ``umeyama`` runs on the host in float64, whatever device
the points are on: one batched solve for all the sequences of a batch,
exact enough that the det-sign correction picks the same rotation as the
JAX package's f32 solve.
That correction is what keeps R unique when the covariance has a zero
singular value, as it always has in ``align_xy_plane_traj`` (z is pinned
to 1, so the centred z column is zero): the sign of the third singular
vectors is arbitrary there, and R = U diag(1, 1, det(U) det(V)) V^T does
not depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

from egoego_release_tpu_torch.ops import rotations as rot


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """Least-squares similarity transform dst ~= s R src + t with the
    reflection (det) correction. src, dst (..., P, 3) -> (R (..., 3, 3),
    t (..., 3), s (...)), in src's dtype and on its device: one batched
    float64 solve for all leading dims on the host (LAPACK's SVD, as
    numpy's), in torch ops so that ``torch.export`` records it."""
    a = src.detach().cpu().double()
    b = dst.detach().cpu().double()
    mu_a, mu_b = a.mean(-2, keepdim=True), b.mean(-2, keepdim=True)
    ac, bc = a - mu_a, b - mu_b
    cov = bc.transpose(-1, -2) @ ac / a.shape[-2]
    var_a = (ac * ac).sum(-1).mean(-1)
    u, d, vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.cat([torch.ones_like(d[..., :2]), sign[..., None]], -1)
    r = (u * diag[..., None, :]) @ vt
    scale = (d * diag).sum(-1) / var_a.clamp_min(1e-12) if with_scale else torch.ones_like(var_a)
    t = mu_b[..., 0, :] - scale[..., None] * torch.einsum("...ij,...j->...i", r, mu_a[..., 0, :])
    out = lambda x: x.to(dtype=src.dtype, device=src.device)
    return out(r), out(t), out(scale)


def align_xy_plane_traj(traj_est: torch.Tensor, traj_ref: torch.Tensor):
    """xy-plane alignment with scale of (..., T, 7) trajectories (trans +
    quat wxyz): both z coordinates pinned to 1 before the Umeyama solve, so
    the fit is a rotation about z with an in-plane translation and scale.
    Returns (R (..., 3, 3), aligned estimate positions (..., T, 3),
    reference positions (..., T, 3))."""
    est_pos = traj_est[..., :3].clone()
    est_pos[..., 2] = 1.0
    ref_pos = traj_ref[..., :3].clone()
    ref_pos[..., 2] = 1.0
    r, t, s = umeyama(est_pos, ref_pos, with_scale=True)
    return r, s[..., None, None] * (est_pos @ r.transpose(-1, -2)) + t[..., None, :], ref_pos


def align_slam_to_first_frame(slam_trans: torch.Tensor, slam_quat: torch.Tensor,
                              gt_head_pose0: torch.Tensor):
    """Rotate and translate a SLAM trajectory (T, 3) + (T, 4) wxyz so its
    first frame matches the GT head pose (7,). Returns (trans (T, 3),
    rot_mat (T, 3, 3), quat (T, 4))."""
    slam_rot_mat = rot.quat_to_matrix(slam_quat)
    pred2gt = rot.quat_to_matrix(gt_head_pose0[3:]) @ slam_rot_mat[0].T
    aligned_mat = torch.einsum("ij,tjk->tik", pred2gt, slam_rot_mat)
    aligned_trans = torch.einsum("ij,tj->ti", pred2gt, slam_trans)
    aligned_trans = aligned_trans + (gt_head_pose0[:3] - aligned_trans[0])
    return aligned_trans, aligned_mat, rot.matrix_to_quat(aligned_mat)


def align_slam_to_first_frame_np(slam_trans, slam_quat, gt_head_pose0):
    """Numpy twin of ``align_slam_to_first_frame`` for the data loaders."""
    slam_trans = np.asarray(slam_trans, np.float32)
    gt_head_pose0 = np.asarray(gt_head_pose0, np.float32)
    slam_rot_mat = rot.quat_to_matrix_np(slam_quat)
    pred2gt = rot.quat_to_matrix_np(gt_head_pose0[3:]) @ slam_rot_mat[0].T
    aligned_mat = np.einsum("ij,tjk->tik", pred2gt, slam_rot_mat)
    aligned_quat = rot.matrix_to_quat_np(aligned_mat)
    aligned_trans = np.einsum("ij,tj->ti", pred2gt, slam_trans)
    aligned_trans = aligned_trans + (gt_head_pose0[:3] - aligned_trans[0])
    return (aligned_trans.astype(np.float32), aligned_mat.astype(np.float32),
            aligned_quat.astype(np.float32))


def rotation_matrix_from_two_vectors(vec1: torch.Tensor, vec2: torch.Tensor) -> torch.Tensor:
    """Rotation taking the direction of vec1 to that of vec2 (Rodrigues);
    (..., 3) each -> (..., 3, 3)."""
    vec1, vec2 = torch.broadcast_tensors(vec1, vec2)
    a = vec1 / torch.linalg.norm(vec1, dim=-1, keepdim=True).clamp_min(1e-12)
    b = vec2 / torch.linalg.norm(vec2, dim=-1, keepdim=True).clamp_min(1e-12)
    v = torch.linalg.cross(a, b, dim=-1)
    c = (a * b).sum(-1)
    s2 = torch.sum(v * v, dim=-1).clamp_min(1e-20)
    z = torch.zeros_like(c)
    v0, v1, v2 = v.unbind(-1)
    kmat = torch.stack([torch.stack([z, -v2, v1], -1), torch.stack([v2, z, -v0], -1),
                        torch.stack([-v1, v0, z], -1)], -2)
    eye = torch.eye(3, dtype=vec1.dtype, device=vec1.device)
    return eye + kmat + (kmat @ kmat) * ((1.0 - c) / s2)[..., None, None]


def rotation_from_floor_normal(pred_floor_normal: torch.Tensor) -> torch.Tensor:
    """Gravity-align rotation taking a predicted floor normal (..., 3) to +z."""
    return rotation_matrix_from_two_vectors(pred_floor_normal, pred_floor_normal.new_tensor([0.0, 0.0, 1.0]))
