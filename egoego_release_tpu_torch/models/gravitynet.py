"""GravityNet, stage 1: SLAM trajectory -> floor normal (port of
egoego_release_tpu/models/gravitynet.py). ``HeadNormalFormer`` keeps the
reference's module names (``action_transformer``, ``action_normal_mlp``,
``action_normal_fc``)."""

from __future__ import annotations

import torch
from torch import nn

from egoego_release_tpu_torch.models.mlp import MLP
from egoego_release_tpu_torch.models.transformer import Decoder
from egoego_release_tpu_torch.ops import alignment
from egoego_release_tpu_torch.ops import rotations as rot

FEAT_DIM = 6 + 3 + 6 + 3


def slam_traj_features(slam_rot_mat: torch.Tensor, slam_trans: torch.Tensor) -> torch.Tensor:
    """(B, T+1, 3, 3) + (B, T+1, 3) -> (B, T, 18): rot6d, trans, frame-diff
    rot6d, frame-diff trans."""
    rot6d = rot.matrix_to_rot6d(slam_rot_mat)
    rot_diff = torch.matmul(slam_rot_mat[:, 1:], slam_rot_mat[:, :-1].transpose(-1, -2))
    trans_diff = slam_trans[:, 1:] - slam_trans[:, :-1]
    return torch.cat([rot6d[:, :-1], slam_trans[:, :-1], rot.matrix_to_rot6d(rot_diff), trans_diff], dim=-1)


class HeadNormalFormer(nn.Module):
    """Transformer over SLAM-trajectory features; the floor normal is read
    from the first token. The defaults are the released run's."""

    def __init__(self, d_model: int = 256, n_layers: int = 2, n_head: int = 4, d_k: int = 256,
                 d_v: int = 256, window: int = 120, mlp_hsize: tuple[int, ...] = (512, 256)):
        super().__init__()
        self.window = window
        self.action_transformer = Decoder(FEAT_DIM, d_model, n_layers, n_head, d_k, d_v,
                                          max_timesteps=window)
        self.action_normal_mlp = MLP(d_model, mlp_hsize)
        self.action_normal_fc = nn.Linear(mlp_hsize[-1], 3)

    def forward(self, feats: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        """feats (B, T <= window, 18), padding_mask (B, T) -> normal (B, 3)."""
        out = self.action_transformer(feats, padding_mask)
        return self.action_normal_fc(self.action_normal_mlp(out[:, 0, :]))


def prep_gravitynet_input(slam_rot_mat: torch.Tensor, slam_trans: torch.Tensor, window: int):
    """Crop or zero-pad (B, T+1, 3, 3) + (B, T+1, 3) trajectories to the
    model window: (feats (B, window, 18), padding_mask (B, window))."""
    slam_rot_mat, slam_trans = slam_rot_mat[:, : window + 1], slam_trans[:, : window + 1]
    feats = slam_traj_features(slam_rot_mat, slam_trans)
    t = feats.shape[1]
    feats = torch.nn.functional.pad(feats, (0, 0, 0, window - t))
    mask = (torch.arange(window, device=feats.device) < t).float()
    return feats, mask[None].expand(feats.shape[0], window)


def gravitynet_eval_transform(pred_normal: torch.Tensor, slam_rot_mat: torch.Tensor,
                              slam_trans: torch.Tensor, scale: torch.Tensor,
                              gt_head_pose: torch.Tensor) -> dict:
    """Gravity-align and rescale SLAM trajectories (..., T, 3, 3) +
    (..., T, 3), then remove the heading ambiguity by an xy-plane Umeyama
    alignment against the GT head pose (..., T_ref, 7); pred_normal
    (..., 3), scale (...). One sequence, or N with a leading N (one batched
    host solve). Returns head_pose (..., T, 7), head_trans, head_rot_mat and
    the GT pass-throughs."""
    aligned_rot = alignment.rotation_from_floor_normal(pred_normal)
    scale = torch.as_tensor(scale, dtype=slam_trans.dtype, device=slam_trans.device)
    trans_diff = slam_trans[..., 1:, :] - slam_trans[..., :-1, :]
    diff_rs = torch.einsum("...ij,...tj->...ti", aligned_rot, trans_diff) * scale[..., None, None]
    trans_rs = slam_trans[..., 0:1, :] + torch.cat(
        [diff_rs.new_zeros(diff_rs.shape[:-2] + (1, 3)), torch.cumsum(diff_rs, dim=-2)], dim=-2)
    slam_rot_aligned = torch.einsum("...ij,...tjk->...tik", aligned_rot, slam_rot_mat)
    slam_quat_aligned = rot.matrix_to_quat(slam_rot_aligned)

    t_ref = gt_head_pose.shape[-2]
    traj_est = torch.cat([trans_rs, slam_quat_aligned], dim=-1)[..., :t_ref, :]
    r_xy, _, _ = alignment.align_xy_plane_traj(traj_est, gt_head_pose)

    de_rot = torch.einsum("...ij,...tjk->...tik", r_xy, slam_rot_aligned)
    de_trans = (torch.einsum("...ij,...tj->...ti", r_xy, trans_rs - trans_rs[..., 0:1, :])
                + gt_head_pose[..., 0:1, :3])
    return {
        "head_trans": de_trans,
        "head_rot_mat": de_rot,
        "head_pose": torch.cat([de_trans, rot.matrix_to_quat(de_rot)], dim=-1),
        "gt_head_trans": gt_head_pose[..., :3],
        "gt_head_rot_mat": rot.quat_to_matrix(gt_head_pose[..., 3:]),
        "gt_head_pose": gt_head_pose,
    }


def gravitynet_eval_upper_bound(gt_aligned_rot_mat: torch.Tensor, slam_rot_mat: torch.Tensor,
                                slam_trans: torch.Tensor, gt_scale, gt_head_trans0: torch.Tensor) -> dict:
    """The oracle upper bound: the GT gravity rotation (3, 3) and GT inverse
    scale applied to a SLAM trajectory (T, 3, 3) + (T, 3), from the GT
    first-frame head translation (3,): how much error comes from
    GravityNet's predictions and how much from SLAM itself."""
    trans_diff = slam_trans[1:] - slam_trans[:-1]
    diff_rs = torch.einsum("ij,tj->ti", gt_aligned_rot_mat, trans_diff) * gt_scale
    trans_rs = gt_head_trans0 + torch.cat([diff_rs.new_zeros(1, 3), torch.cumsum(diff_rs, dim=0)])
    rot_aligned = torch.einsum("ij,tjk->tik", gt_aligned_rot_mat, slam_rot_mat)
    return {
        "head_trans": trans_rs,
        "head_rot_mat": rot_aligned,
        "head_pose": torch.cat([trans_rs, rot.matrix_to_quat(rot_aligned)], dim=-1),
    }


def gravitynet_loss(pred_normal: torch.Tensor, gt_normal: torch.Tensor) -> torch.Tensor:
    """The L1 normal loss: |gt - pred| summed over xyz, then the mean."""
    return (gt_normal - pred_normal).abs().sum(-1).mean()
