"""HeadNet, stage 1: optical-flow features -> head rotation and SLAM scale
(port of egoego_release_tpu/models/headnet.py).

``HeadFormer`` keeps the reference's module names (``action_transformer``,
``action_va_mlp``, ``action_va_fc``, ``action_dist_mlp``,
``action_dist_fc``), so released ``state_dict``s load as they are.
``headformer_forward_for_eval`` runs all blocks of N sequences through the
transformer as one batch, the last block of each ragged and
padding-masked, then integrates the angular velocities over each whole
sequence, as the JAX package does (under ``jax.vmap`` for N > 1); that
sequential integration runs on the host, once for the batch.
``headformer_loss`` is the training loss; it integrates the predicted
velocities with ``va2rot`` on the tensors' own device, under autograd.
``HeadFormerWithCNN`` is the raw-flow HeadNet: a ResNet-18 in front of
``HeadFormer``.
"""

from __future__ import annotations

import torch
from torch import nn

from egoego_release_tpu_torch.models.mlp import MLP
from egoego_release_tpu_torch.models.resnet import ResNet18, f32_convolutions, flow_to_input
from egoego_release_tpu_torch.models.transformer import Decoder
from egoego_release_tpu_torch.ops import rotations as rot


class HeadFormer(nn.Module):
    """Transformer over per-frame OF features with two MLP heads; the
    defaults are the released run's."""

    def __init__(self, d_model: int = 256, n_layers: int = 2, n_head: int = 4, d_k: int = 256,
                 d_v: int = 256, window: int = 60, cnn_fdim: int = 512,
                 mlp_hsize: tuple[int, ...] = (1024, 512, 256)):
        super().__init__()
        self.window = window
        self.action_transformer = Decoder(cnn_fdim, d_model, n_layers, n_head, d_k, d_v,
                                          max_timesteps=window)
        self.action_va_mlp = MLP(d_model, mlp_hsize)
        self.action_va_fc = nn.Linear(mlp_hsize[-1], 3)
        self.action_dist_mlp = MLP(d_model, mlp_hsize)
        self.action_dist_fc = nn.Linear(mlp_hsize[-1], 1)

    def forward(self, of_feats: torch.Tensor, padding_mask: torch.Tensor):
        """of_feats (B, T, 512), padding_mask (B, T) 1 = real -> (head angular
        velocity (B, T, 3), distance scalar (B, T, 1))."""
        out = self.action_transformer(of_feats, padding_mask)
        va = self.action_va_fc(self.action_va_mlp(out))
        dist = self.action_dist_fc(self.action_dist_mlp(out))
        return va, dist


class HeadFormerWithCNN(HeadFormer):
    """The raw-flow HeadNet (the reference's ``input_of_feats=False``
    path): a ResNet-18 with batch-statistics BatchNorm (the reference's
    ``running_stats=False``) encodes each flow frame of (B, T, H, W, 2) to
    ``cnn_fdim`` features, all B x T frames as one batch, since BatchNorm's
    statistics span them all; then HeadFormer's transformer and heads. Its
    keys are HeadFormer's, and the ResNet's under ``cnn.``. With
    ``freeze_cnn`` (the reference's ``freeze_of_cnn``) the ResNet runs
    under ``no_grad``, so it neither keeps its activations nor gets a
    gradient, and ``trainer_stage1.freeze_subtrees`` leaves its parameters
    out of AdamW. The convolutions run in f32 (``f32_convolutions``)."""

    def __init__(self, d_model: int = 256, n_layers: int = 2, n_head: int = 4, d_k: int = 256, d_v: int = 256,
                 window: int = 60, cnn_fdim: int = 512, mlp_hsize: tuple[int, ...] = (1024, 512, 256),
                 freeze_cnn: bool = True):
        super().__init__(d_model, n_layers, n_head, d_k, d_v, window, cnn_fdim, mlp_hsize)
        self.freeze_cnn = freeze_cnn
        self.cnn = ResNet18(out_dim=cnn_fdim, running_stats=False)

    def forward(self, flow: torch.Tensor, padding_mask: torch.Tensor):
        """flow (B, T, H, W, 2), padding_mask (B, T) 1 = real -> HeadFormer's
        (head angular velocity (B, T, 3), distance scalar (B, T, 1))."""
        b, t = flow.shape[:2]
        x = flow_to_input(flow.reshape((b * t,) + flow.shape[2:]))
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_cnn), f32_convolutions():
            feats = self.cnn(x)
        return super().forward(feats.reshape(b, t, -1), padding_mask)


def va2rot(init_quat: torch.Tensor, head_vels: torch.Tensor, dt: float = 1.0 / 30.0) -> torch.Tensor:
    """Integrate angular velocity to a rotation sequence: init_quat (B, 4),
    head_vels (B, T, 3) -> (B, T+1, 4). A sequential loop of T steps; each
    step standardizes w >= 0 (pytorch3d's quaternion_multiply does), and the
    sign feeds the next step, so it is matched exactly."""
    cur = init_quat
    seq = [cur]
    for i in range(head_vels.shape[1]):
        angv = rot.quat_apply(cur, head_vels[:, i])
        new = rot.standardize_quat(rot.quat_multiply(rot.axis_angle_to_quat(angv * dt), cur))
        cur = new / torch.linalg.norm(new, dim=-1, keepdim=True)
        seq.append(cur)
    return torch.stack(seq, dim=1)


def rescale_slam_trans(slam_trans: torch.Tensor, dist_scalar: torch.Tensor):
    """Rescale SLAM trajectories (..., T, 3) to metric scale from the
    predicted per-frame displacement lengths (..., T'); entries past T-1
    are ignored. Returns (rescaled (..., T, 3), scale (...))."""
    diffs = slam_trans[..., 1:, :] - slam_trans[..., :-1, :]
    slam_abs_len = torch.linalg.norm(diffs, dim=-1)
    n = min(slam_abs_len.shape[-1], dist_scalar.shape[-1])
    scale = dist_scalar[..., :n].mean(-1) / slam_abs_len[..., :n].mean(-1)
    steps = torch.cumsum(scale[..., None, None] * diffs, dim=-2)
    rescaled = slam_trans[..., 0:1, :] + torch.cat([diffs.new_zeros(diffs.shape[:-2] + (1, 3)), steps], dim=-2)
    return rescaled, scale


def padding_mask_from_len(seq_len: torch.Tensor, window: int) -> torch.Tensor:
    """(B,) lengths -> (B, window), 1 = real."""
    return (torch.arange(window, device=seq_len.device)[None, :] < seq_len[:, None]).float()


def headformer_forward_for_eval(model: HeadFormer, of_feats: torch.Tensor, init_head_quat: torch.Tensor,
                                aligned_slam_trans: torch.Tensor, dist_scale: float = 10.0) -> dict:
    """Whole-sequence eval of N sequences: of_feats (N, T, 512),
    init_head_quat (N, 4), aligned_slam_trans (N, T', 3) (JAX: one
    sequence, vmapped). All N x ceil(T / window) blocks go through the
    transformer as one batch, the last block of each sequence ragged; the N
    integrations run in one host loop. Returns head_pose (N, T'', 7) and
    pred_scale (N,)."""
    n, t_total = of_feats.shape[:2]
    w = model.window
    num_blocks = -(-t_total // w)
    pad = num_blocks * w - t_total
    blocks = torch.nn.functional.pad(of_feats, (0, 0, 0, pad)).reshape(n * num_blocks, w, -1)
    lens = torch.clamp(t_total - torch.arange(num_blocks, device=of_feats.device) * w, max=w).repeat(n)
    va, dist = model(blocks, padding_mask_from_len(lens, w))
    va = va.reshape(n, -1, 3)[:, :t_total]
    dist = dist.reshape(n, -1)[:, :t_total] / dist_scale
    # The integration is a chain of T dependent steps of ~55 tiny ops each:
    # on the card every op is a kernel launch, so it runs on the host CPU,
    # where each op costs less (chip_smoke.py phase 8 times both; PERF.md).
    head_quat = va2rot(init_head_quat.cpu(), va.cpu()).to(va.device)
    rescaled_trans, scale = rescale_slam_trans(aligned_slam_trans, dist)
    t_out = rescaled_trans.shape[1]
    head_pose = torch.cat([rescaled_trans, head_quat[:, :t_out]], dim=-1)
    return {"head_pose": head_pose, "pred_scale": scale}


def headformer_loss(va_pred: torch.Tensor, dist_pred: torch.Tensor, init_quat: torch.Tensor,
                    gt_head_vels: torch.Tensor, gt_head_quat: torch.Tensor, gt_head_trans: torch.Tensor,
                    w_rotation: float = 1.0, w_va: float = 1.0, w_dist: float = 1.0, dist_scale: float = 10.0):
    """The training loss (JAX: ``headformer_loss``): va_pred (B, T, 3),
    dist_pred (B, T, 1), init_quat (B, 4), gt_head_vels (B, T, 3) (angular
    part), gt_head_quat (B, T+1, 4), gt_head_trans (B, T+1, 3). The
    predicted velocities are integrated by ``va2rot`` where they lie (on
    the card: ~55 small launches a frame, forward and backward). Returns
    (loss, (orient, va, dist))."""
    pred_quat = va2rot(init_quat, va_pred)[:, 1:]
    va_loss = ((gt_head_vels - va_pred) ** 2).sum(-1).mean()
    diff = rot.quat_multiply(gt_head_quat[:, 1:], rot.quat_invert(pred_quat))
    iden = diff.new_tensor([1.0, 0.0, 0.0, 0.0])
    orient_loss = ((diff.abs() - iden) ** 2).sum(-1).mean()
    gt_dist = torch.linalg.norm(gt_head_trans[:, 1:] - gt_head_trans[:, :-1], dim=-1) * dist_scale
    dist_loss = ((dist_pred[..., 0] - gt_dist) ** 2).mean()
    loss = w_rotation * orient_loss + w_va * va_loss + w_dist * dist_loss
    return loss, (orient_loss, va_loss, dist_loss)
