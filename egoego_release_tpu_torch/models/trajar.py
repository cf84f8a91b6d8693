"""TrajARNet, the kin-poly autoregressive kinematic-policy baseline (port of
egoego_release_tpu/models/trajar.py; the reference is
kinpoly/relive/models/traj_ar_smpl_net.py, model_v=1).

A context GRU over the per-step head features (head velocities and the
object's pose relative to the head, 13-d) feeds an MLP that predicts the
initial qpos refinement; then an autoregressive loop over the T frames:
the state features (``build_obs``), a step GRU, an MLP on obs || GRU
output, an 80-d action (root z, a quaternion slot, 69 joint eulers, root
linear and angular velocity) that ``step_qpos`` integrates into the next
qpos and its finite-difference qvel.

As in the JAX package, the head pose of the state comes from the SMPL FK
over ``rest_offsets`` (the buffer of the module) through the qpos codec,
not from the reference's MuJoCo-XML humanoid; ``build_obs`` also takes a
skeleton (``ops.mujoco_xml``) for that FK. The loop is a Python loop over T
under autograd (JAX scans it); the GRUs are ``nn.GRUCell`` (flax's
equations: torch's ``bias_hh`` is [0, 0, hn.bias], ``utils.convert``).
flax's cell has no hidden bias on the r and z gates, so their part of
``bias_hh`` stays 0: a gradient hook zeroes it, and Adam never moves it
(otherwise the r and z biases would move at twice JAX's rate, once in
``bias_ih`` and once in ``bias_hh``).
Nothing here reaches a kernel of the port's: the products run on cuBLAS.
"""

from __future__ import annotations

import torch
from torch import nn

from egoego_release_tpu_torch.models.init import flax_init_
from egoego_release_tpu_torch.models.mlp import MLP
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops import heading as heading_mod
from egoego_release_tpu_torch.ops import rotations as rot

QPOS_DIM = 76
QVEL_DIM = 75
ACTION_DIM = 80   # z (1) + quat (4) + eulers (69) + root linv (3) + root angv (3)
POSE_START = 7
QPOS_LM = 74
CONTEXT_DIM = 13  # head_vels (6) || obj_head_relative_poses (7)
STEP_KEYS = ("head_pose", "head_vels", "obj_pose", "obj_head_relative_poses")
ACTION_INIT_SCALE = 0.01  # the action head's initial weights, of flax's scale (init_trajar_)


def qvel_fd(qpos: torch.Tensor, next_qpos: torch.Tensor, dt: float) -> torch.Tensor:
    """Finite-difference qvel between two qpos (torch_utils.py:284-302): the
    linear velocity in the world, the root's angular velocity in the root
    frame, the joint-angle rates."""
    v = (next_qpos[:, :3] - qpos[:, :3]) / dt
    qrel = rot.quat_multiply(next_qpos[:, 3:7], rot.quat_invert(qpos[:, 3:7]))
    rv = geometry.transform_vec(rot.quat_to_axis_angle(rot.standardize_quat(qrel)) / dt, qpos[:, 3:7], "root")
    return torch.cat([v, rv, (next_qpos[:, 7:] - qpos[:, 7:]) / dt], dim=-1)


def step_qpos(qpos: torch.Tensor, action: torch.Tensor, dt: float = 1.0 / 30.0):
    """Integrate one action (traj_ar_smpl_net.py:302-345, the has_z variant;
    JAX ``models/trajar.py:38``): qpos (B, 76), action (B, 80) -> (next qpos,
    next qvel). The action's quaternion slot is overwritten by the root
    rotation integrated from its angular velocity."""
    curr_pos, curr_rot = qpos[:, :3], qpos[:, 3:7]
    root_qvel = action[:, QPOS_LM:]
    linv = rot.quat_apply(heading_mod.get_heading_quat(curr_rot), root_qvel[:, :3])
    angv = rot.quat_apply(curr_rot, root_qvel[:, 3:6])
    new_rot = rot.quat_multiply(rot.axis_angle_to_quat(angv * dt), curr_rot)
    new_rot = new_rot / torch.linalg.norm(new_rot, dim=-1, keepdim=True)
    next_qpos = torch.cat([curr_pos[:, :2] + linv[:, :2] * dt, action[:, :1], new_rot,
                           action[:, POSE_START - 2: QPOS_LM]], dim=-1)
    return next_qpos, qvel_fd(qpos, next_qpos, dt)


def inverse_step_qpos(qpos: torch.Tensor, next_qpos: torch.Tensor, dt: float = 1.0 / 30.0) -> torch.Tensor:
    """The action (B, 80) for which ``step_qpos(qpos, action, dt)`` lands on
    ``next_qpos`` (JAX ``models/trajar.py:68``): z, the (ignored) quaternion
    slot, the absolute eulers, the root's linear velocity in the heading
    frame and its angular velocity in the body frame."""
    curr_rot = qpos[:, 3:7]
    v = (next_qpos[:, :3] - qpos[:, :3]) / dt
    linv = rot.quat_apply(rot.quat_invert(heading_mod.get_heading_quat(curr_rot)), v)
    qrel = rot.standardize_quat(rot.quat_multiply(next_qpos[:, 3:7], rot.quat_invert(curr_rot)))
    angv = rot.quat_apply(rot.quat_invert(curr_rot), rot.quat_to_axis_angle(qrel) / dt)
    return torch.cat([next_qpos[:, 2:3], next_qpos[:, 3:7], next_qpos[:, 7:], linv, angv], dim=-1)


def build_obs(qpos, qvel, context_feat, data_t, rest_offsets, use_vel=True, skeleton=None, head_idx=None):
    """The state features at one step (get_obs, traj_ar_smpl_net.py:208-302;
    JAX ``models/trajar.py:96``): [context, qpos without x, y and heading,
    qvel, the head's position and rotation error, the object relative to the
    predicted head, head angular and linear velocity, the object relative to
    the target head]. The predicted head comes from the SMPL FK over
    ``rest_offsets``, or from the MuJoCo-XML FK when ``skeleton`` and
    ``head_idx`` are given."""
    if skeleton is not None:
        from egoego_release_tpu_torch.ops.mujoco_xml import qpos_fk

        gq, gp = qpos_fk(skeleton, qpos)
    else:
        trans, aa24 = geometry.qpos_to_smpl(qpos)
        gq, gp = fk_mod.fk_smpl(trans, aa24[:, :fk_mod.NUM_JOINTS], rest_offsets)
        head_idx = fk_mod.HEAD_IDX
    pred_hrot, pred_hpos = gq[:, head_idx], gp[:, head_idx]
    qpos_local = torch.cat([qpos[:, 2:3], heading_mod.de_heading(qpos[:, 3:7]), qpos[:, 7:]], dim=-1)

    t_hpos, t_hrot = data_t["head_pose"][:, :3], data_t["head_pose"][:, 3:]
    diff_hpos = geometry.transform_vec(t_hpos - pred_hpos, pred_hrot, "heading")
    diff_hrot = rot.quat_multiply(rot.quat_invert(t_hrot), pred_hrot)
    q_heading = heading_mod.get_heading_quat(pred_hrot)
    obj_pos, obj_rot = data_t["obj_pose"][:, :3], data_t["obj_pose"][:, 3:7]
    diff_obj = geometry.transform_vec(obj_pos - pred_hpos, pred_hrot, "heading")
    obj_rot_local = rot.quat_multiply(rot.quat_invert(q_heading), obj_rot)

    obs = [context_feat, qpos_local] + ([qvel] if use_vel else [])
    obs += [diff_hpos, diff_hrot, diff_obj, obj_rot_local, data_t["head_vels"][:, 3:], data_t["head_vels"][:, :3],
            data_t["obj_head_relative_poses"]]
    return torch.cat(obs, dim=-1)


def _hn_bias_only(grad: torch.Tensor) -> torch.Tensor:
    """The gradient of a GRUCell's ``bias_hh`` with its r and z parts zeroed."""
    h = grad.shape[0] // 3
    return torch.cat([torch.zeros_like(grad[:2 * h]), grad[2 * h:]])


def obs_dim(rnn_hdim: int, use_vel: bool = True) -> int:
    """Width of ``build_obs``'s features: the context, 74 of qpos, 75 of
    qvel, then 3 + 4 + 3 + 4 + 3 + 3 + 7."""
    return rnn_hdim + QPOS_LM + (QVEL_DIM if use_vel else 0) + 27


class TrajARNet(nn.Module):
    """data: head_pose (B, T, 7), head_vels (B, T, 6), obj_pose (B, T, 7),
    obj_head_relative_poses (B, T, 7) -> qpos (B, T, 76), qvel (B, T, 75)
    (JAX ``models/trajar.py:182``). The modules carry the JAX parameter
    paths' names; ``rest_offsets`` (22, 3) is a buffer that checkpoints
    leave out."""

    def __init__(self, rnn_hdim: int = 512, mlp_hsize: tuple[int, ...] = (1024, 512), use_vel: bool = True,
                 dt: float = 1.0 / 30.0, rest_offsets=None):
        super().__init__()
        if rest_offsets is None:
            raise ValueError("TrajARNet needs the skeleton's rest_offsets (22, 3)")
        self.rnn_hdim, self.mlp_hsize, self.use_vel, self.dt = rnn_hdim, tuple(mlp_hsize), use_vel, dt
        d_obs = obs_dim(rnn_hdim, use_vel)
        self.context_gru = nn.GRUCell(CONTEXT_DIM, rnn_hdim)
        self.context_mlp = MLP(rnn_hdim, self.mlp_hsize)
        self.context_fc = nn.Linear(self.mlp_hsize[-1], ACTION_DIM + QVEL_DIM)
        self.action_gru = nn.GRUCell(d_obs, rnn_hdim)
        self.action_mlp = MLP(d_obs + rnn_hdim, self.mlp_hsize)
        self.action_fc = nn.Linear(self.mlp_hsize[-1], ACTION_DIM)
        for gru in (self.context_gru, self.action_gru):
            gru.bias_hh.register_hook(_hn_bias_only)
        self.register_buffer("rest_offsets", torch.as_tensor(rest_offsets, dtype=torch.float32), persistent=False)

    def forward(self, data: dict, init_qpos: torch.Tensor | None = None) -> dict:
        b, t = data["head_pose"].shape[:2]
        ctx_in = torch.cat([data["head_vels"], data["obj_head_relative_poses"]], dim=-1)
        h = ctx_in.new_zeros(b, self.rnn_hdim)
        ctx_feats = []
        for i in range(t):
            h = self.context_gru(ctx_in[:, i], h)
            ctx_feats.append(h)

        init_feat = self.context_fc(self.context_mlp(ctx_feats[0]))
        if init_qpos is None:
            init_qpos = torch.cat([init_feat.new_zeros(b, 2), init_feat[:, :1], init_feat.new_ones(b, 1),
                                   init_feat.new_zeros(b, QPOS_DIM - 4)], dim=-1)
        qpos, qvel, state = init_qpos, init_qpos.new_zeros(b, QVEL_DIM), ctx_in.new_zeros(b, self.rnn_hdim)
        qpos_seq, qvel_seq = [], []
        for i in range(t):
            data_t = {k: data[k][:, i] for k in STEP_KEYS}
            obs = build_obs(qpos, qvel, ctx_feats[i], data_t, self.rest_offsets, self.use_vel)
            state = self.action_gru(obs, state)
            action = self.action_fc(self.action_mlp(torch.cat([obs, state], dim=-1)))
            qpos, qvel = step_qpos(qpos, action, self.dt)
            qpos_seq.append(qpos)
            qvel_seq.append(qvel)
        return {"qpos": torch.stack(qpos_seq, 1), "qvel": torch.stack(qvel_seq, 1)}


@torch.no_grad()
def init_trajar_(model: TrajARNet, generator: torch.Generator) -> TrajARNet:
    """flax's initializers (``models.init.flax_init_``) with the action head's
    weights scaled by ACTION_INIT_SCALE. At flax's scale a random policy's
    actions are O(1) per unit of its state, the joint rates they imply
    (their change over dt) feed back into that state, and a 90-frame
    rollout grows several-fold a frame until it overflows: the loss is NaN
    from the first step, as it is from the JAX CLI's init. Near-zero
    initial actions keep the rollout finite and let training start."""
    flax_init_(model, generator)
    model.action_fc.weight.mul_(ACTION_INIT_SCALE)
    return model


def _fk_qpos(qpos: torch.Tensor, rest_offsets: torch.Tensor):
    trans, aa = geometry.qpos_to_smpl(qpos.reshape(-1, QPOS_DIM))
    return fk_mod.fk_smpl(trans, aa[:, :fk_mod.NUM_JOINTS], rest_offsets)


def trajar_loss(pred: dict, gt_qpos: torch.Tensor, rest_offsets: torch.Tensor) -> torch.Tensor:
    """FK-space position loss plus qpos loss, the training loss of
    ``train_trajar`` (JAX ``models/trajar.py:228``)."""
    _, gp_p = _fk_qpos(pred["qpos"], rest_offsets)
    _, gp_g = _fk_qpos(gt_qpos, rest_offsets)
    return ((gp_p - gp_g) ** 2).sum(-1).mean() + ((pred["qpos"] - gt_qpos) ** 2).mean()


def _quat_identity_loss(gt_quat, pred_quat):
    """||abs(gt * pred^-1) - identity||^2 per row (compute_loss.py:38-44)."""
    diff = rot.quat_multiply(gt_quat, rot.quat_invert(pred_quat))
    return ((diff.abs() - diff.new_tensor([1.0, 0.0, 0.0, 0.0])) ** 2).sum(-1)


def trajar_reference_loss(pred: dict, data: dict, specs: dict | None = None):
    """The reference's TrajARNet.compute_loss (traj_ar_smpl_net.py:441-477;
    JAX ``models/trajar.py:248``), term for term: root position and
    orientation, joint eulers, root linear and angular velocity (the GT
    qvel one step ahead), whole-body positions, the object-to-head position
    and orientation. pred: qpos (B, T, 76), qvel (B, T, 75), wbpos (B, T,
    J*3), obj_2_head (B, T, 7); data: the same (GT) and
    obj_head_relative_poses. Returns (loss, the 8 terms)."""
    s = specs or {}
    w_rp, w_rr = s.get("w_rp", 50), s.get("w_rr", 50)
    w_p, w_v, w_ee = s.get("w_p", 1), s.get("w_v", 1), s.get("w_ee", 1)
    w_op, w_or = s.get("w_op", 1), s.get("w_or", 1)
    sq = lambda a, b: ((a - b) ** 2).sum(-1).mean()

    pq = pred["qpos"].reshape(-1, pred["qpos"].shape[-1])
    gq = data["qpos"].reshape(-1, data["qpos"].shape[-1])
    r_pos_loss = sq(gq[:, :3], pq[:, :3])
    r_rot_loss = _quat_identity_loss(gq[:, 3:7], pq[:, 3:7]).mean()
    p_rot_loss = sq(gq[:, 7:], pq[:, 7:])

    pv = pred["qvel"][:, :-1].reshape(-1, pred["qvel"].shape[-1])
    gv = data["qvel"][:, 1:].reshape(-1, data["qvel"].shape[-1])
    vl_loss, va_loss = sq(gv[:, :3], pv[:, :3]), sq(gv[:, 3:6], pv[:, 3:6])
    ee_loss = sq(data["wbpos"].reshape(pq.shape[0], -1), pred["wbpos"].reshape(pq.shape[0], -1))

    po = pred["obj_2_head"].reshape(-1, 7)
    go = data["obj_head_relative_poses"].reshape(-1, 7)
    o_pos_loss = sq(go[:, :3], po[:, :3])
    o_rot_loss = _quat_identity_loss(go[:, 3:], po[:, 3:]).mean()

    loss = (w_rp * r_pos_loss + w_rr * r_rot_loss + w_p * p_rot_loss + w_v * vl_loss + w_v * va_loss
            + w_ee * ee_loss + w_op * o_pos_loss + w_or * o_rot_loss)
    return loss, (r_pos_loss, r_rot_loss, p_rot_loss, vl_loss, va_loss, ee_loss, o_pos_loss, o_rot_loss)
