"""The kinpoly dynamic-supervision reward suite on torch tensors, batched
over envs (port of egoego_release_tpu/rl/rewards.py; the reference's
kinpoly/relive/core/reward_function.py, whose quaternion helpers come from
relive/utils/math_utils.py and transformation.py).

Every statear YAML with a reward_id sets ``dynamic_supervision_v3``;
v1, v4, v5 and v6 are its ablations. The reference's env gives each step
three pose sources: the simulated character, the kinematic target of the
AR policy (env.target) and the AR context (ARNet's predictions or the GT).
In the kinematic env (``rl.env``) the simulated state is the kinematic
pose, and the callers fill ``RewardContext`` with the expert motion as the
target, AR and GT sources. dynamic_supervision_v2 is commented out in the
reference (reward_function.py:999-1079) and is not ported, as in JAX.
Nothing here reaches a kernel of the port's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from egoego_release_tpu_torch.ops.rotations import quat_conjugate as quat_inverse
from egoego_release_tpu_torch.ops.rotations import quat_multiply

# -- quaternion helpers (relive/utils/math_utils.py:93-118); the reference's
# inverse is the conjugate (unit quaternions)


def multi_quat_diff(nq1: torch.Tensor, nq0: torch.Tensor) -> torch.Tensor:
    """Relative quaternions q1 q0^-1 per joint; (..., J, 4) x (..., J, 4)."""
    return quat_multiply(nq1, quat_inverse(nq0))


def multi_quat_norm_v2(nq: torch.Tensor) -> torch.Tensor:
    """Per-joint rotation magnitude ||(|w| - 1, x, y, z)|| (math_utils.py:111-118);
    (..., J, 4) -> (..., J)."""
    return torch.linalg.norm(torch.cat([nq[..., :1].abs() - 1.0, nq[..., 1:]], dim=-1), dim=-1)


def rotation_vec_from_quat(q: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gohlke's rotation_from_quaternion (transformation.py:364-374): angle
    2 acos(w) in [0, 2 pi), not the shortest arc, and a zero vector near
    the identity and its negative; (..., 4) -> (..., 3)."""
    w = q[..., 0].clamp(-1.0, 1.0)
    small = ((1.0 - w).abs() < eps) | ((1.0 + w).abs() < eps)
    angle = 2.0 * torch.arccos(w)
    s = torch.sin(angle / 2.0)
    axis = q[..., 1:] / torch.where(small, torch.ones_like(s), s)[..., None]
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.where(small[..., None], torch.zeros_like(axis), angle[..., None] * axis)


def get_angvel_fd(prev_bquat: torch.Tensor, cur_bquat: torch.Tensor, dt: float) -> torch.Tensor:
    """Finite-difference angular velocity per joint (math_utils.py:47-53);
    (..., J, 4) pairs -> (..., J * 3)."""
    av = rotation_vec_from_quat(multi_quat_diff(cur_bquat, prev_bquat)) / dt
    return av.reshape(av.shape[:-2] + (-1,))


def _lp_norm(x: torch.Tensor, ord: float) -> torch.Tensor:
    """np.linalg.norm(flat_vector, ord=v_ord) over the last axis."""
    return (x.abs() ** ord).sum(-1) ** (1.0 / ord)


# -- context and weights


class RewardContext(NamedTuple):
    """The tensors of one reward evaluation, leading dim B (JAX
    ``rl/rewards.py:93``; the names follow reward_function.py:931-1314):
    cur_* the character scored, tgt_* env.target (the kinematic policy's
    target this step), ar_* ARNet's predictions, gt_* the GT body quats
    (v1 only)."""

    cur_hpose: torch.Tensor              # (B, 7)
    tgt_hpose: torch.Tensor              # (B, 7)
    cur_bquat: torch.Tensor              # (B, J, 4)
    prev_bquat: torch.Tensor             # (B, J, 4)
    cur_wbpos: torch.Tensor              # (B, J, 3)
    tgt_bquat: torch.Tensor              # (B, J, 4)
    tgt_wbpos: torch.Tensor              # (B, J, 3)
    tgt_qpos: torch.Tensor | None = None       # (B, >= 7)
    ar_qpos: torch.Tensor | None = None        # (B, >= 7)
    ar_bquat: torch.Tensor | None = None       # (B, J, 4)
    ar_prev_bquat: torch.Tensor | None = None  # (B, J, 4)
    gt_bquat: torch.Tensor | None = None       # (B, J, 4)
    gt_prev_bquat: torch.Tensor | None = None  # (B, J, 4)
    dt: float = 1.0 / 30.0


DEFAULT_WEIGHTS = {
    # reward_function.py:936-940 defaults
    "w_hp": 1.0, "w_hq": 1.0, "w_hv": 0.05, "w_p": 1.0, "w_jp": 1.0,
    "w_rp": 1.0, "w_rq": 1.0, "w_act_p": 1.0, "w_act_v": 1.0,
    "k_hp": 1.0, "k_hq": 1.0, "k_hv": 1.0, "k_p": 1.0, "k_jp": 0.1,
    "k_rp": 0.1, "k_rq": 0.1, "k_act_p": 0.1, "k_act_v": 0.1,
    "v_ord": 2,
}


def _w(ws: dict | None) -> dict:
    return {**DEFAULT_WEIGHTS, **(ws or {})}


def _head_terms(ctx: RewardContext, k_hp: float, k_hq: float):
    hp_dist = torch.linalg.norm(ctx.cur_hpose[:, :3] - ctx.tgt_hpose[:, :3], dim=-1)
    hq_dist = multi_quat_norm_v2(multi_quat_diff(ctx.cur_hpose[:, None, 3:], ctx.tgt_hpose[:, None, 3:])).mean(-1)
    return torch.exp(-k_hp * hp_dist ** 2), torch.exp(-k_hq * hq_dist ** 2)


def _pose_terms(ctx: RewardContext, k_p: float, k_jp: float):
    pose_quat_diff = multi_quat_norm_v2(multi_quat_diff(ctx.cur_bquat, ctx.tgt_bquat)).mean(-1)
    pose_pos_diff = torch.linalg.norm(ctx.cur_wbpos - ctx.tgt_wbpos, dim=-1).mean(-1)
    return torch.exp(-k_p * pose_quat_diff ** 2), torch.exp(-k_jp * pose_pos_diff ** 2)


def _act_v(ctx: RewardContext, prev_bquat, bquat, w):
    cur_av = get_angvel_fd(ctx.prev_bquat, ctx.cur_bquat, ctx.dt)
    vel_dist = _lp_norm(cur_av - get_angvel_fd(prev_bquat, bquat, ctx.dt), w["v_ord"])
    return torch.exp(-w["k_act_v"] * vel_dist ** 2)


# -- the dynamic-supervision family


def dynamic_supervision_v1(ctx: RewardContext, ws: dict | None = None):
    """The GT-supervised additive variant (reward_function.py:931-995)."""
    w = _w(ws)
    hp, hq = _head_terms(ctx, w["k_hp"], w["k_hq"])
    p, jp = _pose_terms(ctx, w["k_p"], w["k_jp"])
    pose_gt_diff = multi_quat_norm_v2(multi_quat_diff(ctx.gt_bquat, ctx.cur_bquat)).mean(-1)
    gt_p = torch.exp(-w["k_act_p"] * pose_gt_diff)  # not squared (:985)
    act_v = _act_v(ctx, ctx.gt_prev_bquat, ctx.gt_bquat, w)
    reward = (w["w_hp"] * hp + w["w_hq"] * hq + w["w_p"] * p + w["w_jp"] * jp + w["w_act_p"] * gt_p
              + w["w_act_v"] * act_v)
    return reward, torch.stack([hp, hq, p, jp, gt_p, act_v], dim=-1)


def dynamic_supervision_v3(ctx: RewardContext, ws: dict | None = None):
    """The statear production reward: multiplicative head, pose and
    AR-regularized terms (reward_function.py:1081-1149)."""
    w = _w(ws)
    hp, hq = _head_terms(ctx, w["k_hp"], w["k_hq"])
    p, jp = _pose_terms(ctx, w["k_p"], w["k_jp"])
    rp_dist = torch.linalg.norm(ctx.ar_qpos[:, :3] - ctx.tgt_qpos[:, :3], dim=-1)
    rq_dist = multi_quat_norm_v2(multi_quat_diff(ctx.ar_qpos[:, None, 3:7], ctx.tgt_qpos[:, None, 3:7])).mean(-1)
    pose_action_diff = multi_quat_norm_v2(multi_quat_diff(ctx.ar_bquat, ctx.tgt_bquat)).mean(-1)
    act_v = _act_v(ctx, ctx.ar_prev_bquat, ctx.ar_bquat, w)
    rq = torch.exp(-w["k_rq"] * rq_dist ** 2)
    rp = torch.exp(-w["k_rp"] * rp_dist ** 2)
    act_p = torch.exp(-w["k_act_p"] * pose_action_diff)  # not squared (:1139)
    # act_v is reported but left out of the product (:1144)
    reward = hp * hq * p * jp * rp * rq * act_p
    return reward, torch.stack([hp, hq, p, jp, rp, rq, act_p, act_v], dim=-1)


def dynamic_supervision_v4(ctx: RewardContext, ws: dict | None = None):
    """Additive head and pose tracking, no action terms (:1152-1203)."""
    w = _w(ws)
    hp, hq = _head_terms(ctx, w["k_hp"], w["k_hq"])
    p, jp = _pose_terms(ctx, w["k_p"], w["k_jp"])
    hv = torch.zeros_like(hp)  # hv_reward = 0 in the reference (:1184)
    reward = w["w_hp"] * hp + w["w_hq"] * hq + w["w_hv"] * hv + w["w_p"] * p + w["w_jp"] * jp
    return reward, torch.stack([hp, hq, hv, p, jp], dim=-1)


def dynamic_supervision_v5(ctx: RewardContext, ws: dict | None = None):
    """v4, multiplicative (:1205-1256)."""
    w = _w(ws)
    hp, hq = _head_terms(ctx, w["k_hp"], w["k_hq"])
    p, jp = _pose_terms(ctx, w["k_p"], w["k_jp"])
    hv = torch.zeros_like(hp)
    return hp * hq * p * jp, torch.stack([hp, hq, hv, p, jp], dim=-1)


def dynamic_supervision_v6(ctx: RewardContext, ws: dict | None = None):
    """v4 and the AR angular-velocity term (:1259-1314)."""
    w = _w(ws)
    hp, hq = _head_terms(ctx, w["k_hp"], w["k_hq"])
    p, jp = _pose_terms(ctx, w["k_p"], w["k_jp"])
    act_v = _act_v(ctx, ctx.ar_prev_bquat, ctx.ar_bquat, w)
    reward = w["w_hp"] * hp + w["w_hq"] * hq + w["w_p"] * p + w["w_jp"] * jp + w["w_act_v"] * act_v
    return reward, torch.stack([hp, hq, p, jp, act_v], dim=-1)


def constant_reward(ctx: RewardContext, ws: dict | None = None):
    """1 for every env (:1316-1320: the reference computes an end bonus and
    returns the constant all the same)."""
    b = ctx.cur_hpose.shape[0]
    return ctx.cur_hpose.new_ones(b), ctx.cur_hpose.new_zeros(b, 1)


REWARD_FUNCS = {
    "dynamic_supervision_v1": dynamic_supervision_v1,
    "dynamic_supervision_v3": dynamic_supervision_v3,
    "dynamic_supervision_v4": dynamic_supervision_v4,
    "dynamic_supervision_v5": dynamic_supervision_v5,
    "dynamic_supervision_v6": dynamic_supervision_v6,
    "constant": constant_reward,
}
