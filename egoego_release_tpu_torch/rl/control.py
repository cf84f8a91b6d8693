"""The UHC/kinpoly PD and residual-force control laws on torch tensors
(port of egoego_release_tpu/rl/control.py; the reference's
``HumanoidAREnv.compute_desired_accel / compute_torque / rfc_implicit``,
kinpoly/relive/envs/humanoid_ar_v1.py:409-495).

The laws take the joint-space mass matrix M and the bias force C as
inputs, so they do not depend on the simulator that supplies them
(``rl.mujoco_env`` reads them from MuJoCo every substep). Every function is
batched over leading dims and runs on the device of its inputs; the
stable-PD solve is a Cholesky factorization and ``torch.cholesky_solve``,
as JAX's ``cho_solve``. Nothing here reaches a kernel of the port's.
"""

from __future__ import annotations

import math

import torch

from egoego_release_tpu_torch.ops import heading as heading_mod
from egoego_release_tpu_torch.ops import rotations as rot

# cc_cfg.data_specs base_rot default (humanoid_ar_v1.py:34): the humanoid
# model's root is rotated 90 deg about +x relative to SMPL
BASE_ROT = (0.7071, 0.7071, 0.0, 0.0)


def remove_base_rot(quat: torch.Tensor, base_rot=BASE_ROT) -> torch.Tensor:
    """quat * base_rot^-1 (humanoid_ar_v1.py:162-163)."""
    base = torch.as_tensor(base_rot, dtype=quat.dtype, device=quat.device).expand(quat.shape)
    return rot.quat_multiply(quat, rot.quat_invert(base))


def wrap_to_pi(x: torch.Tensor) -> torch.Tensor:
    """Angles wrapped to [-pi, pi): the closed form of the reference's
    while-loop of +-2 pi steps (humanoid_ar_v1.py:447-451)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def stable_pd_accel(M: torch.Tensor, C: torch.Tensor, qpos_err: torch.Tensor, qvel_err: torch.Tensor,
                    k_p: torch.Tensor, k_d: torch.Tensor, dt: float) -> torch.Tensor:
    """Stable-PD desired acceleration (compute_desired_accel,
    humanoid_ar_v1.py:409-437): solve (M + Kd dt) a = -C - Kp e - Kd de.
    M (..., nv, nv), C, qpos_err, qvel_err (..., nv), k_p, k_d (nv,)."""
    lhs = M + torch.diag(k_d) * dt
    rhs = -(C + k_p * qpos_err + k_d * qvel_err)
    # M + Kd dt is symmetric positive definite: Cholesky, as the reference's cho_solve
    return torch.cholesky_solve(rhs[..., None], torch.linalg.cholesky(lhs))[..., 0]


def compute_torque(ctrl: torch.Tensor, qpos: torch.Tensor, qvel: torch.Tensor, base_pos: torch.Tensor,
                   M: torch.Tensor, C: torch.Tensor, jkp: torch.Tensor, jkd: torch.Tensor, dt: float,
                   a_scale: float = 1.0) -> torch.Tensor:
    """PD torque from a position-mode action (compute_torque,
    humanoid_ar_v1.py:439-469): ctrl (..., ndof) the policy's joint action,
    qpos (..., 7 + ndof), qvel (..., 6 + ndof), base_pos (..., ndof) the
    kinematic target, M (..., nv, nv), C (..., nv), the joint gains jkp, jkd
    (ndof,). Returns (..., ndof) torques, unclipped (the caller clips at
    the torque limits, as do_simulation does at :505)."""
    joints = qpos[..., 7:]
    # the kinematic target wrapped into the +-pi neighbourhood of the pose
    base_pos = joints + wrap_to_pi(base_pos - joints)
    target_pos = base_pos + ctrl * a_scale
    k_p = torch.cat([jkp.new_zeros(6), jkp])
    k_d = torch.cat([jkd.new_zeros(6), jkd])
    qpos_err = torch.cat([torch.zeros_like(qvel[..., :6]), joints + qvel[..., 6:] * dt - target_pos], dim=-1)
    qvel_err = qvel
    q_accel = stable_pd_accel(M, C, qpos_err, qvel_err, k_p, k_d, dt)
    qvel_err = qvel_err + q_accel * dt
    return -jkp * qpos_err[..., 6:] - jkd * qvel_err[..., 6:]


def rfc_implicit_force(vf: torch.Tensor, root_quat: torch.Tensor, residual_force_scale: float,
                       residual_force_lim: float, base_rot=BASE_ROT) -> torch.Tensor:
    """The implicit residual force at the root (rfc_implicit,
    humanoid_ar_v1.py:485-493): vf (..., vf_dim) scaled, its linear part
    rotated into the heading frame of root_quat (..., 4) wxyz, clipped.
    Returns the generalized force of the root dofs (the reference writes it
    into data.qfrc_applied)."""
    vf = vf * residual_force_scale
    hq = heading_mod.get_heading_quat(remove_base_rot(root_quat, base_rot))
    vf = torch.cat([rot.quat_apply(hq, vf[..., :3]), vf[..., 3:]], dim=-1)
    return torch.clamp(vf, -residual_force_lim, residual_force_lim)
