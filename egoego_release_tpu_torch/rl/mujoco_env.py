"""Physics-backed humanoid imitation env on MuJoCo 3 (port of
egoego_release_tpu/rl/mujoco_env.py; the reference's
``HumanoidAREnv.do_simulation``, kinpoly/relive/envs/humanoid_ar_v1.py:496-530,
and the UHC ``HumanoidEnv``, copycat/envs/humanoid_im.py):

  * position-mode actions: stable-PD torques by ``rl.control.compute_torque``
    with the model's mass matrix (mj_fullM) and bias forces (qfrc_bias),
    recomputed every substep as the reference does (:496-505)
  * the torques clipped per joint (cfg.torque_lim, :505)
  * implicit residual force control at the root
    (``rl.control.rfc_implicit_force`` -> qfrc_applied, :506-513)
  * contacts, gravity and integration: mj_step

The per-joint PD gains and torque limits default to the UHC values
(copycat/cfg/copycat.yml joint_params, by body part), resolved from the
model's actuator joint names.

MuJoCo's state is host memory, and the simulator steps on the host. The
control laws run at f32, as JAX runs them, on the ``device`` the caller
names: on the card every 1/450 s substep would pay two copies and a sync,
so the callers of this package pass the CPU.
"""

from __future__ import annotations

import numpy as np

import torch

from egoego_release_tpu_torch.ops.mujoco_compat import load_humanoid_model
from egoego_release_tpu_torch.rl import control

# UHC per-category gains: (k_p, k_d, torque_lim) by body-name prefix
# (copycat/cfg/copycat.yml:87-150 joint_params)
_GAINS = {
    "Hip": (500.0, 50.0, 200.0),
    "Knee": (500.0, 50.0, 150.0),
    "Ankle": (400.0, 40.0, 100.0),
    "Toe": (200.0, 20.0, 100.0),
    "Torso": (1000.0, 100.0, 200.0),
    "Spine": (1000.0, 100.0, 200.0),
    "Chest": (1000.0, 100.0, 200.0),
    "Neck": (100.0, 10.0, 50.0),
    "Head": (100.0, 10.0, 50.0),
    "Thorax": (400.0, 40.0, 100.0),
    "Shoulder": (400.0, 40.0, 100.0),
    "Elbow": (300.0, 30.0, 60.0),
    "Wrist": (100.0, 10.0, 50.0),
    "Hand": (100.0, 10.0, 50.0),
}


def _default_gains(joint_names: list[str]):
    jkp = np.zeros(len(joint_names))
    jkd = np.zeros(len(joint_names))
    tlim = np.zeros(len(joint_names))
    for i, name in enumerate(joint_names):
        for part, (kp, kd, tl) in _GAINS.items():
            if part in name:
                jkp[i], jkd[i], tlim[i] = kp, kd, tl
                break
        else:
            jkp[i], jkd[i], tlim[i] = 200.0, 20.0, 100.0
    return jkp, jkd, tlim


class MujocoHumanoidEnv:
    def __init__(
        self,
        xml_path: str,
        frame_skip: int = 15,          # 1/450 s substeps -> 30 Hz control
        a_scale: float = 1.0,          # cc_cfg.a_scale (copycat.yml: 1.0)
        residual_force: bool = True,
        residual_force_scale: float = 100.0,   # copycat.yml:82
        residual_force_lim: float = 100.0,
        jkp: np.ndarray | None = None,
        jkd: np.ndarray | None = None,
        torque_lim: np.ndarray | None = None,
        *,
        device,
    ):
        import mujoco

        self._mj = mujoco
        self.model = load_humanoid_model(xml_path)
        self.data = mujoco.MjData(self.model)
        self.frame_skip = frame_skip
        self.a_scale = a_scale
        self.residual_force = residual_force
        self.rfc_scale = residual_force_scale
        self.rfc_lim = residual_force_lim
        self.dt = self.model.opt.timestep * frame_skip

        self.ndof = self.model.nu
        self.nv = self.model.nv
        self.body_names = [
            mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_BODY, i)
            for i in range(1, self.model.nbody)  # skip world
        ]
        joint_names = [
            mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_ACTUATOR, i)
            for i in range(self.model.nu)
        ]
        dkp, dkd, dtl = _default_gains(joint_names)
        self.jkp = np.asarray(jkp if jkp is not None else dkp)
        self.jkd = np.asarray(jkd if jkd is not None else dkd)
        self.torque_lim = np.asarray(torque_lim if torque_lim is not None else dtl)
        self.vf_dim = 6 if residual_force else 0
        self.action_dim = self.ndof + self.vf_dim

        # the control laws' device and their f32 gains, made once
        self.device = torch.device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self._jkp, self._jkd = f32(self.jkp), f32(self.jkd)
        self._f32 = f32

    # -- state ------------------------------------------------------------

    def reset(self, qpos: np.ndarray, qvel: np.ndarray | None = None):
        self._mj.mj_resetData(self.model, self.data)
        self.data.qpos[:] = np.asarray(qpos, np.float64)
        self.data.qvel[:] = 0.0 if qvel is None else np.asarray(qvel, np.float64)
        self._mj.mj_forward(self.model, self.data)
        return self.get_qpos()

    def get_qpos(self) -> np.ndarray:
        return self.data.qpos.copy()

    def get_qvel(self) -> np.ndarray:
        return self.data.qvel.copy()

    def get_body_quat(self) -> np.ndarray:
        """World body quats (J, 4) wxyz, mujoco body order (the reference's
        env.get_body_quat flattens the same quantity)."""
        return self.data.xquat[1:].copy()

    def get_wbody_pos(self) -> np.ndarray:
        return self.data.xpos[1:].copy()

    def get_head_pose(self) -> np.ndarray:
        i = self.body_names.index("Head") + 1
        return np.concatenate([self.data.xpos[i], self.data.xquat[i]])

    def mass_matrix_and_bias(self):
        M = np.zeros((self.nv, self.nv))
        self._mj.mj_fullM(self.model, self.data, M)
        return M, self.data.qfrc_bias.copy()

    # -- dynamics ----------------------------------------------------------

    def _pd_torque(self, ctrl_joint: np.ndarray, target_kin_pose: np.ndarray):
        # slice state + dynamics to the HUMANOID limits, as the reference
        # does on object-bearing models (humanoid_ar_v1.py:424-445:
        # get_humanoid_qpos/qvel, M[:qvel_lim, :qvel_lim], C[:qvel_lim])
        ql, vl = 7 + self.ndof, 6 + self.ndof
        M, C = self.mass_matrix_and_bias()
        f32 = self._f32
        tau = control.compute_torque(
            f32(ctrl_joint), f32(self.data.qpos[:ql]), f32(self.data.qvel[:vl]), f32(target_kin_pose),
            f32(M[:vl, :vl]), f32(C[:vl]), self._jkp, self._jkd, dt=self.model.opt.timestep,
            a_scale=self.a_scale).cpu().numpy()
        return np.clip(tau, -self.torque_lim, self.torque_lim)

    def do_simulation(self, action: np.ndarray, target_kin_pose: np.ndarray):
        """One 30 Hz control step = frame_skip physics substeps with the PD
        torque recomputed each substep (humanoid_ar_v1.py:496-530).

        action: (ndof [+ 6 rfc]) policy output; target_kin_pose: (ndof,)
        kinematic target joint angles (the AR-policy pose the PD tracks).
        """
        action = np.asarray(action, np.float64)
        ctrl_joint = action[: self.ndof]
        for _ in range(self.frame_skip):
            self.data.ctrl[:] = self._pd_torque(ctrl_joint, target_kin_pose)
            if self.residual_force:
                vf = control.rfc_implicit_force(
                    self._f32(action[self.ndof: self.ndof + self.vf_dim]), self._f32(self.data.qpos[3:7]),
                    residual_force_scale=self.rfc_scale, residual_force_lim=self.rfc_lim).cpu().numpy()
                self.data.qfrc_applied[: self.vf_dim] = vf
            self._mj.mj_step(self.model, self.data)
        return self.get_qpos(), self.get_qvel()
