"""The relive simulator-state reward families (quat/deep-mimic/local-world/
world-quat/fine-tune), pure numpy (port of
egoego_release_tpu/rl/sim_rewards.py, copied).

Port of kinpoly/relive/core/reward_function.py:5-929 — the 15 registry
entries beyond the dynamic-supervision family (rl/rewards.py) and the
constant reward.  These score the PHYSICS-simulated character against expert
attrs (the relive HumanoidAREnv surface), so like rl/uhc_rewards.py they are
host-side numpy functions over explicit state dicts; the simulator
quantities come from MujocoHumanoidEnv + uhc_rewards extraction helpers.

The relive math helpers differ from khrylib's copycat variants in small but
numerically meaningful ways, so they are re-implemented here exactly:

  * multi_quat_norm = arccos(clip(w)) with NO abs (math_utils.py:105-109) —
    a negative-w relative quat scores as a near-pi rotation
  * rotation_from_quaternion uses eps 1e-6 at BOTH poles and renormalizes
    the axis (relive/utils/transformation.py:364-374)
  * get_qvel_fd (math_utils.py:26-44, NOT khrylib's get_qvel_fd_new): a
    single if/elif pi-wrap on the root angle and NO joint-diff wrapping

Expert dicts are uhc_rewards.expert_physics_attrs outputs plus the relive
sync fields (`start_pos`, `rel_heading`, `sim_pos` — set by the env reset,
humanoid_ar_v1.py) and, for the fine-tune family, `head_info`/`hvel`
(process_trajs.py).  Held equal to the JAX package's
copy by tests/test_torch_uhc.py.
"""

from __future__ import annotations

import numpy as np

from egoego_release_tpu_torch.rl.uhc_rewards import (
    _quat_inv,
    _quat_mul,
    de_heading,
    get_heading_q,
    multi_quat_diff,
    quat_mul_vec,
    transform_vec,
)

__all__ = [
    "SIM_REWARD_FUNCS",
    "quat_space_reward_v2",
    "quat_space_reward_v3",
    "deep_mimic_reward",
    "deep_mimic_reward_v2",
    "deep_mimic_reward_v2_vf",
    "deep_mimic_reward_v2_vf_vq",
    "multiplicable_reward",
    "local_world_reward_v1",
    "local_world_reward_v2",
    "local_world_reward_v3",
    "world_quat_space_reward",
    "world_quat_space_reward_v2",
    "fine_tune_kin_action_reward",
    "fine_tune_action_reward",
    "fine_tune_reward",
]


# -- relive-exact quat helpers ------------------------------------------------

def multi_quat_norm(nq: np.ndarray) -> np.ndarray:
    """arccos(clip(w)) per joint, NO abs (relive math_utils.py:105-109)."""
    return np.arccos(np.clip(nq[::4], -1.0, 1.0))


def multi_quat_norm_v2(nq: np.ndarray) -> np.ndarray:
    """||(|w|-1, x, y, z)|| per joint (math_utils.py:111-118)."""
    q = nq.reshape(-1, 4).copy()
    q[:, 0] = np.abs(q[:, 0]) - 1.0
    return np.linalg.norm(q, axis=1)


def _rot_from_quat(q: np.ndarray):
    """(axis, angle) — relive transformation.py:364-374: eps 1e-6 at BOTH
    poles, axis renormalized."""
    w = float(np.clip(q[0], -1.0, 1.0))
    if abs(1.0 - w) < 1e-6 or abs(1.0 + w) < 1e-6:
        return np.array([1.0, 0.0, 0.0]), 0.0
    angle = 2.0 * np.arccos(w)
    axis = np.asarray(q[1:4], np.float64) / np.sin(angle / 2.0)
    axis = axis / np.linalg.norm(axis)
    return axis, angle


def get_angvel_fd(prev_bquat: np.ndarray, cur_bquat: np.ndarray, dt: float) -> np.ndarray:
    """Per-joint finite-difference angular velocity (math_utils.py:47-53)."""
    dq = multi_quat_diff(cur_bquat, prev_bquat).reshape(-1, 4)
    out = np.zeros((dq.shape[0], 3))
    for i in range(dq.shape[0]):
        axis, angle = _rot_from_quat(dq[i])
        out[i] = axis * angle / dt
    return out.reshape(-1)


def get_qvel_fd(cur_qpos: np.ndarray, next_qpos: np.ndarray, dt: float,
                transform: str | None = None) -> np.ndarray:
    """Finite-difference qvel (relive math_utils.py:26-44): single-wrap root
    angle, UNWRAPPED joint diffs (unlike khrylib get_qvel_fd_new)."""
    v = (next_qpos[:3] - cur_qpos[:3]) / dt
    qrel = _quat_mul(next_qpos[3:7], _quat_inv(cur_qpos[3:7]))
    axis, angle = _rot_from_quat(qrel)
    if angle > np.pi:
        angle -= 2 * np.pi
    elif angle < -np.pi:
        angle += 2 * np.pi
    rv = transform_vec(axis * angle / dt, cur_qpos[3:7], "root")
    qvel = np.concatenate([v, rv, (next_qpos[7:] - cur_qpos[7:]) / dt])
    if transform is not None:
        qvel[:3] = transform_vec(v, cur_qpos[3:7], transform)
    return qvel


def get_heading(q: np.ndarray) -> float:
    """Heading angle 2*acos(w) of the yaw-only quat, sign-fixed via the z
    component (math_utils.py:80-87)."""
    hq = np.asarray(q, np.float64).copy()
    hq[1] = hq[2] = 0.0
    if hq[3] < 0:
        hq *= -1
    hq /= np.linalg.norm(hq)
    return 2.0 * float(np.arccos(np.clip(hq[0], -1.0, 1.0)))


def _sync_point(e_vec3: np.ndarray, expert: dict) -> np.ndarray:
    """World-point expert->sim remap (humanoid_ar_v1 relocation): rotate
    about start_pos by rel_heading, translate to sim_pos."""
    return quat_mul_vec(expert["rel_heading"], e_vec3 - expert["start_pos"]) \
        + expert["sim_pos"]


def _sync_points_flat(flat: np.ndarray, expert: dict) -> np.ndarray:
    out = flat.copy()
    for i in range(flat.shape[0] // 3):
        out[3 * i: 3 * i + 3] = _sync_point(flat[3 * i: 3 * i + 3], expert)
    return out


# -- quat_space family (:5-119) ----------------------------------------------

def quat_space_reward_v2(cur, expert, ind, action, ws=None, b_diffw=1.0,
                         dt=1 / 30, obs_coord="heading",
                         end=False, end_reward=0.0):
    """(:5-61).  cur: dict(qpos, prev_qpos, bquat, prev_bquat, ee_pos, com)."""
    w = ws or {}
    w_p, w_v, w_e, w_c, w_r = (w.get("w_p", 0.5), w.get("w_v", 0.05),
                               w.get("w_e", 0.15), w.get("w_c", 0.1),
                               w.get("w_r", 0.2))
    k_p, k_v, k_e, k_c, k_r = (w.get("k_p", 2), w.get("k_v", 0.005),
                               w.get("k_e", 20), w.get("k_c", 1000),
                               w.get("k_r", 1.0))
    w_rq, w_rlinv, w_rangv = (w.get("w_rq", 2.0), w.get("w_rlinv", 1.0),
                              w.get("w_rangv", 0.1))
    v_ord = w.get("v_ord", 2)

    cur_qvel = get_qvel_fd(cur["prev_qpos"], cur["qpos"], dt, obs_coord)
    cur_rq_rmh = de_heading(cur["qpos"][3:7])
    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"][4:], expert["bquat"][ind][4:])).copy()
    pose_diff *= b_diffw
    pose_reward = np.exp(-k_p * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(
        cur_bangvel[3:] - expert["bangvel"][ind][3:], ord=v_ord)
    vel_reward = np.exp(-k_v * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_pos"] - expert["ee_pos"][ind])
    ee_reward = np.exp(-k_e * ee_dist ** 2)

    com_dist = cur["com"][2] - expert["com"][ind][2]
    com_reward = np.exp(-k_c * com_dist ** 2)

    rq_dist = multi_quat_norm(
        multi_quat_diff(cur_rq_rmh, expert["rq_rmh"][ind]))[0]
    rlinv_dist = np.linalg.norm(cur_qvel[:3] - expert["rlinv_local"][ind])
    rangv_dist = np.linalg.norm(cur_qvel[3:6] - expert["rangv"][ind])
    root_dist = w_rq * rq_dist + w_rlinv * rlinv_dist + w_rangv * rangv_dist
    root_reward = np.exp(-k_r * root_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_c * com_reward + w_r * root_reward)
    reward /= w_p + w_v + w_e + w_c + w_r
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, com_reward, root_reward])


def quat_space_reward_v3(cur, expert, ind, action, ws=None, b_diffw=1.0,
                         dt=1 / 30, obs_coord="heading", cur_t=0,
                         env_episode_len=200, end=False, end_reward=0.0):
    """(:63-119).  Same shape as local_rfc_implicit minus the vf term, plus
    the optional per-step decay and end bonus."""
    w = ws or {}
    w_p, w_v, w_e, w_rp, w_rv = (w.get("w_p", 0.5), w.get("w_v", 0.1),
                                 w.get("w_e", 0.2), w.get("w_rp", 0.1),
                                 w.get("w_rv", 0.1))
    k_p, k_v, k_e = w.get("k_p", 2), w.get("k_v", 0.005), w.get("k_e", 20)
    k_rh, k_rq, k_rl, k_ra = (w.get("k_rh", 300), w.get("k_rq", 300),
                              w.get("k_rl", 5.0), w.get("k_ra", 0.5))
    v_ord = w.get("v_ord", 2)

    cur_qvel = get_qvel_fd(cur["prev_qpos"], cur["qpos"], dt, obs_coord)
    cur_rq_rmh = de_heading(cur["qpos"][3:7])
    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"][4:], expert["bquat"][ind][4:])).copy()
    pose_diff *= b_diffw
    pose_reward = np.exp(-k_p * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(
        cur_bangvel[3:] - expert["bangvel"][ind][3:], ord=v_ord)
    vel_reward = np.exp(-k_v * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_pos"] - expert["ee_pos"][ind])
    ee_reward = np.exp(-k_e * ee_dist ** 2)

    root_height_dist = cur["qpos"][2] - expert["qpos"][ind][2]
    root_quat_dist = multi_quat_norm(
        multi_quat_diff(cur_rq_rmh, expert["rq_rmh"][ind]))[0]
    root_pose_reward = np.exp(-k_rh * root_height_dist ** 2
                              - k_rq * root_quat_dist ** 2)

    root_linv_dist = np.linalg.norm(cur_qvel[:3] - expert["rlinv_local"][ind])
    root_angv_dist = np.linalg.norm(cur_qvel[3:6] - expert["rangv"][ind])
    root_vel_reward = np.exp(-k_rl * root_linv_dist ** 2
                             - k_ra * root_angv_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_rp * root_pose_reward + w_rv * root_vel_reward)
    reward /= w_p + w_v + w_e + w_rp + w_rv
    if w.get("decay", False):
        reward *= 1.0 - cur_t / env_episode_len
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, root_pose_reward, root_vel_reward])


# -- deep_mimic family (:121-333) --------------------------------------------

def deep_mimic_reward(cur, expert, ind, action, ws=None, b_diffw=1.0,
                      dt=1 / 30, off_obj_qpos=0, end=False, end_reward=0.0):
    """(:121-164).  World-frame DeepMimic terms; NOTE the reference applies
    b_diffw AFTER taking the norm (:146-147) — a no-op kept faithful."""
    w = ws or {}
    w_p, w_v, w_e, w_c = (w.get("w_p", 0.65), w.get("w_v", 0.1),
                          w.get("w_e", 0.15), w.get("w_c", 0.1))
    k_p, k_v, k_e, k_c = (w.get("k_p", 2), w.get("k_v", 0.1),
                          w.get("k_e", 10), w.get("k_c", 10))

    o = off_obj_qpos
    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"], expert["bquat"][ind]))
    pose_reward = np.exp(-k_p * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(cur_bangvel - expert["bangvel"][ind])
    vel_reward = np.exp(-k_v * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_wpos"] - expert["ee_wpos"][ind])
    ee_reward = np.exp(-k_e * ee_dist ** 2)

    root_dist = np.linalg.norm(
        cur["qpos"][o:o + 3] - expert["qpos"][ind][o:o + 3])
    root_reward = np.exp(-k_c * root_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_c * root_reward)
    reward /= w_p + w_v + w_e + w_c
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, root_reward])


def _deep_mimic_v2_terms(cur, expert, ind, ws, dt, off_obj_qpos):
    w = ws or {}
    k_p, k_v, k_e, k_rp, k_rq = (w.get("k_p", 2), w.get("k_v", 0.1),
                                 w.get("k_e", 10), w.get("k_rp", 10),
                                 w.get("k_rq", 10))
    o = off_obj_qpos
    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    pose_diff = multi_quat_norm_v2(
        multi_quat_diff(cur["bquat"][4:], expert["bquat"][ind][4:]))
    pose_reward = np.exp(-k_p * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(cur_bangvel - expert["bangvel"][ind])
    vel_reward = np.exp(-k_v * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_wpos"] - expert["ee_wpos"][ind])
    ee_reward = np.exp(-k_e * ee_dist ** 2)

    rp_dist = np.linalg.norm(
        cur["qpos"][o:o + 3] - expert["qpos"][ind][o:o + 3])
    rp_reward = np.exp(-k_rp * rp_dist ** 2)

    rq_dist = multi_quat_norm_v2(
        multi_quat_diff(cur["bquat"][:4], expert["bquat"][ind][:4]))[0]
    rq_reward = float(np.exp(-k_rq * rq_dist ** 2))
    return pose_reward, vel_reward, ee_reward, rp_reward, rq_reward


def deep_mimic_reward_v2(cur, expert, ind, action, ws=None, dt=1 / 30,
                         off_obj_qpos=0):
    """(:166-216): root excluded from pose (v2 norm), separate root pos/quat."""
    w = ws or {}
    w_p, w_v, w_e, w_rp, w_rq = (w.get("w_p", 0.65), w.get("w_v", 0.1),
                                 w.get("w_e", 0.15), w.get("w_rp", 0.1),
                                 w.get("w_rq", 0.1))
    rp_, rv_, re_, rrp_, rrq_ = _deep_mimic_v2_terms(
        cur, expert, ind, ws, dt, off_obj_qpos)
    reward = (w_p * rp_ + w_v * rv_ + w_e * re_ + w_rp * rrp_ + w_rq * rrq_)
    reward /= w_p + w_v + w_e + w_rp + w_rq
    return float(reward), np.array([rp_, rv_, re_, rrp_, rrq_])


def deep_mimic_reward_v2_vf(cur, expert, ind, action, ws=None, dt=1 / 30,
                            off_obj_qpos=0, vf_dim=6, action_v=2):
    """(:218-279): v2 + residual-force magnitude term (action_v 2 uses the
    env's vf_dim tail; action_v 3 a fixed 6-dim tail)."""
    w = ws or {}
    w_p, w_v, w_e, w_rp, w_rq, w_vf = (
        w.get("w_p", 0.65), w.get("w_v", 0.1), w.get("w_e", 0.15),
        w.get("w_rp", 0.1), w.get("w_rq", 0.1), w.get("w_vf", 0.1))
    k_vf = w.get("k_vf", 10)
    rp_, rv_, re_, rrp_, rrq_ = _deep_mimic_v2_terms(
        cur, expert, ind, ws, dt, off_obj_qpos)
    if action_v == 2:
        vf = np.asarray(action)[-vf_dim:]
    elif action_v == 3:
        vf = np.asarray(action)[-6:]
    else:
        raise ValueError(f"action version {action_v} not supported")
    vf_reward = np.exp(-k_vf * np.linalg.norm(vf) ** 2)
    reward = (w_p * rp_ + w_v * rv_ + w_e * re_ + w_rp * rrp_
              + w_rq * rrq_ + w_vf * vf_reward)
    reward /= w_p + w_v + w_e + w_rp + w_rq + w_vf
    return float(reward), np.array([rp_, rv_, re_, rrp_, rrq_, vf_reward])


def deep_mimic_reward_v2_vf_vq(cur, expert, ind, action, ws=None, dt=1 / 30,
                               off_obj_qpos=0):
    """(:281-333): identical math to v2 (the vf/vq terms were dropped in the
    reference body; kept as a registry alias with its own name)."""
    return deep_mimic_reward_v2(cur, expert, ind, action, ws=ws, dt=dt,
                                off_obj_qpos=off_obj_qpos)


def multiplicable_reward(cur, expert, ind, action, ws=None, dt=1 / 30,
                         off_obj_qpos=0, end=False, end_reward=0.0):
    """(:335-393): product of pose/vel/ee/root-pos/root-quat terms (no-abs
    quat norms, root quat from qpos)."""
    w = ws or {}
    k_p, k_v, k_e, k_rp, k_rq = (w.get("k_p", 2), w.get("k_v", 0.1),
                                 w.get("k_e", 10), w.get("k_rp", 10),
                                 w.get("k_rq", 10))
    o = off_obj_qpos
    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"][4:], expert["bquat"][ind][4:]))
    pose_reward = np.exp(-k_p * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(cur_bangvel - expert["bangvel"][ind])
    vel_reward = np.exp(-k_v * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_wpos"] - expert["ee_wpos"][ind])
    ee_reward = np.exp(-k_e * ee_dist ** 2)

    rp_dist = np.linalg.norm(
        cur["qpos"][o:o + 3] - expert["qpos"][ind][o:o + 3])
    rp_reward = np.exp(-k_rp * rp_dist ** 2)

    rq_dist = multi_quat_norm(multi_quat_diff(
        cur["qpos"][o + 3:o + 7], expert["qpos"][ind][o + 3:o + 7]))[0]
    rq_reward = float(np.exp(-k_rq * rq_dist ** 2))

    reward = pose_reward * vel_reward * ee_reward * rp_reward * rq_reward
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, rp_reward, rq_reward])


# -- local_world family (:395-612) -------------------------------------------

def _local_world_base(cur, expert, ind, w, b_diffw, dt, obs_coord):
    cur_qvel = get_qvel_fd(cur["prev_qpos"], cur["qpos"], dt, obs_coord)
    cur_rq_rmh = de_heading(cur["qpos"][3:7])
    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"][4:], expert["bquat"][ind][4:])).copy()
    pose_diff *= b_diffw
    pose_reward = np.exp(-w.get("k_p", 2) * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(
        cur_bangvel[3:] - expert["bangvel"][ind][3:], ord=w.get("v_ord", 2))
    vel_reward = np.exp(-w.get("k_v", 0.005) * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_pos"] - expert["ee_pos"][ind])
    ee_reward = np.exp(-w.get("k_e", 20) * ee_dist ** 2)

    rq_dist = multi_quat_norm(
        multi_quat_diff(cur_rq_rmh, expert["rq_rmh"][ind]))[0]
    rlinv_dist = np.linalg.norm(cur_qvel[:3] - expert["rlinv_local"][ind])
    rangv_dist = np.linalg.norm(cur_qvel[3:6] - expert["rangv"][ind])
    root_dist = (w.get("w_rq", 2.0) * rq_dist
                 + w.get("w_rlinv", 1.0) * rlinv_dist
                 + w.get("w_rangv", 0.1) * rangv_dist)
    root_reward = np.exp(-w.get("k_r", 1.0) * root_dist ** 2)
    return pose_reward, vel_reward, ee_reward, root_reward


def local_world_reward_v1(cur, expert, ind, action, ws=None, b_diffw=1.0,
                          dt=1 / 30, obs_coord="heading",
                          end=False, end_reward=0.0):
    """(:395-466): local terms + sim-synced world-ee + com."""
    w = ws or {}
    w_p, w_v, w_e, w_we, w_c, w_r = (
        w.get("w_p", 0.4), w.get("w_v", 0.05), w.get("w_e", 0.15),
        w.get("w_we", 0.1), w.get("w_c", 0.1), w.get("w_r", 0.2))
    k_we, k_c = w.get("k_we", 20), w.get("k_c", 1000)

    pose_reward, vel_reward, ee_reward, root_reward = _local_world_base(
        cur, expert, ind, w, b_diffw, dt, obs_coord)

    e_wee = _sync_points_flat(expert["ee_wpos"][ind].copy(), expert)
    e_com = _sync_point(expert["com"][ind].copy(), expert)

    wee_dist = np.linalg.norm(cur["ee_wpos"] - e_wee)
    wee_reward = np.exp(-k_we * wee_dist ** 2)
    com_dist = np.linalg.norm(cur["com"] - e_com)
    com_reward = np.exp(-k_c * com_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_we * wee_reward + w_c * com_reward + w_r * root_reward)
    reward /= w_p + w_v + w_e + w_we + w_c + w_r
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, wee_reward, com_reward, root_reward])


def _local_world_v23(cur, expert, ind, ws, b_diffw, dt, obs_coord,
                     com_z_only, end, end_reward):
    w = ws or {}
    w_p, w_v, w_e, w_h, w_c, w_r = (
        w.get("w_p", 0.4), w.get("w_v", 0.05), w.get("w_e", 0.15),
        w.get("w_h", 0.1), w.get("w_c", 0.1), w.get("w_r", 0.2))
    k_h, k_c = w.get("k_h", 20), w.get("k_c", 1000)

    pose_reward, vel_reward, ee_reward, root_reward = _local_world_base(
        cur, expert, ind, w, b_diffw, dt, obs_coord)

    e_com = _sync_point(expert["com"][ind].copy(), expert)
    e_rq = _quat_mul(expert["rel_heading"],
                     expert["qpos"][ind][3:7])
    h_dist = get_heading(cur["qpos"][3:7]) - get_heading(e_rq)
    h_reward = np.exp(-k_h * h_dist ** 2)

    if com_z_only:
        com_dist = cur["com"][2] - e_com[2]
    else:
        com_dist = np.linalg.norm(cur["com"] - e_com)
    com_reward = np.exp(-k_c * com_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_h * h_reward + w_c * com_reward + w_r * root_reward)
    reward /= w_p + w_v + w_e + w_h + w_c + w_r
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, h_reward, com_reward, root_reward])


def local_world_reward_v2(cur, expert, ind, action, ws=None, b_diffw=1.0,
                          dt=1 / 30, obs_coord="heading",
                          end=False, end_reward=0.0):
    """(:468-539): v1 with heading-angle term, full-vector com."""
    return _local_world_v23(cur, expert, ind, ws, b_diffw, dt, obs_coord,
                            com_z_only=False, end=end, end_reward=end_reward)


def local_world_reward_v3(cur, expert, ind, action, ws=None, b_diffw=1.0,
                          dt=1 / 30, obs_coord="heading",
                          end=False, end_reward=0.0):
    """(:541-612): v2 but com scored on height only."""
    return _local_world_v23(cur, expert, ind, ws, b_diffw, dt, obs_coord,
                            com_z_only=True, end=end, end_reward=end_reward)


# -- world_quat family (:614-738) --------------------------------------------

def world_quat_space_reward(cur, expert, ind, action, ws=None, b_diffw=1.0,
                            dt=1 / 30, end=False, end_reward=0.0):
    """(:614-665): world terms with sim-synced expert root quat/com/ee."""
    w = ws or {}
    w_p, w_v, w_e, w_c = (w.get("w_p", 0.6), w.get("w_v", 0.1),
                          w.get("w_e", 0.2), w.get("w_c", 0.1))
    k_p, k_v, k_e, k_c = (w.get("k_p", 2), w.get("k_v", 0.005),
                          w.get("k_e", 20), w.get("k_c", 1000))
    v_ord = w.get("v_ord", 2)

    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    e_bquat = expert["bquat"][ind].copy()
    e_bquat[:4] = _quat_mul(expert["rel_heading"], e_bquat[:4])
    e_com = _sync_point(expert["com"][ind].copy(), expert)
    e_ee = _sync_points_flat(expert["ee_wpos"][ind].copy(), expert)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"], e_bquat)).copy()
    pose_diff[1:] *= b_diffw
    pose_reward = np.exp(-k_p * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(
        cur_bangvel - expert["bangvel"][ind], ord=v_ord)
    vel_reward = np.exp(-k_v * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_wpos"] - e_ee)
    ee_reward = np.exp(-k_e * ee_dist ** 2)

    com_dist = np.linalg.norm(cur["com"] - e_com)
    com_reward = np.exp(-k_c * com_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_c * com_reward)
    reward /= w_p + w_v + w_e + w_c
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, com_reward])


def world_quat_space_reward_v2(cur, expert, ind, action, ws=None, b_diffw=1.0,
                               dt=1 / 30, end=False, end_reward=0.0):
    """(:667-738): + combined root pos/quat/linv/angv term (root-frame qvel,
    expert rlinv rotated by rel_heading)."""
    w = ws or {}
    w_p, w_v, w_e, w_c, w_r = (w.get("w_p", 0.3), w.get("w_v", 0.1),
                               w.get("w_e", 0.3), w.get("w_c", 0.1),
                               w.get("w_r", 0.2))
    k_p, k_v, k_e, k_c, k_r = (w.get("k_p", 2), w.get("k_v", 0.005),
                               w.get("k_e", 20), w.get("k_c", 1000),
                               w.get("k_r", 1.0))
    w_rpos, w_rq, w_rlinv, w_rangv = (
        w.get("w_rpos", 5.0), w.get("w_rq", 2.0), w.get("w_rlinv", 1.0),
        w.get("w_rangv", 0.1))
    v_ord = w.get("v_ord", 2)

    cur_qvel = get_qvel_fd(cur["prev_qpos"], cur["qpos"], dt)
    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)

    e_qpos = expert["qpos"][ind]
    e_rq = _quat_mul(expert["rel_heading"], e_qpos[3:7])
    e_rlinv = quat_mul_vec(expert["rel_heading"], expert["rlinv"][ind])
    e_com = _sync_point(expert["com"][ind].copy(), expert)
    e_ee = _sync_points_flat(expert["ee_wpos"][ind].copy(), expert)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"][4:], expert["bquat"][ind][4:])).copy()
    pose_diff *= b_diffw
    pose_reward = np.exp(-k_p * np.linalg.norm(pose_diff) ** 2)

    vel_dist = np.linalg.norm(
        cur_bangvel[3:] - expert["bangvel"][ind][3:], ord=v_ord)
    vel_reward = np.exp(-k_v * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_wpos"] - e_ee)
    ee_reward = np.exp(-k_e * ee_dist ** 2)

    com_dist = np.linalg.norm(cur["com"] - e_com)
    com_reward = np.exp(-k_c * com_dist ** 2)

    rpos_dist = np.linalg.norm(cur["qpos"][:3] - e_qpos[:3])
    rq_dist = multi_quat_norm(multi_quat_diff(cur["qpos"][3:7], e_rq))[0]
    rlinv_dist = np.linalg.norm(cur_qvel[:3] - e_rlinv)
    rangv_dist = np.linalg.norm(cur_qvel[3:6] - expert["rangv"][ind])
    root_dist = (w_rpos * rpos_dist + w_rq * rq_dist
                 + w_rlinv * rlinv_dist + w_rangv * rangv_dist)
    root_reward = np.exp(-k_r * root_dist ** 2)

    reward = (w_p * pose_reward + w_v * vel_reward + w_e * ee_reward
              + w_c * com_reward + w_r * root_reward)
    reward /= w_p + w_v + w_e + w_c + w_r
    if end:
        reward += end_reward
    return float(reward), np.array(
        [pose_reward, vel_reward, ee_reward, com_reward, root_reward])


# -- fine_tune family (:740-929) ---------------------------------------------

def _head_terms(cur, expert, ind, w, dt, fix_start_ind):
    """Shared fine-tune head tracking: position, orientation (v2 norm),
    velocity.  The reference's fix_start_ind=None branch never assigns
    e_hvel and would NameError (:760, :830) — our port always indexes
    head_info/hvel at ind + fix_start_ind (default 0)."""
    i = ind + fix_start_ind
    e_hpos = expert["head_info"][i]
    e_hvel = expert["hvel"][i]

    cur_hpos, prev_hpos = cur["head_pose"], cur["prev_head_pose"]
    hpvel = (cur_hpos[:3] - prev_hpos[:3]) / dt
    hqvel = get_angvel_fd(prev_hpos[3:], cur_hpos[3:], dt)

    hp_dist = np.linalg.norm(cur_hpos[:3] - e_hpos[:3])
    hp_reward = np.exp(-w.get("k_rp", 1.0) * hp_dist ** 2)

    hq_dist = np.linalg.norm(
        multi_quat_norm_v2(multi_quat_diff(cur_hpos[3:], e_hpos[3:])))
    hq_reward = np.exp(-w.get("k_rq", 1.0) * hq_dist ** 2)

    hpvel_dist = np.linalg.norm(hpvel - e_hvel[:3])
    hqvel_dist = np.linalg.norm(hqvel - e_hvel[3:])
    hvel_reward = np.exp(-hpvel_dist - w.get("k_v", 0.1) * hqvel_dist)
    return float(hp_reward), float(hq_reward), float(hvel_reward)


def fine_tune_kin_action_reward(cur, expert, ind, action, old_action,
                                ws=None, dt=1 / 30, fix_start_ind=0,
                                kin_bquat=None, adap_weight=False,
                                kin_lvel=None, end=False, end_reward=0.0):
    """(:740-805).  kin_bquat: the kinematic policy's non-root body quats
    (env.convert_body_quat(get_kinematic_pose_ind(ind)) — env-side in the
    reference); adap_weight shifts w_p/w_a by the kinematic-velocity match."""
    w = ws or {}
    w_rp, w_rq, w_a, w_p, w_v, w_end = (
        w.get("w_rp", 1.0), w.get("w_rq", 1.0), w.get("w_a", 0.05),
        w.get("w_p", 1.0), w.get("w_v", 1.0), w.get("w_end", 0.0))
    hp_reward, hq_reward, hvel_reward = _head_terms(
        cur, expert, ind, w, dt, fix_start_ind)

    if adap_weight:
        e_hvel_local = expert["hvel_local"][ind + fix_start_ind]
        w_p = float(np.exp(-1.0 * np.linalg.norm(kin_lvel - e_hvel_local)))
        w_a = (1.0 - w_p) * 0.1

    action_dist = np.linalg.norm(np.asarray(action) - np.asarray(old_action))
    action_reward = np.exp(-w.get("k_a", 1.0) * action_dist ** 2)

    pose_diff = multi_quat_norm_v2(
        multi_quat_diff(cur["bquat"][4:], kin_bquat))
    pose_reward = np.exp(-w.get("k_p", 1.0) * np.linalg.norm(pose_diff) ** 2)

    reward = (w_rp * hp_reward + w_rq * hq_reward + w_v * hvel_reward
              + w_p * pose_reward + w_a * action_reward)
    reward /= w_rp + w_rq + w_v + w_p + w_a
    if end:
        reward = reward + w_end * end_reward
    return float(reward), np.array(
        [hp_reward, hq_reward, hvel_reward, pose_reward, action_reward])


def fine_tune_action_reward(cur, expert, ind, action, old_action, ws=None,
                            dt=1 / 30, fix_start_ind=0,
                            end=False, end_reward=0.0):
    """(:807-861): product of head terms + w_a-scaled action proximity."""
    w = ws or {}
    w_a, w_end = w.get("w_a", 0.05), w.get("w_end", 1.0)
    hp_reward, hq_reward, hvel_reward = _head_terms(
        cur, expert, ind, w, dt, fix_start_ind)
    action_dist = np.linalg.norm(np.asarray(action) - np.asarray(old_action))
    action_reward = np.exp(-w.get("k_a", 1.0) * action_dist ** 2)
    reward = hp_reward * hq_reward * hvel_reward + w_a * action_reward
    if end:
        reward = reward + w_end * end_reward
    return float(reward), np.array(
        [hp_reward, hq_reward, hvel_reward, action_reward])


def fine_tune_reward(cur, expert, ind, action, ws=None, dt=1 / 30,
                     fix_start_ind=0, kin_bquat=None, adap_weight=False,
                     kin_lvel=None, end=False, end_reward=0.0):
    """(:863-929): product of head terms and kinematic-pose proximity; the
    end bonus MULTIPLIES here (:927)."""
    w = ws or {}
    hp_reward, hq_reward, hvel_reward = _head_terms(
        cur, expert, ind, w, dt, fix_start_ind)
    # adap_weight computes a kin_weight that the reference then never uses
    # in the product (:891-895) — preserved as a no-op
    pose_diff = multi_quat_norm_v2(
        multi_quat_diff(cur["bquat"][4:], kin_bquat))
    pose_reward = np.exp(-w.get("k_p", 1.0) * np.linalg.norm(pose_diff) ** 2)
    reward = hp_reward * hq_reward * hvel_reward * pose_reward
    if end:
        reward = reward * end_reward
    return float(reward), np.array(
        [hp_reward, hq_reward, hvel_reward, pose_reward])


SIM_REWARD_FUNCS = {
    "quat_v2": quat_space_reward_v2,
    "quat_v3": quat_space_reward_v3,
    "deep_mimic": deep_mimic_reward,
    "deep_mimic_v2": deep_mimic_reward_v2,
    "deep_mimic_reward_v2_vf": deep_mimic_reward_v2_vf,
    "deep_mimic_reward_v2_vf_vq": deep_mimic_reward_v2_vf_vq,
    "multiplicable_reward": multiplicable_reward,
    "local_world_v1": local_world_reward_v1,
    "local_world_v2": local_world_reward_v2,
    "local_world_v3": local_world_reward_v3,
    "world_quat": world_quat_space_reward,
    "world_quat_v2": world_quat_space_reward_v2,
    "fine_tune_kin_action_reward": fine_tune_kin_action_reward,
    "fine_tune_action_reward": fine_tune_action_reward,
    "fine_tune_reward": fine_tune_reward,
}
