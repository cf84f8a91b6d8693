"""relive HumanoidAREnv observations, pure numpy (port of
egoego_release_tpu/rl/ar_obs.py, copied; the re-exports point at the
port's modules).

Port of kinpoly/relive/envs/humanoid_ar_v1.py:126-340 — the two observation
surfaces of the AR (kinematic-policy + physics) env:

  * `get_ar_obs_v1` (:259-340): the AR POLICY's observation — optional RNN
    context features, deheaded current qpos, qvel, head-tracking differences
    in the predicted head's heading frame, object-relative poses (predicted
    and target), action one-hot, optical flow, and (policy_v 2) the raw
    ARNet qpos
  * `get_cc_obs` (:130-135): the CONTROL policy's observation — the UHC
    obs v0/v1 computed against the kinematic TARGET pose instead of the
    next expert frame (get_full_obs :138-163, get_full_obs_v1 :165-256);
    delegated to uhc_obs.obs_v12_core / the v0 builder with a target dict

State contract: cur = dict(qpos, qvel, wbpos, wbquat) from the simulator;
ar_context = the kinpoly record arrays (head_pose, head_vels,
obj_head_relative_poses, action_one_hot, optionally context_feat_rnn / of /
ar_qpos); obj_qpos = the active object's 7d pose (get_obj_qpos with the
action one-hot, :784-795 — identity [0,0,0,1,0,0,0] when no action).
Held equal to the JAX package's copy by tests/test_torch_uhc.py.
"""

from __future__ import annotations

import numpy as np

from egoego_release_tpu_torch.rl.sim_rewards import get_heading  # noqa: F401 (re-export)
from egoego_release_tpu_torch.rl.uhc_obs import (  # noqa: F401 (re-exports)
    DEFAULT_OBS_SPECS,
    obs_v12_core,
    transform_vec_batch,
)
from egoego_release_tpu_torch.rl.uhc_rewards import (
    _quat_inv,
    _quat_mul,
    de_heading,
    get_heading_q,
    transform_vec,
)

NO_ACTION_OBJ_QPOS = np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])  # :789


DEFAULT_AR_SPECS = dict(use_context=False, use_of=False, use_head=True,
                        use_vel=True, use_action=True, ar_model_v=1,
                        policy_v=1, context_dim=256)


def get_ar_obs_v1(cur: dict, ar_context: dict, cur_t: int,
                  obj_qpos: np.ndarray | None = None,
                  head_idx: int | None = None,
                  specs: dict | None = None) -> np.ndarray:
    """(:259-340).  head_idx: Head's row in the world-body arrays
    (get_head_idx :256-257); default = the kinpoly humanoid's 15."""
    s = dict(DEFAULT_AR_SPECS, **(specs or {}))
    t = cur_t
    hi = 15 if head_idx is None else head_idx
    curr_action = np.asarray(ar_context["action_one_hot"][0], np.float64)
    obs = []

    curr_qpos = np.asarray(cur["qpos"], np.float64).copy()
    curr_qvel = np.asarray(cur["qvel"], np.float64).copy()
    curr_qpos_local = curr_qpos.copy()
    curr_qpos_local[3:7] = de_heading(curr_qpos_local[3:7])

    pred_wbpos = np.asarray(cur["wbpos"], np.float64).reshape(-1, 3)
    pred_wbquat = np.asarray(cur["wbquat"], np.float64).reshape(-1, 4)
    pred_hrot = pred_wbquat[hi]
    pred_hpos = pred_wbpos[hi]

    if s["use_context"] or s["use_of"]:
        if "context_feat_rnn" in ar_context:
            obs.append(np.asarray(ar_context["context_feat_rnn"][t, :],
                                  np.float64))
        else:
            obs.append(np.zeros(s["context_dim"]))

    if s["use_head"]:
        t_hrot = np.asarray(ar_context["head_pose"][t, 3:], np.float64).copy()
        t_hpos = np.asarray(ar_context["head_pose"][t, :3], np.float64).copy()
        t_havel = np.asarray(ar_context["head_vels"][t, 3:], np.float64).copy()
        t_hlvel = np.asarray(ar_context["head_vels"][t, :3], np.float64).copy()
        t_obj_relative_head = np.asarray(
            ar_context["obj_head_relative_poses"][t, :], np.float64).copy()
        diff_hpos = transform_vec(t_hpos - pred_hpos, pred_hrot, "heading")
        diff_hrot = _quat_mul(_quat_inv(t_hrot), pred_hrot)

    q_heading = get_heading_q(pred_hrot).copy()
    obj = (NO_ACTION_OBJ_QPOS if obj_qpos is None
           else np.asarray(obj_qpos, np.float64))
    diff_obj_loc = transform_vec(obj[:3] - pred_hpos, pred_hrot, "heading")
    obj_rot_local = _quat_mul(_quat_inv(q_heading), obj[3:7])
    pred_obj_relative_head = np.concatenate([diff_obj_loc, obj_rot_local])

    obs.append(curr_qpos_local[2:])
    if s["use_vel"]:
        obs.append(curr_qvel)
    if s["use_head"]:
        obs.append(diff_hpos)
        obs.append(diff_hrot)
    obs.append(pred_obj_relative_head)
    if s["use_head"]:
        obs.append(t_havel)
        obs.append(t_hlvel)
        obs.append(t_obj_relative_head)
    if s["use_action"] and s["ar_model_v"] > 0:
        obs.append(curr_action)
    if s["use_of"]:
        obs.append(np.asarray(ar_context["of"][t, :], np.float64))
    if s["policy_v"] == 2:
        obs.append(np.asarray(ar_context["ar_qpos"][cur_t], np.float64))
    return np.concatenate(obs)


def get_cc_obs_v0(cur: dict, target_qpos: np.ndarray,
                  specs: dict | None = None) -> np.ndarray:
    """relive get_full_obs (:138-163): the UHC v0 layout with the kinematic
    target's joint pose appended (get_target_kin_pose)."""
    s = dict(DEFAULT_OBS_SPECS, **(specs or {}))
    qpos = np.asarray(cur["qpos"], np.float64).copy()
    qvel = np.asarray(cur["qvel"], np.float64).copy()
    qvel[:3] = transform_vec(qvel[:3], qpos[3:7], s["obs_coord"]).ravel()
    obs = []
    if s["obs_heading"]:
        obs.append(np.array([get_heading(qpos[3:7])]))
    if s["root_deheading"]:
        qpos[3:7] = de_heading(qpos[3:7])
    obs.append(qpos[2:])
    if s["obs_vel"] == "root":
        obs.append(qvel[:6])
    elif s["obs_vel"] == "full":
        obs.append(qvel)
    obs.append(np.asarray(target_qpos, np.float64)[7:])
    return np.concatenate(obs)


def get_cc_obs_v1(cur: dict, target: dict,
                  specs: dict | None = None) -> np.ndarray:
    """relive get_full_obs_v1 (:165-256): the UHC v1 layout computed against
    the kinematic target dict (qpos, wbpos, body_com, wbquat)."""
    return obs_v12_core(cur, target, specs, with_com=True)


def get_cc_obs(cur: dict, target: dict, obs_v: int = 1,
               specs: dict | None = None) -> np.ndarray:
    """(:130-135) dispatch on cc_cfg.obs_v."""
    if obs_v == 0:
        return get_cc_obs_v0(cur, target["qpos"], specs)
    return get_cc_obs_v1(cur, target, specs)
