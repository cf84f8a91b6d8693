"""UHC (copycat) policy observations, pure numpy (port of
egoego_release_tpu/rl/uhc_obs.py, copied).

Port of kinpoly/copycat/envs/humanoid_im.py:121-366 — the observation
builders that define the trained-policy input contract:

  * obs_v 0 `get_full_obs`    (:131-158): [heading?] + deheaded qpos[2:] +
    local-frame qvel + expert kin pose (+ phase?)
  * obs_v 1 `get_full_obs_v1` (:163-266): heading quat, target/current/diff
    body pose, local qvel, rel heading + xy, body-frame joint positions,
    body coms, heading-relative + target-relative world body quats
  * obs_v 2 `get_full_obs_v2` (:285-366): v1 without the com blocks

Reference quirks preserved exactly (they define the checkpoint contract):

  * `transform_vec_batch` (khrylib math.py:117-130) returns the TRANSPOSED
    (3, J) array, so the raveled joint-position obs are component-major
  * `rel_pos = target_root_quat[:3] - qpos[:3]` (:212, :319) subtracts the
    root position from the first three QUAT components — a reference bug
    that shipped in the trained policies
  * the v1/v2 `cur_quat[0, 0] == 0` guard substitutes the target quats
  * base_rot default [0.7071, 0.7071, 0, 0] (:34), removed from root quats
    before heading extraction

Everything is a function of explicit state:  cur = dict(qpos, qvel, wbpos,
body_com, wbquat) from the simulator (uhc_rewards env_* extractors), expert
= expert_physics_attrs dict.  no_root stays False (the no-root-translation
model variant is untrained legacy).  Held equal to the JAX
package's copy by tests/test_torch_uhc.py.
"""

from __future__ import annotations

import numpy as np

from egoego_release_tpu_torch.rl.uhc_rewards import (
    _quat_inv,
    _quat_mul,
    _quat_to_mat,
    de_heading,
    get_heading_q,
    transform_vec,
)
from egoego_release_tpu_torch.rl.sim_rewards import get_heading

BASE_ROT = np.array([0.7071, 0.7071, 0.0, 0.0])  # humanoid_im.py:34

DEFAULT_OBS_SPECS = dict(obs_coord="heading", obs_vel="root",
                         obs_heading=False, root_deheading=False,
                         obs_phase=False)


def transform_vec_batch(v_b: np.ndarray, q: np.ndarray,
                        trans: str = "root") -> np.ndarray:
    """(J, 3) world vectors -> TRANSPOSED (3, J) root/heading-frame array
    (khrylib math.py:117-130: rot.T.dot(v[:, :, None]).squeeze())."""
    rot = _quat_to_mat(get_heading_q(q) if trans == "heading" else q)
    return rot.T @ np.asarray(v_b, np.float64).T


def remove_base_rot(quat: np.ndarray, base_rot: np.ndarray = BASE_ROT) -> np.ndarray:
    """(:118-119): strip the MJCF base rotation from a root quat."""
    return _quat_mul(quat, _quat_inv(base_rot))


def expert_index(cur_t: int, start_ind: int, expert: dict) -> int:
    """(:680-685): cyclic wrap or clamp to the last expert frame."""
    if expert.get("meta", {}).get("cyclic", False):
        return (start_ind + cur_t) % expert["len"]
    return min(start_ind + cur_t, expert["len"] - 1)


def get_full_obs(cur: dict, expert: dict, cur_t: int, start_ind: int = 0,
                 specs: dict | None = None) -> np.ndarray:
    """obs_v 0 (:131-158)."""
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
    ind = expert_index(cur_t, start_ind, expert)
    obs.append(expert["qpos"][ind][7:])  # get_expert_kin_pose (:712-713)
    if s["obs_phase"]:
        obs.append(np.array([cur_t / expert["len"]]))
    return np.concatenate(obs)


def obs_v12_core(cur: dict, target: dict, specs: dict | None,
                 with_com: bool) -> np.ndarray:
    """Shared v1/v2 body (:163-266 / :285-366) over an explicit target dict
    (qpos, wbpos, body_com, wbquat); with_com adds the two body-com blocks
    that v2 drops.  The relive AR env's control-policy obs
    (humanoid_ar_v1.py:165-256) is this same computation with the kinematic
    TARGET pose in place of the next expert frame — see rl/ar_obs.py."""
    s = dict(DEFAULT_OBS_SPECS, **(specs or {}))
    base_rot = np.asarray(s.get("base_rot", BASE_ROT), np.float64)
    qpos = np.asarray(cur["qpos"], np.float64).copy()
    qvel = np.asarray(cur["qvel"], np.float64).copy()
    qvel[:3] = transform_vec(qvel[:3], qpos[3:7], s["obs_coord"]).ravel()
    obs = []

    curr_root_quat = remove_base_rot(qpos[3:7], base_rot)
    hq = get_heading_q(curr_root_quat)
    obs.append(hq)

    target_body_qpos = np.asarray(target["qpos"], np.float64).copy()
    target_root_quat = remove_base_rot(target_body_qpos[3:7], base_rot)

    qpos[3:7] = de_heading(curr_root_quat)
    diff_qpos = target_body_qpos.copy()
    diff_qpos[2] -= qpos[2]
    diff_qpos[7:] -= qpos[7:]
    diff_qpos[3:7] = _quat_mul(target_root_quat, _quat_inv(curr_root_quat))

    obs.append(target_body_qpos[2:])
    obs.append(qpos[2:])
    obs.append(diff_qpos[2:])

    # second transform, now into the base-rot-removed root frame (:198, :305)
    qvel[:3] = transform_vec(qvel[:3], curr_root_quat, s["obs_coord"]).ravel()
    if s["obs_vel"] == "root":
        obs.append(qvel[:6])
    elif s["obs_vel"] == "full":
        obs.append(qvel)

    rel_h = get_heading(target_root_quat) - get_heading(curr_root_quat)
    if rel_h > np.pi:
        rel_h -= 2 * np.pi
    if rel_h < -np.pi:
        rel_h += 2 * np.pi
    obs.append(np.array([rel_h]))

    # reference bug kept: quat components minus root position (:212, :319)
    rel_pos = target_root_quat[:3] - qpos[:3]
    rel_pos = transform_vec(rel_pos, curr_root_quat, s["obs_coord"]).ravel()
    obs.append(rel_pos[:2])

    target_jpos = np.asarray(target["wbpos"], np.float64)
    curr_jpos = np.asarray(cur["wbpos"], np.float64).reshape(-1, 3)
    r_jpos = transform_vec_batch(curr_jpos - qpos[None, :3],
                                 curr_root_quat, s["obs_coord"])
    obs.append(r_jpos.ravel())
    diff_jpos = transform_vec_batch(target_jpos.reshape(-1, 3) - curr_jpos,
                                    curr_root_quat, s["obs_coord"])
    obs.append(diff_jpos.ravel())

    if with_com:
        target_com = np.asarray(target["body_com"], np.float64)
        curr_com = np.asarray(cur["body_com"], np.float64).reshape(-1, 3)
        r_com = transform_vec_batch(curr_com - qpos[None, :3],
                                    curr_root_quat, s["obs_coord"])
        obs.append(r_com.ravel())
        diff_com = transform_vec_batch(
            target_com.reshape(-1, 3) - curr_com,
            curr_root_quat, s["obs_coord"])
        obs.append(diff_com.ravel())

    target_quat = np.asarray(target["wbquat"], np.float64).reshape(-1, 4)
    cur_quat = np.asarray(cur["wbquat"], np.float64).reshape(-1, 4).copy()
    if cur_quat[0, 0] == 0:
        cur_quat = target_quat.copy()
    r_quat = np.stack([_quat_mul(_quat_inv(hq), q) for q in cur_quat])
    obs.append(r_quat.ravel())
    rel_quat = np.stack([
        _quat_mul(_quat_inv(cq), tq) for cq, tq in zip(cur_quat, target_quat)
    ])
    obs.append(rel_quat.ravel())

    return np.concatenate(obs)


def _expert_target(expert: dict, cur_t: int, start_ind: int) -> dict:
    """Next-frame expert target (get_expert_* with delta_t=1, :698-751)."""
    ind1 = expert_index(cur_t + 1, start_ind, expert)
    return {"qpos": expert["qpos"][ind1], "wbpos": expert["wbpos"][ind1],
            "body_com": expert["body_com"][ind1],
            "wbquat": expert["wbquat"][ind1]}


def get_full_obs_v1(cur: dict, expert: dict, cur_t: int, start_ind: int = 0,
                    specs: dict | None = None) -> np.ndarray:
    """obs_v 1 (:163-266)."""
    return obs_v12_core(cur, _expert_target(expert, cur_t, start_ind),
                        specs, with_com=True)


def get_full_obs_v2(cur: dict, expert: dict, cur_t: int, start_ind: int = 0,
                    specs: dict | None = None) -> np.ndarray:
    """obs_v 2 (:285-366) — the bundled copycat.yml config (obs_v: 2)."""
    return obs_v12_core(cur, _expert_target(expert, cur_t, start_ind),
                        specs, with_com=False)


def uhc_observation(cur: dict, expert: dict, cur_t: int, start_ind: int = 0,
                    obs_v: int = 2, specs: dict | None = None) -> np.ndarray:
    """Dispatch on cfg.obs_v (:121-129)."""
    fn = {0: get_full_obs, 1: get_full_obs_v1, 2: get_full_obs_v2}[obs_v]
    return fn(cur, expert, cur_t, start_ind=start_ind, specs=specs)
