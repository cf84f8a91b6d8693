"""UHC (copycat) world-coordinate imitation rewards on simulator state
(port of egoego_release_tpu/rl/uhc_rewards.py: host numpy, copied).

Port of kinpoly/copycat/core/reward_function.py — the family the UHC
training configs actually use (`reward_id: world_rfc_implicit` in BOTH
bundled configs, copycat/cfg/{copycat,deepmimic}.yml:27):

  reward = (w_p e^{-k_p |pose_diff|^2} + w_v e^{-k_v |bangvel_diff|^2}
            + w_e e^{-k_e |ee_diff|^2} + w_c e^{-k_c |com_diff|^2}
            + w_vf e^{-k_vf |vf|^2}) / sum(w)            (:4-54)

plus the multiplicative variant `world_rfc_implicit_v1_mul` (:56-106), and
the full remaining registry (:453-460): `world_rfc_explicit` (:105-170,
split contact-point/force residual terms + cyclic-expert remapping),
`local_rfc_implicit`/`local_rfc_explicit` (:172-299, heading-local root
velocities + de-headed root quat, root excluded from pose/vel terms), and
`world_rfc_implicit_v2`/`_v3` (:301-452, world-quat/body-com/joint-pos
means with per-joint jpos_diffw; v2 multiplicative, v3 weighted-sum).
Everything is a pure numpy function over explicit state (this repo's
rl/control.py style); the simulator quantities come from
MujocoHumanoidEnv via the helpers below:

  * `body_quat_local`  — root quat + per-body sxyz-euler->quat of the qpos
    joint angles (humanoid_im.py:384-397; NOTE: local joint quats, not the
    world xquat used by the relive dynamic-supervision context)
  * `expert_physics_attrs` — replays expert qpos through mj_kinematics +
    mj_comPos collecting bquat/ee_wpos/com and finite-difference bangvel,
    the subset of copycat/utils/tools.get_expert (:5-45) these rewards read

The JAX package golden-tests these against the reference's own reward
functions; tests/test_torch_uhc.py holds this copy equal to it on the
same MuJoCo state. ``import mujoco`` stays inside the two functions that
need it, so the module imports on a machine without MuJoCo.
"""

from __future__ import annotations

import numpy as np

EE_NAMES = ("L_Toe", "R_Toe", "L_Wrist", "R_Wrist", "Head")  # humanoid_im.py:371

_DEFAULTS = dict(w_p=0.6, w_v=0.1, w_e=0.2, w_c=0.1, w_vf=0.0,
                 k_p=2.0, k_v=0.005, k_e=20.0, k_c=1000.0, k_vf=1.0, v_ord=2)


# -- quaternion helpers (wxyz, numpy) ---------------------------------------

def _quat_mul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _quat_inv(q):
    out = q.copy()
    out[..., 1:] *= -1.0
    return out / np.maximum((q * q).sum(-1, keepdims=True), 1e-12)


def multi_quat_diff(nq1: np.ndarray, nq0: np.ndarray) -> np.ndarray:
    """Flat (J*4,) quat arrays -> per-body relative quats (khrylib math)."""
    a = nq1.reshape(-1, 4)
    b = nq0.reshape(-1, 4)
    return _quat_mul(a, _quat_inv(b)).reshape(-1)


def multi_quat_norm(nq: np.ndarray) -> np.ndarray:
    """arccos(|w|) per body — the khrylib multi_quat_norm (math.py:173-177;
    the HALF rotation angle, no normalization)."""
    return np.arccos(np.clip(np.abs(nq[::4]), -1.0, 1.0))


def _rotation_from_quaternion(q: np.ndarray) -> np.ndarray:
    """(J, 4) -> (J, 3) axis*angle, angle = 2 acos(w) UNWRAPPED and axis from
    sqrt(1-w^2) (khrylib transformation.py:348-356 exactly — w < 0 yields
    angles > pi, which the reference's get_angvel_fd keeps)."""
    w = np.clip(q[:, 0], -1.0, 1.0)
    small = (1.0 - np.abs(w)) < 1e-8
    s = np.sqrt(np.maximum(1.0 - w * w, 1e-32))
    axis = np.where(small[:, None], np.array([1.0, 0.0, 0.0]), q[:, 1:4] / s[:, None])
    angle = np.where(small, 0.0, 2.0 * np.arccos(w))
    return axis * angle[:, None]


def get_angvel_fd(prev_bquat: np.ndarray, cur_bquat: np.ndarray, dt: float) -> np.ndarray:
    """Finite-difference body angular velocities, (J*3,) (math.py:69-75)."""
    dq = multi_quat_diff(cur_bquat, prev_bquat).reshape(-1, 4)
    return (_rotation_from_quaternion(dq) / dt).reshape(-1)


def euler_sxyz_to_quat(e: np.ndarray) -> np.ndarray:
    """Static-xyz euler (..., 3) -> wxyz quat (Gohlke quaternion_from_euler
    default axes, used by get_body_quat — humanoid_im.py:393)."""
    ai, aj, ak = e[..., 0] / 2.0, e[..., 1] / 2.0, e[..., 2] / 2.0
    ci, si = np.cos(ai), np.sin(ai)
    cj, sj = np.cos(aj), np.sin(aj)
    ck, sk = np.cos(ak), np.sin(ak)
    return np.stack([
        ci * cj * ck + si * sj * sk,
        si * cj * ck - ci * sj * sk,
        ci * sj * ck + si * cj * sk,
        ci * cj * sk - si * sj * ck,
    ], axis=-1)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """wxyz quat -> 3x3 rotation, Gohlke quaternion_matrix semantics
    (khrylib transformation.py:1267: self-normalizing via n = q.q)."""
    q = np.asarray(q, np.float64)
    n = float(q @ q)
    if n < 1e-12:
        return np.eye(3)
    q = q * np.sqrt(2.0 / n)
    o = np.outer(q, q)
    return np.array([
        [1.0 - o[2, 2] - o[3, 3], o[1, 2] - o[3, 0], o[1, 3] + o[2, 0]],
        [o[1, 2] + o[3, 0], 1.0 - o[1, 1] - o[3, 3], o[2, 3] - o[1, 0]],
        [o[1, 3] - o[2, 0], o[2, 3] + o[1, 0], 1.0 - o[1, 1] - o[2, 2]],
    ])


def quat_mul_vec(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate (..., 3) by quat (khrylib math.py:180-184)."""
    shape = np.shape(v)
    return (np.reshape(v, (-1, 3)) @ _quat_to_mat(q).T).reshape(shape)


def get_heading_q(q: np.ndarray) -> np.ndarray:
    """Yaw-only quat: zero x/y, renormalize (khrylib math.py:132-137)."""
    hq = np.asarray(q, np.float64).copy()
    hq[1] = hq[2] = 0.0
    return hq / np.linalg.norm(hq)


def de_heading(q: np.ndarray) -> np.ndarray:
    """Remove the heading from a root quat (khrylib math.py:154-158)."""
    return _quat_mul(_quat_inv(get_heading_q(q)), np.asarray(q, np.float64))


def transform_vec(v: np.ndarray, q: np.ndarray, trans: str = "root") -> np.ndarray:
    """World vector -> root/heading frame (khrylib math.py:102-115)."""
    rot = _quat_to_mat(get_heading_q(q) if trans == "heading" else q)
    return rot.T @ np.asarray(v, np.float64)


def _rot_from_quat_single(q: np.ndarray):
    """(axis, angle) of one quat (khrylib transformation.py:348-356:
    angle = 2 acos(w) UNWRAPPED; near-identity -> x-axis, 0)."""
    w = float(np.clip(q[0], -1.0, 1.0))
    if 1.0 - abs(w) < 1e-8:
        return np.array([1.0, 0.0, 0.0]), 0.0
    s = np.sqrt(1.0 - w * w)
    return np.asarray(q[1:4], np.float64) / s, 2.0 * np.arccos(w)


def get_qvel_fd_new(cur_qpos: np.ndarray, next_qpos: np.ndarray, dt: float,
                    transform: str | None = None) -> np.ndarray:
    """Finite-difference qvel with pi-wrapped root angle and joint diffs
    (khrylib math.py:45-65); root angvel in root coords, linear velocity
    optionally transformed (the expert pipeline passes no transform; the
    local rewards pass cfg.obs_coord)."""
    v = (next_qpos[:3] - cur_qpos[:3]) / dt
    qrel = _quat_mul(next_qpos[3:7], _quat_inv(cur_qpos[3:7]))
    axis, angle = _rot_from_quat_single(qrel)
    while angle > np.pi:
        angle -= 2 * np.pi
    while angle < -np.pi:
        angle += 2 * np.pi
    rv = transform_vec(axis * angle / dt, cur_qpos[3:7], "root")
    diff = (next_qpos[7:] - cur_qpos[7:]).copy()
    while np.any(diff > np.pi):
        diff[diff > np.pi] -= 2 * np.pi
    while np.any(diff < -np.pi):
        diff[diff < -np.pi] += 2 * np.pi
    qvel = np.concatenate([v, rv, diff / dt])
    if transform is not None:
        qvel[:3] = transform_vec(v, cur_qpos[3:7], transform)
    return qvel


# -- simulator-state extraction ---------------------------------------------

def body_qposaddr(model) -> dict[str, tuple[int, int]]:
    """body name -> (start, end) qpos address range (khrylib get_body_qposaddr)."""
    import mujoco

    out = {}
    for i in range(model.nbody):
        j0 = model.body_jntadr[i]
        if j0 < 0:
            continue
        j1 = j0 + model.body_jntnum[i]
        q0 = model.jnt_qposadr[j0]
        q1 = model.jnt_qposadr[j1] if j1 < model.njnt else model.nq
        name = mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_BODY, i)
        out[name] = (int(q0), int(q1))
    return out


def body_quat_local(qpos: np.ndarray, qaddr: dict[str, tuple[int, int]],
                    body_names: list[str]) -> np.ndarray:
    """Flat (J*4,) local body quats: [root qpos quat, euler->quat per body]
    (humanoid_im.py:384-397; Pelvis holds the free joint, skipped; iteration
    stops at the humanoid subtree — body_names[1:body_lim] in the reference,
    so *_all object bodies with free joints never enter)."""
    quats = [qpos[3:7]]
    for name in body_names[: BODY_LIM - 1]:
        if name == "Pelvis" or name not in qaddr:
            continue
        s, e = qaddr[name]
        euler = np.zeros(3)
        euler[: e - s] = qpos[s:e]
        quats.append(euler_sxyz_to_quat(euler))
    return np.concatenate(quats)


def env_ee_wpos(env) -> np.ndarray:
    """World end-effector positions, (len(EE_NAMES)*3,) (get_ee_pos(None))."""
    out = []
    for name in EE_NAMES:
        i = env.body_names.index(name) + 1
        out.append(env.data.xpos[i].copy())
    return np.concatenate(out)


def env_com(env) -> np.ndarray:
    """Whole-tree center of mass (humanoid_im.py:411: subtree_com[0])."""
    return env.data.subtree_com[0].copy()


BODY_LIM = 25  # humanoid_im.py:26 — world + the 24 humanoid bodies; the
#                object-bearing *_all models append objects AFTER this range


def _lim(env) -> int:
    return min(env.model.nbody, BODY_LIM)


def env_wbquat(env) -> np.ndarray:
    """World body quats, flat (get_wbody_quat — humanoid_im.py:398-402)."""
    return env.data.xquat[1:_lim(env)].copy().ravel()


def env_wbpos(env) -> np.ndarray:
    """World body positions, flat (get_wbody_pos — humanoid_im.py:420-424)."""
    return env.data.xpos[1:_lim(env)].copy().ravel()


def env_body_com(env) -> np.ndarray:
    """Per-body inertial-frame centers, flat (get_body_com —
    humanoid_im.py:433-444: xipos per body, plane ignored)."""
    return env.data.xipos[1:_lim(env)].copy().ravel()


def env_ee_local(env, obs_coord: str = "heading") -> np.ndarray:
    """End effectors relative to the root, rotated into the root/heading
    frame (get_ee_pos(transform) — humanoid_im.py:369-382)."""
    root_pos = env.data.qpos[:3]
    root_q = env.data.qpos[3:7].copy()
    out = []
    for name in EE_NAMES:
        i = env.body_names.index(name) + 1
        out.append(transform_vec(env.data.xpos[i] - root_pos, root_q, obs_coord))
    return np.concatenate(out)


def expert_physics_attrs(env, qpos_seq: np.ndarray, obs_coord: str = "heading") -> dict:
    """Per-frame expert attrs the UHC rewards read: bquat (T, J*4),
    bangvel (T, J*3) (frame 0 copies frame 1, tools.py:49-52), ee_wpos
    (T, 15), com (T, 3), plus the world/local attrs of the explicit/local/v2
    variants — wbquat/wbpos/body_com (world bodies), ee_pos + rlinv_local
    (obs_coord frame), rangv, rq_rmh (de-headed root quat), qvel clipped to
    +-10 (tools.py:29-37).  Replay uses mj_kinematics + mj_comPos only."""
    import mujoco

    # save/restore the sim state around the replay, as the reference's
    # get_expert does (tools.py:6,:73-74) — otherwise the caller's rollout
    # would start from the LAST replayed expert frame
    saved_qpos = env.data.qpos.copy()
    saved_qvel = env.data.qvel.copy()

    qaddr = body_qposaddr(env.model)
    bquat, ee, com = [], [], []
    wbquat, wbpos, body_com, ee_loc, rq_rmh, head_info = [], [], [], [], [], []
    qvel, rlinv_local, rangv = [], [], []
    for fr in range(len(qpos_seq)):
        env.data.qpos[: qpos_seq.shape[1]] = qpos_seq[fr]
        mujoco.mj_kinematics(env.model, env.data)
        mujoco.mj_comPos(env.model, env.data)
        bquat.append(body_quat_local(qpos_seq[fr], qaddr, env.body_names))
        ee.append(env_ee_wpos(env))
        com.append(env_com(env))
        wbquat.append(env_wbquat(env))
        wbpos.append(env_wbpos(env))
        body_com.append(env_body_com(env))
        ee_loc.append(env_ee_local(env, obs_coord))
        rq_rmh.append(de_heading(qpos_seq[fr][3:7]))
        head_info.append(env.get_head_pose())
        if fr > 0:
            qv = get_qvel_fd_new(qpos_seq[fr - 1], qpos_seq[fr], env.dt)
            qv = qv.clip(-10.0, 10.0)
            qvel.append(qv)
            rlinv_local.append(
                transform_vec(qv[:3].copy(), qpos_seq[fr][3:7], obs_coord))
            rangv.append(qv[3:6].copy())
    if qvel:  # frame 0 copies frame 1 (tools.py:51-54)
        for lst in (qvel, rlinv_local, rangv):
            lst.insert(0, lst[0].copy())
    else:  # single-frame expert: zero velocities
        qvel = [np.zeros(qpos_seq.shape[1] - 1)]
        rlinv_local = [np.zeros(3)]
        rangv = [np.zeros(3)]
    bquat = np.asarray(bquat)
    if len(bquat) > 1:
        bangvel = np.stack(
            [get_angvel_fd(bquat[i - 1], bquat[i], env.dt)
             for i in range(1, len(bquat))]
        )
        # frame 0 copies frame 1 (tools.py:49-52)
        bangvel = np.concatenate([bangvel[:1], bangvel], axis=0)
    else:
        bangvel = np.zeros((1, (bquat.shape[1] // 4) * 3))
    env.data.qpos[:] = saved_qpos
    env.data.qvel[:] = saved_qvel
    mujoco.mj_forward(env.model, env.data)

    head_info = np.asarray(head_info)
    if len(head_info) > 1:  # hvel: world hpvel + angvel_fd (process_trajs.py:70-79)
        hpvel = (head_info[1:, :3] - head_info[:-1, :3]) / env.dt
        hqvel = np.stack([
            get_angvel_fd(head_info[i - 1, 3:], head_info[i, 3:], env.dt)
            for i in range(1, len(head_info))
        ])
        hvel = np.concatenate([hpvel, hqvel], axis=1)
        hvel = np.concatenate([hvel[:1], hvel], axis=0)  # frame 0 copies 1
        hvel_local = np.stack([
            transform_vec(hvel[i, :3].copy(),
                          head_info[max(i - 1, 0), 3:], "heading")
            for i in range(len(head_info))
        ])
    else:
        hvel = np.zeros((1, 6))
        hvel_local = np.zeros((1, 3))
    rpos0 = np.asarray(qpos_seq[0][:3], np.float64)
    return {
        "bquat": bquat,
        "bangvel": bangvel,
        "ee_wpos": np.asarray(ee),
        "com": np.asarray(com),
        "qpos": np.asarray(qpos_seq),
        "wbquat": np.asarray(wbquat),
        "wbpos": np.asarray(wbpos),
        "body_com": np.asarray(body_com),
        "ee_pos": np.asarray(ee_loc),
        "rq_rmh": np.asarray(rq_rmh),
        "qvel": np.asarray(qvel),
        "rlinv": np.asarray(qvel)[:, :3].copy(),
        "rlinv_local": np.asarray(rlinv_local),
        "rangv": np.asarray(rangv),
        "head_info": head_info,
        "hvel": hvel,
        "hvel_local": hvel_local,
        "len": len(qpos_seq),
        "height_lb": float(np.min(np.asarray(qpos_seq)[:, 2])),
        "head_height_lb": float(head_info[:, 2].min()),
        "meta": {"cyclic": False},
        # identity sync (relive env reset relocation; no relocation here)
        "start_pos": rpos0.copy(),
        "sim_pos": rpos0.copy(),
        "rel_heading": np.array([1.0, 0.0, 0.0, 0.0]),
    }


# -- rewards ------------------------------------------------------------------

def _terms(cur, expert, ind, action, ws, b_diffw, vf_dim, dt):
    w = dict(_DEFAULTS, **(ws or {}))
    pose_diff = multi_quat_norm(multi_quat_diff(cur["bquat"], expert["bquat"][ind]))
    pose_diff = pose_diff.copy()
    pose_diff[1:] *= b_diffw
    pose_dist = np.linalg.norm(pose_diff)
    pose_reward = np.exp(-w["k_p"] * pose_dist ** 2)

    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)
    vel_dist = np.linalg.norm(cur_bangvel - expert["bangvel"][ind], ord=w["v_ord"])
    vel_reward = np.exp(-w["k_v"] * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_wpos"] - expert["ee_wpos"][ind])
    ee_reward = np.exp(-w["k_e"] * ee_dist ** 2)

    com_dist = np.linalg.norm(cur["com"] - expert["com"][ind])
    com_reward = np.exp(-w["k_c"] * com_dist ** 2)

    if w["w_vf"] > 0.0 and vf_dim > 0:
        vf = np.asarray(action)[-vf_dim:]
        vf_reward = np.exp(-w["k_vf"] * np.linalg.norm(vf) ** 2)
    else:
        vf_reward = 0.0
    return w, pose_reward, vel_reward, ee_reward, com_reward, vf_reward


def world_rfc_implicit_reward(cur, expert, ind, action, ws=None,
                              b_diffw=1.0, vf_dim=6, dt=1 / 30):
    """(:4-54).  cur: dict(bquat, prev_bquat, ee_wpos, com); expert: the
    expert_physics_attrs dict; ind: expert frame index."""
    w, rp, rv, re, rc, rvf = _terms(cur, expert, ind, action, ws, b_diffw, vf_dim, dt)
    total = (w["w_p"] * rp + w["w_v"] * rv + w["w_e"] * re
             + w["w_c"] * rc + w["w_vf"] * rvf)
    total /= w["w_p"] + w["w_v"] + w["w_e"] + w["w_c"] + w["w_vf"]
    return float(total), np.array([rp, rv, re, rc, rvf])


def world_rfc_implicit_v1_mul(cur, expert, ind, action, ws=None,
                              b_diffw=1.0, vf_dim=6, dt=1 / 30):
    """Multiplicative variant (:56-103): product of ALL exp terms — the
    residual-force term is unconditional here (:95-96).  Without a residual
    force (vf_dim == 0) the vf factor is exp(0) = 1, not a zeroing 0."""
    w = dict(_DEFAULTS, **(ws or {}))
    w["w_vf"] = 1.0  # force the vf term on (assignment, not a dup kwarg)
    _, rp, rv, re, rc, rvf = _terms(cur, expert, ind, action, w, b_diffw, vf_dim, dt)
    if vf_dim <= 0:
        rvf = 1.0
    total = rp * rv * re * rc * rvf
    return float(total), np.array([rp, rv, re, rc, rvf])


def world_rfc_explicit_reward(cur, expert, ind, action, ws=None, b_diffw=1.0,
                              vf_dim=6, body_vf_dim=6, dt=1 / 30,
                              cur_t=0, start_ind=0):
    """(:105-170).  Explicit residual force: the action tail carries
    per-vf-body (contact_point, force) blocks scored separately (w_vf/w_cp).
    Cyclic experts remap rpos/com/ee by the cycle heading (:130-139);
    non-cyclic experts past their end get zero target bangvel (:141-142)."""
    w = dict(_DEFAULTS, w_cp=0.0, k_cp=1.0)
    w.update(ws or {})
    n_vf_bodies = max(vf_dim // body_vf_dim, 0)

    e_ee = expert["ee_wpos"][ind].copy()
    e_com = expert["com"][ind].copy()
    e_bangvel = expert["bangvel"][ind]
    meta = expert.get("meta", {"cyclic": False})
    if meta["cyclic"]:
        e_rpos = expert["qpos"][ind][:3]
        init_pos = expert["init_pos"]
        cycle_h = expert["cycle_relheading"]
        cycle_pos = expert["cycle_pos"]
        orig_rpos = e_rpos.copy()
        e_rpos = quat_mul_vec(cycle_h, e_rpos - init_pos) + cycle_pos
        e_com = quat_mul_vec(cycle_h, e_com - orig_rpos) + e_rpos
        for i in range(e_ee.shape[0] // 3):
            e_ee[3 * i: 3 * i + 3] = (
                quat_mul_vec(cycle_h, e_ee[3 * i: 3 * i + 3] - orig_rpos) + e_rpos)
    if not meta["cyclic"] and start_ind + cur_t >= expert["len"]:
        e_bangvel = np.zeros_like(e_bangvel)

    pose_diff = multi_quat_norm(multi_quat_diff(cur["bquat"], expert["bquat"][ind])).copy()
    pose_diff[1:] *= b_diffw
    pose_reward = np.exp(-w["k_p"] * np.linalg.norm(pose_diff) ** 2)

    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)
    vel_dist = np.linalg.norm(cur_bangvel - e_bangvel, ord=w["v_ord"])
    vel_reward = np.exp(-w["k_v"] * vel_dist ** 2)

    ee_reward = np.exp(-w["k_e"] * np.linalg.norm(cur["ee_wpos"] - e_ee) ** 2)
    com_reward = np.exp(-w["k_c"] * np.linalg.norm(cur["com"] - e_com) ** 2)

    vf = np.asarray(action)[-vf_dim:]
    vf_loss = cp_loss = 0.0
    for i in range(n_vf_bodies):
        cp = vf[i * body_vf_dim: i * body_vf_dim + 3]
        force = vf[i * body_vf_dim + 3: (i + 1) * body_vf_dim]
        vf_loss += np.linalg.norm(force) ** 2
        cp_loss += np.linalg.norm(cp) ** 2
    vf_reward = np.exp(-w["k_vf"] * vf_loss)
    cp_reward = np.exp(-w["k_cp"] * cp_loss)

    total = (w["w_p"] * pose_reward + w["w_v"] * vel_reward
             + w["w_e"] * ee_reward + w["w_c"] * com_reward
             + w["w_vf"] * vf_reward + w["w_cp"] * cp_reward)
    total /= (w["w_p"] + w["w_v"] + w["w_e"] + w["w_c"]
              + w["w_vf"] + w["w_cp"])
    return float(total), np.array(
        [pose_reward, vel_reward, ee_reward, com_reward, vf_reward, cp_reward])


_LOCAL_DEFAULTS = dict(w_p=0.5, w_v=0.0, w_e=0.2, w_rp=0.1, w_rv=0.1, w_vf=0.1,
                       k_p=2.0, k_v=0.005, k_e=20.0, k_vf=1.0,
                       k_rh=300.0, k_rq=300.0, k_rl=5.0, k_ra=0.5, v_ord=2)


def _local_terms(cur, expert, ind, ws, b_diffw, dt, obs_coord):
    """Shared local_rfc_* terms (:172-299): root excluded from pose/vel,
    heading-local root velocities, de-headed root quat."""
    w = ws
    cur_qvel = get_qvel_fd_new(cur["prev_qpos"], cur["qpos"], dt, obs_coord)
    cur_rq_rmh = de_heading(cur["qpos"][3:7])

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"][4:], expert["bquat"][ind][4:])).copy()
    pose_diff *= b_diffw
    pose_reward = np.exp(-w["k_p"] * np.linalg.norm(pose_diff) ** 2)

    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)
    vel_dist = np.linalg.norm(
        cur_bangvel[3:] - expert["bangvel"][ind][3:], ord=w["v_ord"])
    vel_reward = np.exp(-w["k_v"] * vel_dist ** 2)

    ee_dist = np.linalg.norm(cur["ee_pos"] - expert["ee_pos"][ind])
    ee_reward = np.exp(-w["k_e"] * ee_dist ** 2)

    root_height_dist = cur["qpos"][2] - expert["qpos"][ind][2]
    root_quat_dist = multi_quat_norm(
        multi_quat_diff(cur_rq_rmh, expert["rq_rmh"][ind]))[0]
    root_pose_reward = np.exp(-w["k_rh"] * root_height_dist ** 2
                              - w["k_rq"] * root_quat_dist ** 2)

    root_linv_dist = np.linalg.norm(cur_qvel[:3] - expert["rlinv_local"][ind])
    root_angv_dist = np.linalg.norm(cur_qvel[3:6] - expert["rangv"][ind])
    root_vel_reward = np.exp(-w["k_rl"] * root_linv_dist ** 2
                             - w["k_ra"] * root_angv_dist ** 2)
    return pose_reward, vel_reward, ee_reward, root_pose_reward, root_vel_reward


def local_rfc_implicit_reward(cur, expert, ind, action, ws=None, b_diffw=1.0,
                              vf_dim=6, dt=1 / 30, obs_coord="heading"):
    """(:172-232).  cur: dict(qpos, prev_qpos, bquat, prev_bquat,
    ee_pos [obs_coord frame])."""
    w = dict(_LOCAL_DEFAULTS, **(ws or {}))
    rp, rv, re, rrp, rrv = _local_terms(cur, expert, ind, w, b_diffw, dt, obs_coord)
    if w["w_vf"] > 0.0:
        vf = np.asarray(action)[-vf_dim:]
        rvf = np.exp(-w["k_vf"] * np.linalg.norm(vf) ** 2)
    else:
        rvf = 0.0
    total = (w["w_p"] * rp + w["w_v"] * rv + w["w_e"] * re
             + w["w_rp"] * rrp + w["w_rv"] * rrv + w["w_vf"] * rvf)
    total /= w["w_p"] + w["w_v"] + w["w_e"] + w["w_rp"] + w["w_rv"] + w["w_vf"]
    return float(total), np.array([rp, rv, re, rrp, rrv, rvf])


def local_rfc_explicit_reward(cur, expert, ind, action, ws=None, b_diffw=1.0,
                              vf_dim=6, body_vf_dim=6, dt=1 / 30,
                              obs_coord="heading"):
    """(:234-299).  Local terms + split contact-point/force residual."""
    w = dict(_LOCAL_DEFAULTS, w_p=0.4, w_vf=0.1, w_cp=0.1,
             k_vf=20.0, k_cp=10.0)
    w.update(ws or {})
    rp, rv, re, rrp, rrv = _local_terms(cur, expert, ind, w, b_diffw, dt, obs_coord)
    n_vf_bodies = max(vf_dim // body_vf_dim, 0)
    vf = np.asarray(action)[-vf_dim:]
    vf_loss = cp_loss = 0.0
    for i in range(n_vf_bodies):
        cp = vf[i * body_vf_dim: i * body_vf_dim + 3]
        force = vf[i * body_vf_dim + 3: (i + 1) * body_vf_dim]
        vf_loss += np.linalg.norm(force) ** 2
        cp_loss += np.linalg.norm(cp) ** 2
    rvf = np.exp(-w["k_vf"] * vf_loss)
    rcp = np.exp(-w["k_cp"] * cp_loss)
    total = (w["w_p"] * rp + w["w_v"] * rv + w["w_e"] * re
             + w["w_rp"] * rrp + w["w_rv"] * rrv
             + w["w_vf"] * rvf + w["w_cp"] * rcp)
    total /= (w["w_p"] + w["w_v"] + w["w_e"] + w["w_rp"] + w["w_rv"]
              + w["w_vf"] + w["w_cp"])
    return float(total), np.array([rp, rv, re, rrp, rrv, rvf, rcp])


_V2_DEFAULTS = dict(k_p=0.4, k_wp=0.4, k_v=0.005, k_j=100.0, k_c=100.0, k_vf=1.0)


def _v23_terms(cur, expert, ind, action, ws, vf_dim, dt):
    """Shared world_rfc_implicit_v2/v3 terms (:301-452): mean-squared
    distances over local quats, world quats, body coms, world joint
    positions, bangvel — all weighted per joint by jpos_diffw."""
    w = dict(_V2_DEFAULTS, **(ws or {}))
    jw = np.asarray(w.get("jpos_diffw", [1.0] * 24), np.float64)

    pose_diff = multi_quat_norm(
        multi_quat_diff(cur["bquat"], expert["bquat"][ind])).copy()
    pose_diff *= jw
    pose_reward = np.exp(-w["k_p"] * (pose_diff ** 2).mean())

    wpose_diff = multi_quat_norm(
        multi_quat_diff(cur["wbquat"], expert["wbquat"][ind])).copy()
    wpose_diff *= jw
    wpose_reward = np.exp(-w["k_wp"] * (wpose_diff ** 2).mean())

    cur_bangvel = get_angvel_fd(cur["prev_bquat"], cur["bquat"], dt)
    vel_reward = np.exp(
        -w["k_v"] * ((cur_bangvel - expert["bangvel"][ind]) ** 2).mean())

    dcom = (expert["body_com"][ind].reshape(-1, 3)
            - cur["body_com"].reshape(-1, 3)) * jw[:, None]
    com_reward = np.exp(
        -w["k_c"] * (np.linalg.norm(dcom, axis=1) ** 2).mean())

    dj = (cur["wbpos"].reshape(-1, 3)
          - expert["wbpos"][ind].reshape(-1, 3)) * jw[:, None]
    jpos_reward = np.exp(
        -w["k_j"] * (np.linalg.norm(dj, axis=1) ** 2).mean())

    vf = np.asarray(action)[-vf_dim:]
    vf_reward = np.exp(-w["k_vf"] * np.linalg.norm(vf) ** 2)
    return w, pose_reward, wpose_reward, com_reward, jpos_reward, vel_reward, vf_reward


def world_rfc_implicit_v2(cur, expert, ind, action, ws=None, vf_dim=6, dt=1 / 30):
    """(:301-375) — multiplicative combination."""
    _, rp, rwp, rc, rj, rv, rvf = _v23_terms(cur, expert, ind, action, ws, vf_dim, dt)
    total = rp * rwp * rc * rj * rv * rvf
    return float(total), np.array([rp, rwp, rc, rj, rv, rvf])


def world_rfc_implicit_v3(cur, expert, ind, action, ws=None, vf_dim=6, dt=1 / 30):
    """(:376-452) — weighted sum (NOT normalized by the weight total)."""
    w, rp, rwp, rc, rj, rv, rvf = _v23_terms(cur, expert, ind, action, ws, vf_dim, dt)
    w_p, w_wp = w.get("w_p", 0.4), w.get("w_wp", 0.4)
    w_v, w_j = w.get("w_v", 0.005), w.get("w_j", 100.0)
    w_c, w_vf = w.get("w_c", 100.0), w.get("w_vf", 1.0)
    total = (w_p * rp + w_wp * rwp + w_c * rc + w_j * rj
             + w_v * rv + w_vf * rvf)
    return float(total), np.array([rp, rwp, rc, rj, rv, rvf])


UHC_REWARD_FUNCS = {
    "world_rfc_implicit": world_rfc_implicit_reward,
    "world_rfc_implicit_v1_mul": world_rfc_implicit_v1_mul,
    "world_rfc_explicit": world_rfc_explicit_reward,
    "local_rfc_implicit": local_rfc_implicit_reward,
    "local_rfc_explicit": local_rfc_explicit_reward,
    "world_rfc_implicit_v2": world_rfc_implicit_v2,
    "world_rfc_implicit_v3": world_rfc_implicit_v3,
}
