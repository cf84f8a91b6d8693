"""Simulator-grounded physics metrics (penetration / sliding / success);
host numpy and MuJoCo, copied from egoego_release_tpu/eval/physics_metrics.py.

Port of the UHC/copycat physics evaluation in
kinpoly/scripts/eval_amass_metrics.py: `compute_physcis_metris` (:218-306)
replays a qpos trajectory through MuJoCo forward kinematics and inspects the
contact buffer for body penetration, and `compute_obj_interact` (:350-480)
scores per-action task success from the contact history.  Host-side on
MuJoCo 3 via the port's rl/mujoco_env.MujocoHumanoidEnv (the reference used
mujoco-py).

Deviation (documented): the reference filters contacts by HARDCODED geom
indices tied to its specific XML ordering (body geoms 1..24, chair [25,26],
step [34] — :246,:357,:391); here geom groups are resolved from body NAMES
on the loaded model, so any humanoid variant/object layout works.  The
success criteria keep the reference's structure: sit = contiguous contact
between the chair and pelvis/hip/knee bodies; avoid = no step contact AND
final head drift <= 0.5 m; push = box displaced > 0.1 m; step = contiguous
step contact by the feet AND pelvis raised > 0.1 m; None/amass = True;
`fail_safe` in the result record vetoes success (:466-476).
"""

from __future__ import annotations

import numpy as np

from egoego_release_tpu_torch.eval.qpos_metrics import qpos_foot_sliding

PEN_MARGIN = 0.005          # eval_amass_metrics.py:238
HEAD_DRIFT_LIMIT = 0.5      # :415
PUSH_DISP_THRESHOLD = 0.1   # :427
STEP_RISE_THRESHOLD = 0.1   # :454

SIT_CONTACT_BODIES = ("Pelvis", "L_Hip", "R_Hip", "L_Knee", "R_Knee")
STEP_CONTACT_BODIES = ("L_Knee", "L_Ankle", "R_Knee", "R_Ankle")
FOOT_BODIES = ("L_Toe", "R_Toe")

# the *_all MJCF's object-slot layout (humanoid_ar_v1.py:41-43,
# eval_amass_metrics.py:629-631): sit=chair(7), push=table+box(14),
# avoid=can(7), step=step(7); total object qpos = 35
ACTION_INDEX_MAP = (0, 7, 21, 28)
ACTION_LEN = (7, 14, 7, 7)
ACTION_NAMES = ("sit", "push", "avoid", "step")
_PARKED_OBJ_XY = 100.0


def convert_obj_qpos(action_one_hot: np.ndarray,
                     obj_pose: np.ndarray) -> np.ndarray:
    """Build the 35-dim object qpos for the `*_all` model from one action's
    object pose (eval_amass_metrics.py:99-117): inactive object slots are
    parked far away at ((i+1)*100, 100, 0)."""
    out = np.zeros(35)
    for i in range(5):
        out[i * 7: i * 7 + 3] = [(i + 1) * _PARKED_OBJ_XY, _PARKED_OBJ_XY, 0]
    if np.sum(action_one_hot) == 0:
        return out
    action_idx = int(np.nonzero(action_one_hot)[0][0])
    start = ACTION_INDEX_MAP[action_idx]
    out[start: start + ACTION_LEN[action_idx]] = obj_pose
    return out


def contiguous_regions(condition: np.ndarray) -> np.ndarray:
    """(start, stop) rows for each contiguous True run (:324-348)."""
    condition = np.asarray(condition, bool)
    if condition.size == 0:
        return np.zeros((0, 2), int)
    d = np.diff(condition)
    (idx,) = d.nonzero()
    idx = idx + 1
    if condition[0]:
        idx = np.r_[0, idx]
    if condition[-1]:
        idx = np.r_[idx, condition.size]
    return idx.reshape(-1, 2)


def _geom_ids_for_bodies(env, body_names) -> set[int]:
    """All geom ids attached to the named bodies."""
    ids = set()
    model = env.model
    for gid in range(model.ngeom):
        bid = int(model.geom_bodyid[gid])
        name = env._mj.mj_id2name(env.model, env._mj.mjtObj.mjOBJ_BODY, bid)
        if name in body_names:
            ids.add(gid)
    return ids


def humanoid_body_names(env) -> set[str]:
    """Bodies in the Pelvis kinematic subtree — object bodies (chair/step/
    box) hang off the world separately, so this reproduces the reference's
    'body geoms 1..24' (:246) on object-bearing models too."""
    import mujoco

    model = env.model
    names = {}
    for bid in range(model.nbody):
        names[bid] = env._mj.mj_id2name(model, mujoco.mjtObj.mjOBJ_BODY, bid)
    root = next((bid for bid, n in names.items() if n == "Pelvis"), None)
    if root is None:
        return set(env.body_names)  # humanoid-only model, any naming
    out = set()
    for bid in range(model.nbody):
        b = bid
        while b != 0 and b != root:
            b = int(model.body_parentid[b])
        if b == root:
            out.add(names[bid])
    return out


def humanoid_geom_ids(env) -> set[int]:
    """Geoms of every humanoid body (the reference's range(1, 25), :246)."""
    return _geom_ids_for_bodies(env, humanoid_body_names(env))


def frame_penetrations(env, body_geoms: set[int], margin: float = PEN_MARGIN):
    """One-sided body contacts of the CURRENT mj state:
    [(geom1, geom2, depth_beyond_margin, raw_depth)] — self-collisions and
    non-body contacts skipped (:249-263)."""
    out = []
    data = env.data
    for ci in range(data.ncon):
        c = data.contact[ci]
        g1, g2 = int(c.geom[0]), int(c.geom[1])
        in1, in2 = g1 in body_geoms, g2 in body_geoms
        if not (in1 or in2):
            continue
        if in1 and in2:
            continue  # self collision (reference prints + skips)
        pen = max(0.0, -float(c.dist) - margin)
        out.append((g1, g2, pen, -float(c.dist)))
    return out


def compute_physics_metrics(
    env,
    qpos_seq: np.ndarray,           # (T, nq_humanoid)
    obj_pose: np.ndarray | None = None,  # (T, nq_obj) appended to qpos
    margin: float = PEN_MARGIN,
) -> dict:
    """Replay the trajectory through mj_forward and accumulate the physics
    metric suite (:218-306): per-sequence penetration (mm), foot sliding
    (mm, via the z-gated displacement weighting), world joint positions,
    head poses, and the raw per-frame contact records for success scoring."""
    body_geoms = humanoid_geom_ids(env)
    nq_h = qpos_seq.shape[1]
    seq_len = len(qpos_seq)

    lfoot, rfoot, joint_pos, head_pose, seq_pen, pen_seq_info = [], [], [], [], [], []
    li = env.body_names.index(FOOT_BODIES[0]) + 1
    ri = env.body_names.index(FOOT_BODIES[1]) + 1

    env._mj.mj_resetData(env.model, env.data)
    for fr in range(seq_len):
        env.data.qpos[:nq_h] = qpos_seq[fr]
        if obj_pose is not None:
            env.data.qpos[nq_h:nq_h + obj_pose.shape[1]] = obj_pose[fr]
        # kinematics + collision only (the reference calls sim.forward, :237,
        # but its constraint-solver stages are unused here and can fatally
        # fail on degenerate predicted qpos — skip them)
        env._mj.mj_kinematics(env.model, env.data)
        env._mj.mj_collision(env.model, env.data)

        contacts = frame_penetrations(env, body_geoms, margin)
        total_pen = sum(c[2] for c in contacts)
        if contacts and total_pen > 0:
            seq_pen.append(total_pen)
        pen_seq_info.append(contacts)

        lfoot.append(env.data.xpos[li].copy())
        rfoot.append(env.data.xpos[ri].copy())
        head_pose.append(env.get_head_pose())
        joint_pos.append(env.get_wbody_pos())

    sliding = 0.5 * (
        qpos_foot_sliding(np.asarray(lfoot), qpos_seq)
        + qpos_foot_sliding(np.asarray(rfoot), qpos_seq)
    )
    pen = float(np.sum(seq_pen) / seq_len * 1000.0) if seq_pen else 0.0
    return {
        "pen": pen,
        "sliding": sliding,
        "joint_pos": np.asarray(joint_pos),
        "head_pose": np.asarray(head_pose),
        "pen_seq_info": pen_seq_info,
    }


def _hit_frames(pen_seq_info, obj_geoms: set[int], body_geoms: set[int]) -> np.ndarray:
    """Per-frame flag: any contact pairing an obj geom with a body geom."""
    hits = []
    for contacts in pen_seq_info:
        hit = False
        for g1, g2, _pen, _raw in contacts:
            obj_side = g1 in obj_geoms or g2 in obj_geoms
            body_side = g1 in body_geoms or g2 in body_geoms
            if obj_side and body_side:
                hit = True
        hits.append(hit)
    return np.asarray(hits, bool)


def interaction_success(
    action: str,
    pen_seq_info,
    traj: np.ndarray,
    head_pose: np.ndarray,
    head_pose_gt: np.ndarray | None = None,
    obj_pose: np.ndarray | None = None,
    env=None,
    obj_body_names: tuple[str, ...] = (),
    fail_safe: bool | None = None,
) -> bool:
    """compute_obj_interact (:350-480) with name-resolved geom groups.

    Object-action branches need their inputs: sit/avoid/step require `env`
    plus `obj_body_names` that resolve to geoms on the loaded model, push
    requires `obj_pose` — a clear ValueError beats a silently-constant
    score when they are missing."""
    succ = False
    obj_geoms = _geom_ids_for_bodies(env, set(obj_body_names)) if env is not None else set()
    if action in ("sit", "avoid", "step") and not obj_geoms:
        raise ValueError(
            f"action {action!r} needs obj_body_names resolving to geoms on "
            f"the model (got {obj_body_names!r}); load an object-bearing XML"
        )
    if action == "push" and obj_pose is None:
        raise ValueError("action 'push' needs obj_pose (T, >=10)")

    if action == "sit":
        body_geoms = _geom_ids_for_bodies(env, set(SIT_CONTACT_BODIES))
        hits = _hit_frames(pen_seq_info, obj_geoms, body_geoms)
        succ = len(contiguous_regions(hits)) > 0
    elif action == "avoid":
        body_geoms = humanoid_geom_ids(env)
        hits = _hit_frames(pen_seq_info, obj_geoms, body_geoms)
        drift = float(np.linalg.norm(head_pose[-1, :3] - head_pose_gt[-1, :3]))
        succ = len(contiguous_regions(hits)) == 0 and drift <= HEAD_DRIFT_LIMIT
    elif action == "push":
        box_pos = obj_pose[:, 7:10]
        disp = float(np.max(np.linalg.norm(box_pos[0] - box_pos, axis=1)))
        succ = disp > PUSH_DISP_THRESHOLD
    elif action == "step":
        body_geoms = _geom_ids_for_bodies(env, set(STEP_CONTACT_BODIES))
        hits = _hit_frames(pen_seq_info, obj_geoms, body_geoms)
        pelvis_rise = traj[:, 2] - traj[0, 2]
        succ = (
            len(contiguous_regions(hits)) > 0
            and len(contiguous_regions(pelvis_rise > STEP_RISE_THRESHOLD)) > 0
        )
    else:  # "None" / plain mocap
        succ = True

    if fail_safe is not None:
        succ = succ and not fail_safe
    return succ
