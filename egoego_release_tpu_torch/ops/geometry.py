"""Geometry helpers (port of egoego_release_tpu/ops/geometry.py): vectors
in a body's heading or root frame, the head's local velocities, an
object's pose relative to the head, the MuJoCo qpos <-> SMPL codec of the
kinpoly records, and host-side floor-height estimation (numpy copy):
static toe frames, 1-D DBSCAN over their heights (eps 0.005, min_samples
3, noise participating as a cluster), floor = the lowest cluster median
minus an offset."""

from __future__ import annotations

import numpy as np
import torch

from egoego_release_tpu_torch.ops import heading as heading_mod
from egoego_release_tpu_torch.ops import rotations as rot

# MuJoCo body order -> SMPL joint order (24 joints)
MUJOCO2SMPL_JOINT_IDX = np.asarray(
    [0, 1, 5, 9, 2, 6, 10, 3, 7, 11, 4, 8, 12, 14, 19, 13, 15, 20, 16, 21, 17, 22, 18, 23]
)


def transform_vec(v: torch.Tensor, q: torch.Tensor, mode: str = "heading") -> torch.Tensor:
    """v (..., 3) in the frame of wxyz q (..., 4): its heading alone
    (``mode="heading"``) or the whole rotation (``"root"``) (JAX
    ``ops/geometry.py:49``)."""
    if mode == "heading":
        frame_q = heading_mod.get_heading_quat(q)
    elif mode == "root":
        frame_q = q
    else:
        raise ValueError(mode)
    return rot.quat_apply(rot.quat_invert(frame_q), v)


def get_head_vel(head_pose: torch.Tensor, dt: float = 1.0 / 30.0) -> torch.Tensor:
    """Finite-difference head velocity (T, 7) -> (T, 6): the linear part in
    the heading frame, the angular part (rotation vector of the
    standardized relative quaternion, over dt) in the root frame, the last
    frame repeated (JAX ``ops/geometry.py:65``)."""
    trans, quat = head_pose[:, :3], head_pose[:, 3:7]
    v_local = transform_vec((trans[1:] - trans[:-1]) / dt, quat[:-1], "heading")
    qrel = rot.quat_multiply(quat[1:], rot.quat_invert(quat[:-1]))
    rv_local = transform_vec(rot.quat_to_axis_angle(rot.standardize_quat(qrel)) / dt, quat[:-1], "root")
    vels = torch.cat([v_local, rv_local], dim=-1)
    return torch.cat([vels, vels[-1:]], dim=0)


def get_obj_relative_pose(obj_poses: torch.Tensor, ref_poses: torch.Tensor, num_objs: int = 1) -> torch.Tensor:
    """Object poses (T, num_objs * 7) relative to a reference pose (T, 7),
    in the reference's heading frame (JAX ``ops/geometry.py:87``)."""
    ref_pos, ref_rot = ref_poses[:, :3], ref_poses[:, 3:7]
    q_heading_inv = rot.quat_invert(heading_mod.get_heading_quat(ref_rot))
    outs = []
    for o in range(num_objs):
        obj = obj_poses[:, o * 7: o * 7 + 7]
        outs += [transform_vec(obj[:, :3] - ref_pos, ref_rot, "heading"), rot.quat_multiply(q_heading_inv, obj[:, 3:])]
    return torch.cat(outs, dim=-1)


def euler_zyx_to_matrix(eulers: torch.Tensor) -> torch.Tensor:
    """Intrinsic Z-Y-X Euler angles (..., 3) -> R = Rz(a) Ry(b) Rx(c)
    (..., 3, 3), the hinge order of the MuJoCo humanoid's joints (JAX
    ``ops/geometry.py:119-132``, ``ops/mujoco_xml.py:104-115``)."""
    a, b, c = eulers[..., 0], eulers[..., 1], eulers[..., 2]
    ca, sa, cb, sb, cc, sc = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b), torch.cos(c), torch.sin(c)
    return torch.stack([
        ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc,
        sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc,
        -sb, cb * sc, cb * cc,
    ], dim=-1).reshape(eulers.shape[:-1] + (3, 3))


def qpos_to_smpl(qpos: torch.Tensor):
    """MuJoCo qpos (T, 76) = [trans (3), root quat wxyz (4), 23 joints x
    intrinsic ZYX euler (69)] -> (trans (T, 3), pose axis-angle (T, 24, 3))
    in SMPL joint order (JAX ``ops/geometry.py:109``)."""
    root_aa = rot.quat_to_axis_angle(qpos[:, 3:7])
    m = euler_zyx_to_matrix(qpos[:, 7:].reshape(-1, 23, 3))
    aa = torch.cat([root_aa[:, None, :], rot.matrix_to_axis_angle(m)], dim=1)
    return qpos[:, :3], aa[:, torch.as_tensor(MUJOCO2SMPL_JOINT_IDX, device=qpos.device)]


def smpl_to_qpos(trans: torch.Tensor, pose_aa: torch.Tensor) -> torch.Tensor:
    """The inverse codec: SMPL trans (T, 3) and 24-joint axis-angle
    (T, 24, 3) -> qpos (T, 76) (JAX ``ops/geometry.py:138``)."""
    aa_mj = pose_aa[:, torch.as_tensor(np.argsort(MUJOCO2SMPL_JOINT_IDX), device=pose_aa.device)]
    m = rot.axis_angle_to_matrix(aa_mj[:, 1:])
    b = -torch.arcsin(m[..., 2, 0].clamp(-1.0, 1.0))
    a = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    c = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    eulers = torch.stack([a, b, c], dim=-1).reshape(trans.shape[0], -1)
    return torch.cat([trans, rot.axis_angle_to_quat(aa_mj[:, 0]), eulers], dim=-1)


FLOOR_VEL_THRESH = 0.005
FLOOR_HEIGHT_OFFSET = 0.01
TERRAIN_HEIGHT_THRESH = 0.04
ROOT_HEIGHT_THRESH = 0.04
CLUSTER_SIZE_THRESH = 0.25
CONTACT_VEL_THRESH = 0.005
CONTACT_TOE_HEIGHT_THRESH = 0.04
CONTACT_ANKLE_HEIGHT_THRESH = 0.08


def _dbscan_1d(x: np.ndarray, eps: float = 0.005, min_samples: int = 3) -> np.ndarray:
    """DBSCAN labels (-1 = noise) for 1-D points by sort and split: core
    points have >= min_samples points within eps, consecutive cores within
    eps share a cluster, border points join their nearest core's."""
    order = np.argsort(x)
    xs = x[order]
    labels = np.full(x.shape[0], -1, dtype=np.int64)
    counts = np.asarray([(np.abs(xs - xi) <= eps).sum() for xi in xs])
    core = counts >= min_samples
    prev_core_x = None
    cur = -1
    for i in range(len(xs)):
        if not core[i]:
            continue
        if prev_core_x is None or xs[i] - prev_core_x > eps:
            cur += 1
        labels[order[i]] = cur
        prev_core_x = xs[i]
    for i in range(len(xs)):
        if core[i] or labels[order[i]] != -1:
            continue
        d = np.abs(xs - xs[i])
        cand = np.where(core & (d <= eps))[0]
        if cand.size:
            labels[order[i]] = labels[order[cand[np.argmin(d[cand])]]]
    return labels


def determine_floor_height_and_contacts(body_joint_seq: np.ndarray, fps: int = 30,
                                        discard_terrain_sequences: bool = True):
    """body_joint_seq (T, >=22, 3) numpy -> (offset_floor_height, contacts
    (T, 22), discard_seq)."""
    J = {"hips": 0, "leftLeg": 4, "rightLeg": 5, "leftFoot": 7, "rightFoot": 8,
         "leftToeBase": 10, "rightToeBase": 11, "leftHand": 20, "rightHand": 21}
    num_frames = body_joint_seq.shape[0]

    def vel(seq):
        v = np.linalg.norm(seq[1:] - seq[:-1], axis=1)
        return np.append(v, v[-1])

    left_toe = body_joint_seq[:, J["leftToeBase"]]
    right_toe = body_joint_seq[:, J["rightToeBase"]]
    left_static = vel(left_toe) < FLOOR_VEL_THRESH
    right_static = vel(right_toe) < FLOOR_VEL_THRESH
    root_heights = body_joint_seq[:, J["hips"], 2]
    all_inds = np.arange(num_frames)
    static_heights = np.concatenate([left_toe[:, 2][left_static], right_toe[:, 2][right_static]])
    static_inds = np.concatenate([all_inds[left_static], all_inds[right_static]])

    discard_seq = False
    if static_heights.shape[0] > 0:
        labels = _dbscan_1d(static_heights, eps=0.005, min_samples=3)
        clusters = []
        min_median = min_root_median = float("inf")
        for label in np.unique(labels):
            in_cluster = labels == label
            toe_median = float(np.median(static_heights[in_cluster]))
            root_median = float(np.median(root_heights[np.unique(static_inds[in_cluster])]))
            clusters.append((toe_median, root_median, int(in_cluster.sum())))
            if toe_median < min_median:
                min_median, min_root_median = toe_median, root_median
        floor_height = min_median
        offset_floor_height = floor_height - FLOOR_HEIGHT_OFFSET
        if discard_terrain_sequences:
            discard_seq = any(
                root_median > min_root_median + ROOT_HEIGHT_THRESH
                and toe_median > min_median + TERRAIN_HEIGHT_THRESH
                and size > int(CLUSTER_SIZE_THRESH * fps)
                for toe_median, root_median, size in clusters)
    else:
        floor_height = offset_floor_height = 0.0

    def contact(joint, thresh):
        seq = body_joint_seq[:, J[joint]]
        return (vel(seq) < CONTACT_VEL_THRESH) & (seq[:, 2] - floor_height < thresh)

    contacts = np.zeros((num_frames, 22))
    for joint, thresh in (("leftFoot", CONTACT_ANKLE_HEIGHT_THRESH),
                          ("rightFoot", CONTACT_ANKLE_HEIGHT_THRESH),
                          ("leftToeBase", CONTACT_TOE_HEIGHT_THRESH),
                          ("rightToeBase", CONTACT_TOE_HEIGHT_THRESH),
                          ("leftHand", CONTACT_ANKLE_HEIGHT_THRESH),
                          ("rightHand", CONTACT_ANKLE_HEIGHT_THRESH),
                          ("leftLeg", CONTACT_ANKLE_HEIGHT_THRESH),
                          ("rightLeg", CONTACT_ANKLE_HEIGHT_THRESH)):
        contacts[:, J[joint]] = contact(joint, thresh)
    return offset_floor_height, contacts, discard_seq
