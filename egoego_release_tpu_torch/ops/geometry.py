"""Geometry helpers (port of parts of egoego_release_tpu/ops/geometry.py):
the MuJoCo qpos -> SMPL codec of the kinpoly GT records, and host-side
floor-height estimation (numpy copy): static toe frames, 1-D DBSCAN over
their heights (eps 0.005, min_samples 3, noise participating as a
cluster), floor = the lowest cluster median minus an offset."""

from __future__ import annotations

import numpy as np
import torch

from egoego_release_tpu_torch.ops import rotations as rot

# MuJoCo body order -> SMPL joint order (24 joints)
MUJOCO2SMPL_JOINT_IDX = np.asarray(
    [0, 1, 5, 9, 2, 6, 10, 3, 7, 11, 4, 8, 12, 14, 19, 13, 15, 20, 16, 21, 17, 22, 18, 23]
)


def qpos_to_smpl(qpos: torch.Tensor):
    """MuJoCo qpos (T, 76) = [trans (3), root quat wxyz (4), 23 joints x
    intrinsic ZYX euler (69)] -> (trans (T, 3), pose axis-angle (T, 24, 3))
    in SMPL joint order."""
    trans = qpos[:, :3]
    root_aa = rot.quat_to_axis_angle(qpos[:, 3:7])
    eulers = qpos[:, 7:].reshape(-1, 23, 3)
    a, b, c = eulers[..., 0], eulers[..., 1], eulers[..., 2]
    ca, sa, cb, sb, cc, sc = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b), torch.cos(c), torch.sin(c)
    m = torch.stack([
        ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc,
        sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc,
        -sb, cb * sc, cb * cc,
    ], dim=-1).reshape(eulers.shape[:-1] + (3, 3))
    aa = torch.cat([root_aa[:, None, :], rot.matrix_to_axis_angle(m)], dim=1)
    return trans, aa[:, torch.as_tensor(MUJOCO2SMPL_JOINT_IDX, device=qpos.device)]


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
