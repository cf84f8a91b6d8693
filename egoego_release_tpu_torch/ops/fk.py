"""SMPL 22-joint forward / inverse kinematics on torch tensors (port of
egoego_release_tpu/ops/fk.py): joints at the same tree depth update
together, so FK is 8 batched steps instead of 21. ``fk_from_local_quat``
takes any kinematic tree (the MuJoCo humanoid's too, ``ops/mujoco_xml.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from egoego_release_tpu_torch.ops import rotations as rot

SMPL_PARENTS = np.asarray(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19],
    dtype=np.int64,
)
NUM_JOINTS = 22
HEAD_IDX = 15
ROOT_IDX = 0


@functools.cache
def _tree_levels(parents: tuple[int, ...]):
    parents = np.asarray(parents, dtype=np.int64)
    depth = np.zeros(len(parents), dtype=np.int64)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    return [(np.nonzero(depth == d)[0], parents[depth == d]) for d in range(1, depth.max() + 1)]


def _levels(parents) -> list[tuple[np.ndarray, np.ndarray]]:
    """(joints, their parents) at each depth of the tree below the root,
    shallowest first; computed once per tree."""
    return _tree_levels(tuple(np.asarray(parents).tolist()))


def fk_from_local_quat(local_quat: torch.Tensor, local_offsets: torch.Tensor,
                       root_trans: torch.Tensor | None = None, parents=SMPL_PARENTS):
    """local_quat (..., J, 4), local_offsets (J, 3) or (..., J, 3),
    optional root_trans (..., 3), over the tree ``parents`` (J,)
    (parents[0] = -1; SMPL's 22 joints by default). Returns (global_quat,
    global_jpos)."""
    local_offsets = local_offsets.expand(local_quat.shape[:-1] + (3,))
    gq = local_quat.clone()
    gp = local_offsets.clone()
    for js, ps in _levels(parents):
        js_t = torch.as_tensor(js, device=gq.device)
        ps_t = torch.as_tensor(ps, device=gq.device)
        parent_q = gq[..., ps_t, :]
        gp[..., js_t, :] = rot.quat_apply(parent_q, local_offsets[..., js_t, :]) + gp[..., ps_t, :]
        gq[..., js_t, :] = rot.quat_multiply(parent_q, local_quat[..., js_t, :])
    if root_trans is not None:
        gp = gp + root_trans[..., None, :]
    return gq, gp


def ik_to_local_quat(global_quat: torch.Tensor) -> torch.Tensor:
    """Global joint rotations -> rotations relative to the parent."""
    parents = torch.as_tensor(SMPL_PARENTS[1:], device=global_quat.device)
    child_local = rot.quat_multiply(rot.quat_invert(global_quat[..., parents, :]),
                                    global_quat[..., 1:, :])
    return torch.cat([global_quat[..., :1, :], child_local], dim=-2)


def local_to_global_matrix(local_mat: torch.Tensor) -> torch.Tensor:
    """Local rotation matrices (..., 22, 3, 3) -> global, one tree level at
    a time (each joint's parent is final before the joint's level runs)."""
    g = local_mat.clone()
    for js, ps in _levels(SMPL_PARENTS):
        js_t = torch.as_tensor(js, device=g.device)
        ps_t = torch.as_tensor(ps, device=g.device)
        g[..., js_t, :, :] = torch.matmul(g[..., ps_t, :, :], local_mat[..., js_t, :, :])
    return g


def fk_smpl(root_trans: torch.Tensor, local_aa: torch.Tensor, rest_offsets: torch.Tensor):
    """root_trans (..., 3), local_aa (..., 22, 3), rest_offsets (22, 3) ->
    (global_quat (..., 22, 4), global_jpos (..., 22, 3))."""
    local_quat = rot.matrix_to_quat(rot.axis_angle_to_matrix(local_aa))
    return fk_from_local_quat(local_quat, rest_offsets, root_trans)
