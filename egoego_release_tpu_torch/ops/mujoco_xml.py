"""MuJoCo humanoid XML -> kinematic skeleton, and FK of qpos through it, on
torch tensors (port of egoego_release_tpu/ops/mujoco_xml.py; no simulator).

The body tree of the model XML (kinpoly's humanoid_smpl_neutral_mesh.xml:
24 bodies, Pelvis first) gives the parents and the rest offsets: each
body's ``pos`` is its world-frame rest position, so its offset is that
minus its parent's. Each non-root body carries three hinges in z, y, x
order, which matches the qpos layout [trans (3), root quat wxyz (4),
23 x ZYX euler].
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from egoego_release_tpu_torch.ops import rotations as rot
from egoego_release_tpu_torch.ops.fk import fk_from_local_quat
from egoego_release_tpu_torch.ops.geometry import euler_zyx_to_matrix


class MujocoSkeleton(NamedTuple):
    """JAX ``ops/mujoco_xml.py:30``."""

    body_names: tuple[str, ...]
    parents: np.ndarray       # (J,) int, parents[0] = -1
    offsets: torch.Tensor     # (J, 3) rest bone offsets (root = 0)
    rest_pos: torch.Tensor    # (J, 3) world-frame rest positions

    @property
    def head_idx(self) -> int:
        return self.body_names.index("Head")


def load_mujoco_skeleton(xml_path: str, device="cpu") -> MujocoSkeleton:
    """Parse the body tree depth first, as MuJoCo numbers the bodies (JAX
    ``ops/mujoco_xml.py:41``). The offsets live on ``device``."""
    root_body = ET.parse(xml_path).getroot().find("worldbody").find("body")
    names, parents, pos = [], [], []

    def walk(body, parent_idx):
        idx = len(names)
        names.append(body.attrib["name"])
        parents.append(parent_idx)
        pos.append(np.array(body.attrib["pos"].split(), dtype=np.float64))
        for child in body.findall("body"):
            walk(child, idx)

    walk(root_body, -1)
    rest_pos = np.stack(pos).astype(np.float32)
    parents = np.asarray(parents, dtype=np.int32)
    offsets = rest_pos.copy()
    offsets[1:] = rest_pos[1:] - rest_pos[parents[1:]]
    offsets[0] = 0.0
    return MujocoSkeleton(tuple(names), parents, torch.as_tensor(offsets, device=device),
                          torch.as_tensor(rest_pos, device=device))


def qpos_fk(skeleton: MujocoSkeleton, qpos: torch.Tensor):
    """qpos (T, 76) -> world body quats (T, J, 4) and positions (T, J, 3),
    kinpoly ``Humanoid.qpos_fk``'s wbquat / wbpos (JAX
    ``ops/mujoco_xml.py:96``), by ``fk.fk_from_local_quat`` over the body
    tree (JAX's ``fk_generic``)."""
    t, j = qpos.shape[0], len(skeleton.body_names)
    joint_quat = rot.matrix_to_quat(euler_zyx_to_matrix(qpos[:, 7:].reshape(t, j - 1, 3)))
    local_quat = torch.cat([qpos[:, None, 3:7], joint_quat], dim=1)
    return fk_from_local_quat(local_quat, skeleton.offsets.to(qpos.device), qpos[:, :3], parents=skeleton.parents)
