"""SMPL-H body model on torch tensors (port of egoego_release_tpu/ops/smpl.py):
the model npz, shape and pose blendshapes, joint regression and linear
blend skinning, on the device that holds the model. The npz is the
reference's own (smpl_models/smplh_amass/{gender}/model.npz; SMPL models are
licensed, so the tests build synthetic ones). LBS and FK are plain
PyTorch: no TPU kernel stands behind them in the JAX package."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import rotations as rot


class SMPLModel(NamedTuple):
    """The parameters of one gender (JAX ``ops/smpl.py:32``); the tensors on
    one device, ``parents`` and ``faces`` on the host."""

    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_betas)
    posedirs: torch.Tensor      # (V, 3, (J_full - 1) * 9)
    j_regressor: torch.Tensor   # (J_full, V)
    weights: torch.Tensor       # (V, J_full)
    parents: np.ndarray         # (J_full,) int, parents[0] == -1
    faces: np.ndarray | None = None  # (F, 3) int32

    @property
    def device(self) -> torch.device:
        return self.v_template.device


def load_smpl_npz(path: str, num_betas: int = 16, device="cpu") -> SMPLModel:
    """A SMPL-H model npz; the first ``num_betas`` shape directions, as the
    reference keeps (JAX ``ops/smpl.py:44``)."""
    data = np.load(path, allow_pickle=True)
    j_reg = data["J_regressor"]
    j_reg = j_reg.toarray() if hasattr(j_reg, "toarray") else j_reg
    parents = np.asarray(data["kintree_table"][0], dtype=np.int64)
    parents[0] = -1
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    return SMPLModel(
        v_template=t(data["v_template"]), shapedirs=t(np.asarray(data["shapedirs"])[:, :, :num_betas]),
        posedirs=t(data["posedirs"]), j_regressor=t(j_reg), weights=t(data["weights"]), parents=parents,
        faces=np.asarray(data["f"], dtype=np.int32) if "f" in data else None)


def _fk_transforms(parents: np.ndarray, rot_mats: torch.Tensor, joints: torch.Tensor):
    """Each joint's world transform for LBS, composed one tree level at a
    time (JAX ``ops/smpl.py:68``): rot_mats (B, J, 3, 3) local rotations,
    joints (B, J, 3) rest joints -> (posed joints (B, J, 3), transforms
    relative to the rest pose (B, J, 4, 4))."""
    parents = np.asarray(parents)
    offsets = joints.clone()
    offsets[:, 1:] -= joints[:, parents[1:]]
    t = rot_mats.new_zeros(rot_mats.shape[:2] + (4, 4))
    t[..., :3, :3] = rot_mats
    t[..., :3, 3] = offsets
    t[..., 3, 3] = 1.0
    g = t.clone()
    for js, ps in fk_mod._levels(parents):
        g[:, js] = torch.matmul(g[:, ps], t[:, js])
    posed_joints = g[..., :3, 3].clone()
    rel = g.clone()
    rel[..., :3, 3] -= torch.einsum("bjik,bjk->bji", g[..., :3, :3], joints)
    return posed_joints, rel


def lbs(model: SMPLModel, betas, pose_aa, trans, want_verts: bool = True):
    """Linear blend skinning on the model's device (JAX ``ops/smpl.py:99``):
    betas (B, n_betas), pose_aa (B, J_full, 3) axis-angle with the root
    orientation first, trans (B, 3) -> (joints (B, J_full, 3), verts (B, V,
    3) or None)."""
    dev = model.device
    betas, pose_aa, trans = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (betas, pose_aa, trans))
    v_shaped = model.v_template + torch.einsum("vdk,bk->bvd", model.shapedirs, betas)
    j_rest = torch.einsum("jv,bvd->bjd", model.j_regressor, v_shaped)
    rot_mats = rot.axis_angle_to_matrix(pose_aa)
    posed_joints, rel = _fk_transforms(model.parents, rot_mats, j_rest)

    verts = None
    if want_verts:
        pose_feature = (rot_mats[:, 1:] - torch.eye(3, device=dev)).reshape(betas.shape[0], -1)
        v_posed = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs, pose_feature)
        t_blend = torch.einsum("vj,bjik->bvik", model.weights, rel)
        v_h = torch.cat([v_posed, v_posed.new_ones(v_posed.shape[:-1] + (1,))], dim=-1)
        verts = torch.einsum("bvik,bvk->bvi", t_blend, v_h)[..., :3] + trans[:, None, :]
    return posed_joints + trans[:, None, :], verts


def rest_joints(model: SMPLModel, betas=None) -> torch.Tensor:
    """Rest-pose joints (J_full, 3) at ``betas`` (1, n_betas), zeros by
    default (JAX ``ops/smpl.py:132``)."""
    if betas is None:
        betas = model.shapedirs.new_zeros(1, model.shapedirs.shape[-1])
    betas = torch.as_tensor(betas, dtype=torch.float32, device=model.device)
    v_shaped = model.v_template + torch.einsum("vdk,bk->bvd", model.shapedirs, betas)
    return torch.einsum("jv,bvd->bjd", model.j_regressor, v_shaped)[0]


def rest_offsets_22(model: SMPLModel) -> torch.Tensor:
    """The 22 rest bone offsets of ``fk_smpl``: zero-beta rest joints minus
    their parents', the root's offset 0, as the reference's
    get_rest_pose_joints (JAX ``ops/smpl.py:140``)."""
    j = rest_joints(model)[: fk_mod.NUM_JOINTS]
    parents = fk_mod.SMPL_PARENTS.copy()
    parents[0] = 0
    return j - j[parents]


class GenderedSMPL(NamedTuple):
    """The male and the female model, for batches of mixed gender (JAX
    ``ops/smpl.py:150``)."""

    male: SMPLModel
    female: SMPLModel

    def run(self, betas, pose_aa, trans, is_female, want_verts: bool = True):
        """Both models' LBS, selected per element by ``is_female`` (B,)."""
        jm, vm = lbs(self.male, betas, pose_aa, trans, want_verts)
        jf, vf = lbs(self.female, betas, pose_aa, trans, want_verts)
        sel = torch.as_tensor(is_female, dtype=torch.bool, device=jm.device)[:, None, None]
        return torch.where(sel, jf, jm), torch.where(sel, vf, vm) if want_verts else None


def load_gendered_smpl(smplh_dir: str, num_betas: int = 16, device="cpu") -> GenderedSMPL:
    """{smplh_dir}/male/model.npz and female/model.npz (JAX ``ops/smpl.py:174``)."""
    return GenderedSMPL(*(load_smpl_npz(os.path.join(smplh_dir, g, "model.npz"), num_betas, device)
                          for g in ("male", "female")))
