"""Mesh export for visualization (port of egoego_release_tpu/vis/mesh_export.py):
SMPL-H LBS of the predicted motion on the device, one .obj per frame
written on the host, for the reference's Blender scripts or any DCC tool
(the reference's writer: egoego/vis/blender_vis_mesh_motion.py:103)."""

from __future__ import annotations

import os

import numpy as np

from egoego_release_tpu_torch.ops.smpl import lbs, load_smpl_npz
from egoego_release_tpu_torch.utils.device import resolve_device


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """v and f records, faces 1-indexed (JAX ``vis/mesh_export.py:19``)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def export_obj_sequence(smplh_path: str, local_aa: np.ndarray, root_pos: np.ndarray, out_dir: str,
                        betas: np.ndarray | None = None, gender: str = "male", batch: int = 32,
                        device="cuda") -> list[str]:
    """LBS of local_aa (T, 22, 3) at root_pos (T, 3) through
    ``{smplh_path}/{gender}/model.npz`` on ``device``, ``batch`` frames a
    call, hands and fingers at zero pose (22 joints padded to the model's
    52), then ``{out_dir}/{frame:05d}.obj`` per frame (JAX
    ``vis/mesh_export.py:28``). Returns the paths."""
    model = load_smpl_npz(os.path.join(smplh_path, gender, "model.npz"), device=resolve_device(device))
    if model.faces is None:
        raise ValueError(f"{smplh_path}/{gender}/model.npz has no faces ('f')")
    t = local_aa.shape[0]
    if betas is None:
        betas = np.zeros((model.shapedirs.shape[-1],), np.float32)
    full_aa = np.zeros((t, model.parents.shape[0], 3), np.float32)
    full_aa[:, :22] = local_aa

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for start in range(0, t, batch):
        end = min(start + batch, t)
        _, verts = lbs(model, np.tile(betas[None], (end - start, 1)), full_aa[start:end],
                       np.asarray(root_pos[start:end], np.float32))
        for i, v in enumerate(verts.cpu().numpy()):
            paths.append(os.path.join(out_dir, f"{start + i:05d}.obj"))
            save_obj(paths[-1], v, model.faces)
    return paths
