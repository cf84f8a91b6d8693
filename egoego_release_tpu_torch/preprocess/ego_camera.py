"""Egocentric camera poses for ARES-style synthesis, Habitat's convention
(port of egoego_release_tpu/preprocess/ego_camera.py; the computational core
of the reference's utils/habitat_utils/save_obs_replica_from_motion_seq.py
:190-252, without the habitat-sim render call):

  1. head orientation = the global rotation of SMPL joint 15 from the
     motion's local rotations (``ops.fk.local_to_global_matrix``, on the
     device);
  2. camera frame = the head frame with its first and third columns
     negated (:239-242: the camera looks along -z with +y up);
  3. z-up (SMPL / mp3d) -> y-up (Habitat): Rx(-90 deg), which maps -z to
     Habitat's gravity (0, -1, 0) (:221-222);
  4. each frame's pose = (R @ head camera position, R @ camera rotation)
     (:244-249), as positions, wxyz quaternions and 4 x 4 matrices.

The CLI walks ``<root>/<motion>/motion_seq.npz`` (root_orient (T, 3, 3) or
(T, 3), pose_body (T, 21, 3, 3) or (T, 21, 3), joints (T, 22, 3),
head_cam_v_pos (T, 3)) and writes ``camera_poses.npz`` beside each.

    python -m egoego_release_tpu_torch.preprocess.ego_camera --data_dir <root> [--overwrite] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import rotations as rot
from egoego_release_tpu_torch.utils.device import resolve_device

# z-up (SMPL / mp3d) -> y-up (Habitat): Rx(-90 deg), quat_from_two_vectors([0, 0, -1], GRAVITY)
MP3D_TO_HABITAT = np.array([[1.0, 0.0, 0.0],
                            [0.0, 0.0, 1.0],
                            [0.0, -1.0, 0.0]])


def head_orientation(root_orient: np.ndarray, pose_body: np.ndarray, device="cuda") -> np.ndarray:
    """The head joint's (15) global rotations (T, 3, 3) from the local ones:
    root (T, 3, 3) or axis-angle (T, 3); body (T, 21, 3, 3) or axis-angle
    (T, 21, 3) (JAX ``preprocess/ego_camera.py:47``), computed on
    ``device``."""
    dev = resolve_device(device)
    root = torch.as_tensor(np.asarray(root_orient, np.float32), device=dev)
    body = torch.as_tensor(np.asarray(pose_body, np.float32), device=dev)
    if root.dim() == 2:
        root = rot.axis_angle_to_matrix(root)
    if body.dim() == 3:
        body = rot.axis_angle_to_matrix(body)
    glob = fk_mod.local_to_global_matrix(torch.cat([root[:, None], body], dim=1))
    return glob[:, fk_mod.HEAD_IDX].cpu().numpy()


def camera_rotation_from_head(head_rot: np.ndarray) -> np.ndarray:
    """Negate the first and third columns (:239-242): camera -z forward, +y up."""
    return np.stack([-head_rot[..., :, 0], head_rot[..., :, 1], -head_rot[..., :, 2]], axis=-1)


def camera_poses_from_motion(root_orient: np.ndarray, pose_body: np.ndarray, head_cam_pos: np.ndarray,
                             device="cuda") -> dict:
    """-> positions (T, 3) y-up, quats_wxyz (T, 4), mats4 (T, 4, 4), f32
    (JAX ``preprocess/ego_camera.py:71``); ``head_cam_pos`` (T, 3) z-up."""
    dev = resolve_device(device)
    cam_rot = camera_rotation_from_head(head_orientation(root_orient, pose_body, dev))
    pos_hab = head_cam_pos @ MP3D_TO_HABITAT.T
    rot_hab = np.einsum("ij,tjk->tik", MP3D_TO_HABITAT, cam_rot)
    quats = rot.matrix_to_quat(torch.as_tensor(rot_hab.astype(np.float32), device=dev)).cpu().numpy()
    mats4 = np.tile(np.eye(4), (len(pos_hab), 1, 1))
    mats4[:, :3, :3] = rot_hab
    mats4[:, :3, 3] = pos_hab
    return {"positions": pos_hab.astype(np.float32), "quats_wxyz": quats.astype(np.float32),
            "mats4": mats4.astype(np.float32)}


def process_motion_dir(motion_dir: str, overwrite: bool = False, device="cuda") -> bool:
    """``motion_dir``/motion_seq.npz -> camera_poses.npz beside it, unless
    that exists (and not ``overwrite``) or the motion is missing; the head
    camera at head_cam_v_pos, or at the head joint without it."""
    out_path = os.path.join(motion_dir, "camera_poses.npz")
    seq_path = os.path.join(motion_dir, "motion_seq.npz")
    if (os.path.exists(out_path) and not overwrite) or not os.path.exists(seq_path):
        return False
    seq = np.load(seq_path)
    head_pos = seq["head_cam_v_pos"] if "head_cam_v_pos" in seq else seq["joints"][:, fk_mod.HEAD_IDX]
    np.savez(out_path, **camera_poses_from_motion(seq["root_orient"], seq["pose_body"], head_pos, device))
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_dir", required=True, help="root of <motion>/motion_seq.npz dirs (:156)")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda", help="where the FK runs (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = 0
    for name in sorted(os.listdir(args.data_dir)):
        d = os.path.join(args.data_dir, name)
        if os.path.isdir(d) and process_motion_dir(d, args.overwrite, dev):
            n += 1
    print(f"wrote camera_poses.npz for {n} motions")
    return n


if __name__ == "__main__":
    main()
