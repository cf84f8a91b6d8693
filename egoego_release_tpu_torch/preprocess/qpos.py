"""Kinpoly expert records from motion pickles: the qpos conversion CLI (port
of egoego_release_tpu/preprocess/qpos.py; the reference's
utils/data_utils/convert_amass_to_qpos.py and the post_process_expert
features of kinpoly/relive/data_process/convert_amass_ego_syn_to_qpos.py).

SMPL motion -> the MuJoCo-layout qpos (76) and its finite-difference qvel
(75), the head pose from the SMPL FK and its velocities, and the object's
pose relative to the head, on the device, written as a
mocap_annotations.p-style plain pickle keyed by seq_name (the records that
``data.kinpoly.StateARDataset``, ``train_trajar`` and ``eval_trajar``
read). As in the JAX package, the qpos codec is the closed-form ZYX-euler
one (``ops.geometry.smpl_to_qpos``); no simulator is in the loop.

    python -m egoego_release_tpu_torch.preprocess.qpos --motion_path <motion.p> --out <expert.p> \\
        (--smplh_path <dir> | --rest_offsets <rest.npy>) [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from egoego_release_tpu_torch.data.formats import load_motion_dict, save_pickle
from egoego_release_tpu_torch.models.trajar import qvel_fd
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.utils.device import resolve_device


def get_qvel_fd(qpos: torch.Tensor, dt: float = 1.0 / 30.0) -> torch.Tensor:
    """Finite-difference qvel (T-1, 75) of qpos (T, 76): the linear velocity
    in the world, the root's angular velocity in the root frame with (-pi,
    pi] wrapping, the joint-angle rates (JAX ``preprocess/qpos.py:29``)."""
    return qvel_fd(qpos[:-1], qpos[1:], dt)


def motion_to_expert(trans: np.ndarray, pose_aa22: np.ndarray, rest_offsets, obj_pose: np.ndarray | None = None,
                     dt: float = 1.0 / 30.0, device="cuda") -> dict:
    """One sequence (trans (T, 3), SMPL-order local axis-angles (T, 22, 3),
    rest offsets (22, 3), an object pose (T, 7), identity by default) -> the
    kinpoly expert record {qpos, qvel, head_pose, head_vels, obj_pose,
    obj_head_relative_poses}, f32 numpy, computed on ``device`` (JAX
    ``preprocess/qpos.py:43``)."""
    dev = resolve_device(device)
    t = trans.shape[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    aa24 = np.zeros((t, 24, 3), np.float32)  # zero hand rotations for the codec
    aa24[:, :22] = pose_aa22
    qpos = geometry.smpl_to_qpos(f32(trans), f32(aa24))
    qvel = get_qvel_fd(qpos, dt)

    gq, gp = fk_mod.fk_smpl(f32(trans), f32(pose_aa22), f32(rest_offsets))
    head_pose = torch.cat([gp[:, fk_mod.HEAD_IDX], gq[:, fk_mod.HEAD_IDX]], dim=-1)
    head_vels = geometry.get_head_vel(head_pose, dt)
    if obj_pose is None:
        obj_pose = np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32), (t, 1))
    obj_rel = geometry.get_obj_relative_pose(f32(obj_pose), head_pose, num_objs=obj_pose.shape[1] // 7)
    out = {"qpos": qpos, "qvel": qvel, "head_pose": head_pose, "head_vels": head_vels, "obj_pose": f32(obj_pose),
           "obj_head_relative_poses": obj_rel}
    return {k: v.cpu().numpy().astype(np.float32) for k, v in out.items()}


def convert_motion_pickle(motion_path: str, out_path: str, rest_offsets, device="cuda") -> dict:
    """A motion pickle ({index: record}, plain or joblib) -> the expert
    pickle keyed by seq_name (JAX ``preprocess/qpos.py:86``). Returns it."""
    dev = resolve_device(device)
    data = load_motion_dict(motion_path)
    out = {}
    for k in data:
        rec = data[k]
        pose_aa = np.concatenate([np.asarray(rec["root_orient"], np.float32)[:, None],
                                  np.asarray(rec["body_pose"], np.float32).reshape(-1, 21, 3)], axis=1)
        expert = motion_to_expert(np.asarray(rec["trans"], np.float32), pose_aa, rest_offsets, device=dev)
        expert["seq_name"] = rec.get("seq_name", str(k))
        out[expert["seq_name"]] = expert
    save_pickle(out, out_path)
    print(f"wrote {len(out)} expert records -> {out_path}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--motion_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--device", default="cuda", help="where the codec and the FK run (cuda or cpu)")
    args = p.parse_args(argv)

    from egoego_release_tpu_torch.eval.build import load_rest_offsets

    rest = load_rest_offsets(args.smplh_path, args.rest_offsets)
    return convert_motion_pickle(args.motion_path, args.out, rest, device=args.device)


if __name__ == "__main__":
    main()
