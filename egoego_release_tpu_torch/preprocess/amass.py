"""AMASS preprocessing CLI (port of egoego_release_tpu/preprocess/amass.py;
the reference's utils/data_utils/process_amass_dataset.py).

``process``: each AMASS npz -> the middle 80% of its frames, the SMPL-H
forward for the joints (``ops.smpl.lbs`` on the device, in chunks of
SPLIT_FRAME_LIMIT frames, joints only), the floor height and contacts fitted
on the host (``ops.geometry.determine_floor_height_and_contacts``, a 1-D
DBSCAN), the terrain discard, the resample to 30 fps and the head-pose
features -> one npz a sequence. ``aggregate``: the npz tree -> the motion
pickle (amass_smplh_motion.p) and its train_ / test_ splits, which the
stage-2 trainer and ``eval_stage2`` read. The pickles are plain pickles:
``data.formats.load_motion_dict`` and the JAX package's ``joblib.load`` read
them.

    python -m egoego_release_tpu_torch.preprocess.amass process \\
        --amass_root <amass npz root> --smplh_path <smpl models> --out <dir> [--device cpu]
    python -m egoego_release_tpu_torch.preprocess.amass aggregate \\
        --processed_root <dir> --out <dir>/amass_smplh_motion.p
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from egoego_release_tpu_torch.data.formats import save_pickle
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops import rotations as rot
from egoego_release_tpu_torch.ops.smpl import SMPLModel, lbs, load_smpl_npz
from egoego_release_tpu_torch.utils.device import resolve_device

NUM_BETAS = 10
OUT_FPS = 30
DISCARD_SHORTER_THAN = 1.0  # seconds
SPLIT_FRAME_LIMIT = 2000

TRAIN_DATASETS = (
    "CMU", "MPI_Limits", "TotalCapture", "Eyes_Japan_Dataset", "KIT",
    "BioMotionLab_NTroje", "BMLmovi", "EKUT", "ACCAD",
)
TEST_DATASETS = ("Transitions_mocap", "HumanEva")


def head_features(root_orient: np.ndarray, pose_body: np.ndarray, joints: np.ndarray, device="cuda") -> dict:
    """The global head rotation and translation (and their frame-to-frame
    differences), and kinpoly's head_qpos / head_vels
    (process_amass_dataset.py:455-478; JAX ``preprocess/amass.py:48``),
    computed on ``device``, returned as f32 numpy."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    local_aa = torch.cat([t(root_orient)[:, None], t(pose_body).reshape(-1, 21, 3)], dim=1)
    head_mat = fk_mod.local_to_global_matrix(rot.axis_angle_to_matrix(local_aa))[:, fk_mod.HEAD_IDX]
    head_trans = t(joints[:, fk_mod.HEAD_IDX])
    head_mat_diff = torch.matmul(head_mat[:-1].transpose(-1, -2), head_mat[1:])
    head_qpos = torch.cat([head_trans, rot.matrix_to_quat(head_mat)], dim=-1)
    out = {
        "head_qpos": head_qpos,
        "head_vels": geometry.get_head_vel(head_qpos),
        "global_head_rot_6d": rot.matrix_to_rot6d(head_mat),
        "global_head_trans": head_trans,
        "global_head_rot_6d_diff": rot.matrix_to_rot6d(head_mat_diff),
        "global_head_trans_diff": head_trans[1:] - head_trans[:-1],
    }
    return {k: v.cpu().numpy().astype(np.float32) for k, v in out.items()}


def smpl_joints(model: SMPLModel, root_orient: np.ndarray, pose_body: np.ndarray, trans: np.ndarray,
                betas: np.ndarray, pose_hand: np.ndarray | None = None) -> np.ndarray:
    """The 22 body joints (T, 22, 3) of the SMPL-H forward on the model's
    device, SPLIT_FRAME_LIMIT frames at a time: the root and body
    axis-angles, the hands' where given (else zero), ``betas`` in the first
    of the model's shape directions."""
    j_full, n_model_betas = model.parents.shape[0], model.shapedirs.shape[-1]
    n = root_orient.shape[0]
    joints = []
    for s in range(0, n, SPLIT_FRAME_LIMIT):
        e = min(s + SPLIT_FRAME_LIMIT, n)
        aa = np.zeros((e - s, j_full, 3), np.float32)
        aa[:, 0] = root_orient[s:e]
        aa[:, 1:22] = pose_body[s:e].reshape(-1, 21, 3)
        if pose_hand is not None:
            n_hand = min(j_full - 22, pose_hand.shape[1] // 3)
            aa[:, 22:22 + n_hand] = pose_hand[s:e, : n_hand * 3].reshape(-1, n_hand, 3)
        b = np.zeros((e - s, n_model_betas), np.float32)
        b[:, : min(betas.shape[0], n_model_betas)] = betas[:n_model_betas]
        j, _ = lbs(model, b, aa, trans[s:e], want_verts=False)
        joints.append(j[:, :22].cpu().numpy())
    return np.concatenate(joints)


def process_seq(input_path: str, output_path: str, model: SMPLModel, fps_override=None) -> str | None:
    """One AMASS npz -> a processed npz (process_amass_dataset.py:340-492;
    JAX ``preprocess/amass.py:71``), or None when the sequence is shorter
    than DISCARD_SHORTER_THAN seconds or on terrain. The SMPL forward runs on
    the model's device."""
    t0 = time.time()
    bdata = np.load(input_path)
    gender = "male"  # the reference forces one skeleton (:352)
    fps = float(fps_override or bdata["mocap_framerate"])
    if "BMLhandball" in input_path:
        fps = 240.0
    if "20160930_50032" in input_path or "20161014_50033" in input_path:
        fps = 59.0

    num_frames = bdata["poses"].shape[0]
    sl = slice(int(0.1 * num_frames), int(0.9 * num_frames))  # the middle 80%
    trans = bdata["trans"][sl].astype(np.float32)
    root_orient = bdata["poses"][sl, :3].astype(np.float32)
    pose_body = bdata["poses"][sl, 3:66].astype(np.float32)
    pose_hand = bdata["poses"][sl, 66:].astype(np.float32)
    betas = np.zeros(NUM_BETAS, np.float32)
    num_frames = trans.shape[0]
    if num_frames < DISCARD_SHORTER_THAN * fps:
        return None

    joint_seq = smpl_joints(model, root_orient, pose_body, trans, betas, pose_hand)
    floor_height, contacts, discard = geometry.determine_floor_height_and_contacts(joint_seq, int(fps))
    trans[:, 2] -= floor_height
    joint_seq[:, :, 2] -= floor_height

    if OUT_FPS < fps:
        idx = np.linspace(0, num_frames - 1, num=int(OUT_FPS / fps * num_frames), dtype=int)
        trans, root_orient, pose_body = trans[idx], root_orient[idx], pose_body[idx]
        contacts, joint_seq = contacts[idx], joint_seq[idx]
        fps = OUT_FPS
    if discard:
        return None

    feats = head_features(root_orient, pose_body, joint_seq, device=model.device)
    out = dict(fps=fps, gender=gender, floor_height=floor_height, contacts=contacts, trans=trans,
               root_orient=root_orient, pose_body=pose_body, betas=betas, joints=joint_seq, **feats)
    output_path = output_path[:-4] + "_%d_frames_%d_fps.npz" % (trans.shape[0], int(fps))
    np.savez(output_path, **out)
    print(f"{input_path}: {trans.shape[0]} frames in {time.time() - t0:.1f}s")
    return output_path


def process_tree(amass_root: str, smplh_path: str, out: str, device="cuda") -> list[str]:
    """``process`` over every npz under ``amass_root`` (sorted within each
    directory), mirrored under ``out``; the male model on ``device``.
    Returns the written paths."""
    model = load_smpl_npz(os.path.join(smplh_path, "male", "model.npz"), device=resolve_device(device))
    written = []
    for dirpath, _, files in os.walk(amass_root):
        for f in sorted(files):
            if f.endswith(".npz"):
                od = os.path.join(out, os.path.relpath(dirpath, amass_root))
                os.makedirs(od, exist_ok=True)
                path = process_seq(os.path.join(dirpath, f), os.path.join(od, f), model)
                if path is not None:
                    written.append(path)
    return written


def aggregate(processed_root: str, out_path: str) -> dict:
    """The processed npz tree -> one motion pickle and its train / test
    splits (prep_smpl_to_single_data + reorganize_data,
    process_amass_dataset.py:495-583; JAX ``preprocess/amass.py:134``).
    Returns the combined dict."""
    data = {}
    for subset in sorted(os.listdir(processed_root)):
        subset_path = os.path.join(processed_root, subset)
        if not os.path.isdir(subset_path):
            continue
        for dirpath, _, files in os.walk(subset_path):
            for f in sorted(files):
                if not f.endswith(".npz"):
                    continue
                d = np.load(os.path.join(dirpath, f))
                name = f"{os.path.relpath(dirpath, processed_root).replace(os.sep, '-')}-{f}"
                data[name] = {
                    "root_orient": d["root_orient"], "body_pose": d["pose_body"],
                    "trans": d["trans"], "beta": d["betas"], "seq_name": name,
                    "gender": str(d["gender"]),
                    "head_qpos": d["head_qpos"], "head_vels": d["head_vels"],
                    "global_head_trans": d["global_head_trans"],
                    "global_head_rot_6d": d["global_head_rot_6d"],
                    "global_head_rot_6d_diff": d["global_head_rot_6d_diff"],
                    "global_head_trans_diff": d["global_head_trans_diff"],
                }
    save_pickle(data, out_path)
    train = {k: v for k, v in data.items() if k.split("-")[0] in TRAIN_DATASETS}
    test = {k: v for k, v in data.items() if k.split("-")[0] in TEST_DATASETS}
    base = os.path.basename(out_path)
    save_pickle(dict(enumerate(train.values())), out_path.replace(base, "train_" + base))
    save_pickle(dict(enumerate(test.values())), out_path.replace(base, "test_" + base))
    print(f"aggregated {len(data)} seqs ({len(train)} train / {len(test)} test)")
    return data


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("process")
    pp.add_argument("--amass_root", required=True)
    pp.add_argument("--smplh_path", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--device", default="cuda", help="where the SMPL forward runs (cuda or cpu)")
    pa = sub.add_parser("aggregate")
    pa.add_argument("--processed_root", required=True)
    pa.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "process":
        return process_tree(args.amass_root, args.smplh_path, args.out, args.device)
    return aggregate(args.processed_root, args.out)


if __name__ == "__main__":
    main()
