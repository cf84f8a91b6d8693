"""ARES / GIMO dataset processing CLI (port of
egoego_release_tpu/preprocess/ares.py; the reference's
utils/data_utils/process_ares_dataset.py and, for GIMO,
utils/gimo_utils/process_gimo_data.py).

``process`` walks a root of rendered sequences ({scene}/{seq}/ with
``raft_flows/*.npy`` and ``ori_motion_seq.npz``), runs the SMPL forward for
the joints on the device (``preprocess.amass.smpl_joints``), fits the floor,
builds the head-pose features (``preprocess.amass.head_features``) and
writes the motion pickle the head-pose datasets read (with the records'
``of_files``), {dataset}_smplh_motion.p, and its train_ / test_ splits (ARES:
the test scenes of ARES_TEST_SCENES; GIMO: every sequence in train), as
plain pickles. ``extract`` attaches the source AMASS window to each rendered
sequence folder as ori_motion_seq.npz (extract_amass_motion_for_ares.py).
A GIMO sequence is expected in the same ``ori_motion_seq.npz`` schema: the
output of the reference's VPoser fitting (``preprocess.gimo_pose``).

    python -m egoego_release_tpu_torch.preprocess.ares process --rendered_root <dir> \\
        --smplh_path <smpl models> --out <dir> [--dataset ares|gimo] [--device cpu]
    python -m egoego_release_tpu_torch.preprocess.ares extract --amass_processed_root <dir> \\
        --rendered_root <dir> --index_pkl <index.p>
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

from egoego_release_tpu_torch.data.formats import save_pickle
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops.smpl import SMPLModel, load_smpl_npz
from egoego_release_tpu_torch.preprocess.amass import head_features, smpl_joints
from egoego_release_tpu_torch.utils.device import resolve_device

ARES_TEST_SCENES = ("office_0", "hotel_0", "room_2", "frl_apartment_4", "apartment_0")


def extract_motion_for_renders(amass_processed_root: str, render_root: str, index_pkl_path: str) -> int:
    """Each rendered sequence's window of its processed AMASS npz ->
    {render_root}/{scene_name}/{seq_name}/ori_motion_seq.npz
    (extract_amass_motion_for_ares.py:24-55; JAX ``preprocess/ares.py:39``):
    the index pickle maps each sequence to an npz path and a
    [start_frame_idx, start + num_frames) window; per-frame arrays are
    sliced, the rest (fps, gender, betas, floor_height) passes through.
    Host numpy. Returns the count written."""
    with open(index_pkl_path, "rb") as f:
        index = pickle.load(f)
    written = 0
    for entry in index.values():
        src = np.load(os.path.join(amass_processed_root, entry["path"]), allow_pickle=True)
        s = int(entry["start_frame_idx"])
        e = s + int(entry["num_frames"])
        n_total = src["trans"].shape[0]
        out = {key: src[key][s:e] if src[key].ndim >= 1 and src[key].shape[0] == n_total else src[key]
               for key in src.files}
        seq_folder = os.path.join(render_root, entry["scene_name"], entry["seq_name"])
        os.makedirs(seq_folder, exist_ok=True)
        np.savez(os.path.join(seq_folder, "ori_motion_seq.npz"), **out)
        written += 1
    print(f"extracted motion for {written} rendered sequences")
    return written


def process_rendered_seq(seq_folder: str, model: SMPLModel, fps: int = 30) -> dict | None:
    """One rendered sequence folder -> a motion record with of_files (JAX
    ``preprocess/ares.py:73``), or None without flows or motion; the SMPL
    forward and the head features on the model's device."""
    flow_folder = os.path.join(seq_folder, "raft_flows")
    motion_path = os.path.join(seq_folder, "ori_motion_seq.npz")
    if not (os.path.isdir(flow_folder) and os.path.exists(motion_path)):
        return None
    of_files = sorted(os.path.join(flow_folder, f) for f in os.listdir(flow_folder) if f.endswith(".npy"))

    d = np.load(motion_path)
    root_orient = np.asarray(d["root_orient"], np.float32)
    pose_body = np.asarray(d["pose_body"], np.float32)
    trans = np.array(d["trans"], np.float32)
    betas = np.asarray(d["betas"], np.float32)
    gender = str(d["gender"]) if "gender" in d else "male"

    joint_seq = smpl_joints(model, root_orient, pose_body, trans, betas)
    floor_height, _, _ = geometry.determine_floor_height_and_contacts(joint_seq, fps)
    trans[:, 2] -= floor_height
    joint_seq[:, :, 2] -= floor_height

    feats = head_features(root_orient, pose_body, joint_seq, device=model.device)
    return {"root_orient": root_orient, "body_pose": pose_body, "trans": trans, "beta": betas, "gender": gender,
            "of_files": of_files, **feats}


def process_root(rendered_root: str, smplh_path: str, out_folder: str, dataset: str = "ares",
                 device="cuda") -> str:
    """Every {scene}/{seq} under ``rendered_root`` -> the motion pickle and
    its splits under ``out_folder`` (JAX ``preprocess/ares.py:122``); the
    male model on ``device``. Returns the combined pickle's path."""
    model = load_smpl_npz(os.path.join(smplh_path, "male", "model.npz"), device=resolve_device(device))
    os.makedirs(out_folder, exist_ok=True)
    data = {}
    for scene in sorted(os.listdir(rendered_root)):
        scene_path = os.path.join(rendered_root, scene)
        if not os.path.isdir(scene_path):
            continue
        for seq in sorted(os.listdir(scene_path)):
            rec = process_rendered_seq(os.path.join(scene_path, seq), model)
            if rec is None:
                continue
            name = f"{scene}-{seq}"
            rec["seq_name"] = name
            data[name] = rec
            print(f"{name}: {rec['trans'].shape[0]} frames")

    out_path = os.path.join(out_folder, f"{dataset}_smplh_motion.p")
    save_pickle(data, out_path)
    test_scenes = ARES_TEST_SCENES if dataset == "ares" else ()
    train = {k: v for k, v in data.items() if k.split("-")[0] not in test_scenes}
    test = {k: v for k, v in data.items() if k.split("-")[0] in test_scenes}
    save_pickle(dict(enumerate(train.values())), os.path.join(out_folder, f"train_{dataset}_smplh_motion.p"))
    save_pickle(dict(enumerate(test.values())), os.path.join(out_folder, f"test_{dataset}_smplh_motion.p"))
    print(f"{dataset}: {len(data)} seqs ({len(train)} train / {len(test)} test)")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd")
    pp = sub.add_parser("process", help="rendered seqs -> motion pickle")
    pp.add_argument("--rendered_root", required=True)
    pp.add_argument("--smplh_path", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--dataset", choices=["ares", "gimo"], default="ares")
    pp.add_argument("--device", default="cuda", help="where the SMPL forward runs (cuda or cpu)")
    pe = sub.add_parser("extract", help="attach AMASS motion windows to rendered seq folders "
                                        "(extract_amass_motion_for_ares.py)")
    pe.add_argument("--amass_processed_root", required=True)
    pe.add_argument("--rendered_root", required=True)
    pe.add_argument("--index_pkl", required=True)
    # no subcommand = process (the original flag surface); decided before
    # parsing, since argparse would take the first flag's value for one
    argv = list(argv) if argv is not None else sys.argv[1:]
    if argv and argv[0] not in ("process", "extract", "-h", "--help"):
        argv = ["process"] + argv
    args = p.parse_args(argv)
    if args.cmd is None:
        p.error("a subcommand (process/extract) or the process flags are required")
    if args.cmd == "process":
        return process_root(args.rendered_root, args.smplh_path, args.out, args.dataset, args.device)
    return extract_motion_for_renders(args.amass_processed_root, args.rendered_root, args.index_pkl)


if __name__ == "__main__":
    main()
