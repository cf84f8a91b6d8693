"""Head-pose sequence datasets, the stage-1 eval inputs (port of
egoego_release_tpu/data/headpose.py). One dataset covers the ARES, GIMO,
Kinpoly-RealWorld and demo variants: they share the record schema and the
SLAM attachment and differ in paths and splits. Host-side numpy; the
pickles are read by ``formats.load_pickle`` (no joblib needed).

Only precomputed optical-flow features are ported (``input_of_feats=True``,
the eval path); raw flow frames feed the CNN variant of HeadNet, which is
not ported (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from egoego_release_tpu_torch.data import formats
from egoego_release_tpu_torch.ops import alignment

_SLAM_KEYS = ("aligned_slam_trans", "aligned_slam_rot_quat", "aligned_slam_rot_mat",
              "ori_slam_trans", "ori_slam_rot_quat", "ori_slam_rot_mat")


class HeadPoseSequenceDataset:
    """Sequences with head pose, OF features and attached DROID-SLAM results.

    motion_path: pickle of per-sequence records; slam_res_folder: root of
    the DROID-SLAM npys ({scene}/{name}.npy); of_rewrite: (old, new) prefix
    of the OF file paths; window: crop length when training (eval takes
    whole sequences)."""

    def __init__(self, motion_path: str, slam_res_folder: str | None = None,
                 of_rewrite: tuple[str, str] | None = None, window: int = 120, train: bool = False,
                 for_eval: bool = True, min_len: int | None = None, require_of_match: bool = False,
                 input_of_feats: bool = True, seed: int = 0):
        if not input_of_feats:
            raise NotImplementedError(
                "raw optical-flow input (the HeadNet CNN variant) is not ported to the PyTorch "
                "package yet (see ROADMAP.md)")
        self.window = window
        self.train = train
        self.for_eval = for_eval
        self.of_rewrite = of_rewrite
        self._rng = random.Random(seed)

        raw = formats.load_motion_dict(motion_path)
        kept = []
        for k in raw:
            rec = raw[k]
            seq_len = rec["head_qpos"].shape[0]
            if min_len is not None and seq_len <= min_len:
                continue
            if require_of_match and seq_len - 1 != len(rec["of_files"]):
                continue
            kept.append(rec)

        self.data = {}
        self.missing_slam = 0
        for rec in kept:
            if slam_res_folder is not None:
                npy = formats.find_slam_npy(slam_res_folder, rec["seq_name"])
                if npy is None:
                    self.missing_slam += 1
                    continue
                ori_trans, ori_mat, ori_quat = formats.load_droidslam(npy)
                a_trans, a_mat, a_quat = alignment.align_slam_to_first_frame_np(
                    ori_trans, ori_quat, rec["head_qpos"][0].astype(np.float32))
                rec = dict(rec, aligned_slam_trans=a_trans, aligned_slam_rot_mat=a_mat,
                           aligned_slam_rot_quat=a_quat, ori_slam_trans=ori_trans,
                           ori_slam_rot_mat=ori_mat, ori_slam_rot_quat=ori_quat)
            self.data[len(self.data)] = rec

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        """head_pose (T+1, 7), head_vels (T, 6), of (T, 512), seq_name,
        seq_len, and the SLAM fields (T+1, ...) when attached."""
        rec = self.data[index]
        seq_head_vels = rec["head_vels"][:-1]  # the last velocity is a duplicate
        seq_len = seq_head_vels.shape[0]
        if self.for_eval:
            t0, t1 = 0, seq_len
        else:
            t0 = self._rng.randint(0, seq_len - self.window)
            t1 = t0 + self.window
        q = {
            "head_pose": rec["head_qpos"][t0: t1 + 1].astype(np.float32),
            "head_vels": seq_head_vels[t0:t1].astype(np.float32),
            "of": formats.load_of_feats(rec["of_files"][t0:t1], self.of_rewrite),
            "seq_name": rec["seq_name"],
            "seq_len": t1 - t0,
        }
        for key in _SLAM_KEYS:
            if key in rec:
                q[key] = rec[key][t0: t1 + 1].astype(np.float32)
        return q


def ARESDemoDataset(data_root_folder: str) -> HeadPoseSequenceDataset:
    """The bundled demo fixture; the authors' cluster paths of the OF files
    are rewritten onto ``data_root_folder``."""
    return HeadPoseSequenceDataset(
        motion_path=os.path.join(data_root_folder, "demo_ares_data.p"),
        slam_res_folder=os.path.join(data_root_folder, "droid_slam_res"),
        of_rewrite=("/viscam/u/jiamanli/datasets/egomotion_syn_dataset/habitat_rendering_replica_all",
                    data_root_folder),
        for_eval=True)


def ARESHeadPoseDataset(data_root_folder: str, train: bool, window: int = 120,
                        for_eval: bool = False) -> HeadPoseSequenceDataset:
    split = "train" if train else "test"
    return HeadPoseSequenceDataset(
        motion_path=os.path.join(data_root_folder, "ares_egoego_processed", f"{split}_ares_smplh_motion.p"),
        slam_res_folder=os.path.join(data_root_folder, "ares", "droid_slam_res"),
        of_rewrite=("/viscam/u/jiamanli/datasets/egomotion_syn_dataset",
                    os.path.join(data_root_folder, "ares")),
        window=window, train=train, for_eval=for_eval, min_len=window, require_of_match=True)


def GIMOHeadPoseDataset(data_root_folder: str, train: bool, window: int = 120, for_eval: bool = False,
                        split_json: str | None = None) -> HeadPoseSequenceDataset:
    """An optional split json {seq_name: "train" | "test"} filters the records."""
    split = "train" if train else "test"
    ds = HeadPoseSequenceDataset(
        motion_path=os.path.join(data_root_folder, "gimo_egoego_processed", f"{split}_gimo_motion.p"),
        slam_res_folder=os.path.join(data_root_folder, "gimo", "droid_slam_res"),
        window=window, train=train, for_eval=for_eval, min_len=window)
    split_json = split_json or os.path.join(data_root_folder, "gimo_egoego_processed", "train_test_split.json")
    if os.path.exists(split_json):
        with open(split_json) as f:
            split_map = json.load(f)
        recs = [r for r in ds.data.values() if split_map.get(r["seq_name"], split) == split]
        ds.data = dict(enumerate(recs))
    return ds


def RealWorldHeadPoseDataset(data_root_folder: str, train: bool, window: int = 120, for_eval: bool = False,
                             eval_on_kinpoly_mocap: bool = False) -> HeadPoseSequenceDataset:
    if eval_on_kinpoly_mocap:
        motion_path = os.path.join(data_root_folder, "kinpoly-mocap", "mocap_annotations.p")
    else:
        split = "train" if train else "test"
        motion_path = os.path.join(data_root_folder, "kinpoly_egoego_processed", f"{split}_kinpoly_motion.p")
    return HeadPoseSequenceDataset(
        motion_path=motion_path,
        slam_res_folder=os.path.join(data_root_folder, "kinpoly", "droid_slam_res"),
        window=window, train=train, for_eval=for_eval, min_len=window)
