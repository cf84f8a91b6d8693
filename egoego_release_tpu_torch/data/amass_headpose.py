"""GravityNet's training data (port of egoego_release_tpu/data/amass_headpose.py):
ground-truth head trajectories under a random rotation and scale, which
supply their own targets. Rotating a gravity-aligned trajectory by R makes
the floor normal R @ [0, 0, 1]; scaling its translation steps by s in
[0.1, 10) makes the inverse scale 1 / s.

Host-side numpy. The draws are the JAX package's, from the same sources:
the crop from Python's module-level ``random``, the rotation (scipy's
``Rotation.random``) and the scale from the dataset's
``np.random.RandomState(seed)``, and the batch order from that state too,
so a seeded run yields the JAX package's batches element for element.
"""

from __future__ import annotations

import random

import numpy as np
from scipy.spatial.transform import Rotation as sR

from egoego_release_tpu_torch.ops.rotations import quat_to_matrix_np

TRAIN_DATASETS = (
    "CMU", "MPI_Limits", "TotalCapture", "Eyes_Japan_Dataset", "KIT",
    "BioMotionLab_NTroje", "BMLmovi", "EKUT", "ACCAD",
)


def augment_head_traj(head_pose: np.ndarray, rng: np.random.RandomState) -> dict:
    """head_pose (T, 7) -> the trajectory under a random rotation (first
    frame at the origin) and scale, with the targets: the recovering
    rotation, the inverse scale and the floor normal."""
    trans = head_pose[:, :3]
    rot_mat = quat_to_matrix_np(head_pose[:, 3:])
    random_rot = sR.random(random_state=rng).as_matrix().astype(np.float32)
    aug_rot_mat = np.einsum("ij,tjk->tik", random_rot, rot_mat)
    aug_trans = np.einsum("ij,tj->ti", random_rot, trans - trans[0:1])
    floor_normal = random_rot @ np.asarray([0.0, 0.0, 1.0], np.float32)
    scale = rng.uniform(0.1, 10.0)
    diffs = (aug_trans[1:] - aug_trans[:-1]) * scale
    aug_trans = np.concatenate([aug_trans[0:1], aug_trans[0:1] + np.cumsum(diffs, axis=0)])
    return {
        "head_rot_mat": aug_rot_mat.astype(np.float32),
        "head_trans": aug_trans.astype(np.float32),
        "aligned_rot_mat": random_rot.T,
        "aligned_scale": np.float32(1.0 / scale),
        "floor_normal": floor_normal.astype(np.float32),
    }


class AMASSHeadPoseDataset:
    """all_data_dict {seq_name: {"head_pose": (T, 7), ...}}; the sequences
    longer than 30 frames of the train (or test) split, by the dataset
    prefix of their name. An item is a window of ``window`` + 1 frames
    (zero-padded past a shorter sequence's end), augmented."""

    def __init__(self, all_data_dict: dict, train: bool, window: int = 120, for_eval: bool = False,
                 seed: int = 0):
        self.window = window
        self.train = train
        self.for_eval = for_eval
        self.all_data = all_data_dict
        self.rng = np.random.RandomState(seed)
        self.names = [name for name in all_data_dict
                      if all_data_dict[name]["head_pose"].shape[0] > 30
                      and (name.split("-")[0] in TRAIN_DATASETS) == train]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index: int) -> dict:
        seq_name = self.names[index]
        head_pose = np.asarray(self.all_data[seq_name]["head_pose"], np.float32)
        seq_len = head_pose.shape[0]
        if self.for_eval or seq_len - self.window - 1 <= 0:
            t0, t1 = 0, min(seq_len, self.window + 1)
        else:
            t0 = random.randint(0, seq_len - self.window - 2)
            t1 = t0 + self.window + 1
        window_pose = head_pose[t0:t1]
        aug = augment_head_traj(window_pose, self.rng)
        actual = window_pose.shape[0]
        if actual < self.window + 1:
            pad = self.window + 1 - actual
            window_pose = np.concatenate([window_pose, np.zeros((pad, 7), np.float32)])
            aug["head_rot_mat"] = np.concatenate([aug["head_rot_mat"], np.zeros((pad, 3, 3), np.float32)])
            aug["head_trans"] = np.concatenate([aug["head_trans"], np.zeros((pad, 3), np.float32)])
        return {
            "ori_head_pose": window_pose,
            "head_rot_mat": aug["head_rot_mat"],
            "head_trans": aug["head_trans"],
            "seq_len": actual,
            "seq_name": seq_name,
            "aligned_rot_mat": aug["aligned_rot_mat"],
            "aligned_scale": aug["aligned_scale"],
            "floor_normal": aug["floor_normal"],
        }

    def batch_iterator(self, batch_size: int, shuffle: bool = True):
        """Endless batches of ``batch_size`` items (numpy, stacked; no
        seq_name), each pass over a fresh permutation; a last partial batch
        of a pass is dropped."""
        n = len(self)
        while True:
            idx = self.rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                items = [self[j] for j in idx[i: i + batch_size]]
                yield {k: np.stack([it[k] for it in items]) for k in items[0] if k != "seq_name"}
