"""Kinpoly expert-record dataset (StateAR format), host numpy copied from
egoego_release_tpu/data/kinpoly.py, so that both packages draw the same
windows in the same order for a seed (``random.Random(seed)``).

The reference's kinpoly/relive/data_loaders/statear_smpl_dataset.py
(StateARDataset): fr_num-frame windows of expert records (qpos, qvel, head
pose and velocities, object features) for TrajARNet-style training, from
the mocap_annotations.p pickles that ``preprocess.qpos`` writes (plain
pickles, or the reference's joblib files: ``data.formats.load_pickle``).
"""

from __future__ import annotations

import random

import numpy as np

from egoego_release_tpu_torch.data.formats import load_motion_dict

_KEYS = ("qpos", "qvel", "head_pose", "head_vels", "obj_pose",
         "obj_head_relative_poses")


class StateARDataset:
    def __init__(self, expert_path: str, fr_num: int = 90, train: bool = True,
                 seed: int = 0, takes: list[str] | None = None):
        """takes: optional take-name whitelist (the reference's dataset is
        built from cfg.takes[mode] — statear_smpl_dataset.py:31)."""
        self.fr_num = fr_num
        self.train = train
        self.rng = random.Random(seed)
        data = load_motion_dict(expert_path)
        wanted = set(takes) if takes is not None else None
        self.records = []
        for key, rec in data.items():
            name = rec.get("seq_name", str(key))
            if wanted is not None and name not in wanted and str(key) not in wanted:
                continue
            if rec["qpos"].shape[0] >= fr_num:
                self.records.append(rec)
        self.names = [rec.get("seq_name", str(i)) for i, rec in enumerate(self.records)]

    def __len__(self):
        return len(self.records)

    def sample_seq(self, index: int | None = None) -> dict:
        """One fr_num window (random crop in train, head crop in eval)."""
        if index is None:
            index = self.rng.randrange(len(self.records))
        rec = self.records[index]
        t_total = rec["qpos"].shape[0]
        t0 = self.rng.randint(0, t_total - self.fr_num) if self.train else 0
        out = {k: np.asarray(rec[k][t0 : t0 + self.fr_num], np.float32) for k in _KEYS
               if k in rec}
        # qvel has T-1 rows; pad the last like the reference's duplicated vel
        if out["qvel"].shape[0] < self.fr_num:
            out["qvel"] = np.concatenate([out["qvel"], out["qvel"][-1:]])
        out["seq_name"] = rec.get("seq_name", str(index))
        return out

    def iter_seq(self):
        for i in range(len(self.records)):
            yield self.sample_seq(i)

    def batch_iterator(self, batch_size: int):
        while True:
            items = [self.sample_seq() for _ in range(batch_size)]
            yield {
                k: np.stack([it[k] for it in items])
                for k in items[0] if k != "seq_name"
            }
