"""AMASS window dataset for stage-2 training (port of
egoego_release_tpu/data/amass.py).

Cuts each motion sequence into ``window``-frame windows (stride window // 2,
windows under 30 frames skipped), turns each into the 198-d global
representation (22 joint positions + 22 global 6d rotations) by FK,
optionally canonicalizing each window's initial head heading, and
normalizes the joint positions to [-1, 1] by min/max stats.

Windows of equal length go through ``process_window_data``'s math as one
batch on the CPU; items, batches and the window bank are numpy.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from egoego_release_tpu_torch.data import formats
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import NormStats
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import heading
from egoego_release_tpu_torch.ops import rotations as rot

HEAD_IDX = fk_mod.HEAD_IDX


def process_windows(root_trans: torch.Tensor, root_orient: torch.Tensor, pose_body: torch.Tensor,
                    rest_offsets: torch.Tensor, canonicalize_init_head: bool = True) -> dict:
    """N windows of T frames at once: root_trans (N, T, 3), root_orient
    (N, T, 3) and pose_body (N, T, 21, 3) axis-angle -> global_jpos and
    global_jvel (N, T, 22, 3), global_rot_6d and local_rot_6d (N, T, 22, 6)."""
    local_mat = rot.axis_angle_to_matrix(torch.cat([root_orient[:, :, None], pose_body], dim=2))
    global_mat = fk_mod.local_to_global_matrix(local_mat)

    if canonicalize_init_head:
        head_quat = rot.matrix_to_quat(global_mat[:, :, HEAD_IDX])
        use_trans, _, recover = heading.rotate_at_frame(root_trans, head_quat, cano_t_idx=0)
        recover_q = recover[:, 0, 0]  # (N, 4)
        root_quat = rot.matrix_to_quat(local_mat[:, :, 0])
        cano_root_quat = rot.quat_multiply(rot.quat_invert(recover_q)[:, None], root_quat)
        local_mat = torch.cat([rot.quat_to_matrix(cano_root_quat)[:, :, None], local_mat[:, :, 1:]], dim=2)
        global_mat = fk_mod.local_to_global_matrix(local_mat)
    else:
        use_trans = root_trans

    _, jnts = fk_mod.fk_from_local_quat(rot.matrix_to_quat(local_mat), rest_offsets)
    jnts = jnts + use_trans[:, :, None, :]
    # zero the initial head xy (amass_diffusion_dataset.py:454-459)
    move0 = jnts[:, 0:1, HEAD_IDX, :] * jnts.new_tensor([1.0, 1.0, 0.0])
    global_jpos = jnts - move0[:, :, None, :]
    global_jvel = torch.cat([global_jpos[:, 1:] - global_jpos[:, :-1],
                             global_jpos.new_zeros(global_jpos.shape[0], 1, 22, 3)], dim=1)
    return {
        "local_rot_6d": rot.matrix_to_rot6d(local_mat),
        "global_jpos": global_jpos,
        "global_jvel": global_jvel,
        "global_rot_6d": rot.matrix_to_rot6d(global_mat),
    }


def process_window_data(root_trans, root_orient, pose_body, rest_offsets,
                        canonicalize_init_head: bool = True) -> dict:
    """One window, (T, 3), (T, 3), (T, 21, 3) -> the dict of
    ``process_windows`` without the leading axis."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None]
    out = process_windows(t(root_trans), t(root_orient), t(pose_body),
                          torch.as_tensor(np.asarray(rest_offsets, np.float32)), canonicalize_init_head)
    return {k: v[0] for k, v in out.items()}


class AMASSWindowDataset:
    """Windows + normalization over a reference-format AMASS motion pickle."""

    def __init__(self, data_path: str, rest_offsets, window: int = 120,
                 canonicalize_init_head: bool = True, stats_path: str | None = None,
                 min_window_len: int = 30):
        self.window = window
        self.rest_offsets = torch.as_tensor(np.asarray(rest_offsets, np.float32))
        self.canonicalize_init_head = canonicalize_init_head
        data_dict = formats.load_motion_dict(data_path)

        # windowing: stride window // 2, skip segments < min_window_len
        # (amass_diffusion_dataset.py:316-353)
        spans = []
        for idx in data_dict:
            rec = data_dict[idx]
            seq = tuple(np.asarray(rec[k], np.float32) for k in ("trans", "root_orient", "body_pose"))
            num_steps = seq[0].shape[0]
            for start in range(0, num_steps, window // 2):
                end = min(start + window - 1, num_steps)
                if end - start < min_window_len:
                    continue
                spans.append((rec.get("seq_name", str(idx)), start, end, seq))

        self.windows: list[dict] = [None] * len(spans)
        by_len: dict[int, list[int]] = {}
        for i, (_, start, end, seq) in enumerate(spans):
            by_len.setdefault(min(end + 1, seq[0].shape[0]) - start, []).append(i)
        for ids in by_len.values():
            cut = lambda j: np.stack([spans[i][3][j][spans[i][1]: spans[i][2] + 1] for i in ids])
            q = process_windows(torch.from_numpy(cut(0)), torch.from_numpy(cut(1)),
                                torch.from_numpy(cut(2)).reshape(len(ids), -1, 21, 3),
                                self.rest_offsets, canonicalize_init_head)
            for n, i in enumerate(ids):
                name, start, end, _ = spans[i]
                self.windows[i] = {
                    "seq_name": name,
                    "start_t_idx": start,
                    "end_t_idx": end,
                    "global_jpos": q["global_jpos"][n].reshape(-1, 66).numpy(),
                    "global_jvel": q["global_jvel"][n].reshape(-1, 66).numpy(),
                    "global_rot_6d": q["global_rot_6d"][n].reshape(-1, 132).numpy(),
                }

        # stats (amass_diffusion_dataset.py:355-377): written as a plain
        # pickle of numpy arrays, which joblib.load reads too
        if stats_path is not None and os.path.exists(stats_path):
            self.stats = formats.load_norm_stats(stats_path)
        else:
            stats = self._stats_dict()
            self.stats = NormStats(jpos_min=torch.from_numpy(stats["global_jpos_min"].reshape(22, 3)),
                                   jpos_max=torch.from_numpy(stats["global_jpos_max"].reshape(22, 3)))
            if stats_path is not None:
                with open(stats_path, "wb") as f:
                    pickle.dump(stats, f)

    def _stats_dict(self) -> dict:
        jpos = np.concatenate([w["global_jpos"] for w in self.windows]).reshape(-1, 66)
        jvel = np.concatenate([w["global_jvel"] for w in self.windows]).reshape(-1, 66)
        return {
            "global_jpos_min": jpos.min(axis=0),
            "global_jpos_max": jpos.max(axis=0),
            "global_jvel_min": jvel.min(axis=0),
            "global_jvel_max": jvel.max(axis=0),
        }

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, index: int) -> dict:
        """motion (window, 198) normalized and zero-padded; seq_len
        (amass_diffusion_dataset.py:515-538)."""
        w = self.windows[index]
        jpos_min = self.stats.jpos_min.numpy()
        jpos_max = self.stats.jpos_max.numpy()
        jpos = w["global_jpos"].reshape(-1, 22, 3)
        jpos = (jpos - jpos_min) / (jpos_max - jpos_min) * 2.0 - 1.0
        motion = np.concatenate([jpos.reshape(-1, 66), w["global_rot_6d"]], axis=-1).astype(np.float32)
        seq_len = motion.shape[0]
        if seq_len < self.window:
            motion = np.concatenate(
                [motion, np.zeros((self.window - seq_len, motion.shape[1]), np.float32)])
        return {"motion": motion, "seq_len": seq_len}

    def materialize_windows(self) -> tuple[np.ndarray, np.ndarray]:
        """Every window as one (N, window, 198) f32 array and seq_len (N,):
        the bank the device-resident training path uploads once
        (DiffusionTrainer.fit_device). A window is ~95 KB in f32."""
        items = [self[i] for i in range(len(self))]
        return (np.stack([it["motion"] for it in items]),
                np.asarray([it["seq_len"] for it in items], np.int32))

    def batch_iterator(self, batch_size: int, seed: int, shuffle: bool = True):
        """Infinite batches of stacked numpy arrays, shuffled by
        ``np.random.RandomState(seed)`` (the JAX package draws that seed
        from its key; the reference cycles its DataLoader)."""
        rng = np.random.RandomState(seed)
        n = len(self)
        if n == 0:
            raise ValueError("empty dataset")
        while True:
            if n < batch_size:
                # small datasets: sample with replacement rather than spinning
                idx = rng.randint(0, n, size=batch_size)
            else:
                idx = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, max(len(idx) - batch_size + 1, 1), batch_size):
                items = [self[j] for j in idx[i: i + batch_size]]
                yield {
                    "motion": np.stack([it["motion"] for it in items]),
                    "seq_len": np.asarray([it["seq_len"] for it in items], np.int32),
                }
