"""Loaders for the reference's on-disk formats: the motion pickles ({index:
record} with trans (T,3), root_orient (T,3), body_pose (T,63), seq_name,
...), the min/max normalization stats pickle, DROID-SLAM trajectories
((T, 7) npy, trans + quat wxyz), the per-frame optical-flow feature npys
and the raw flow npys (loaders copied from
egoego_release_tpu/data/formats.py; the features through the native
loader, as there).

The reference writes these files with joblib, which stores numpy arrays as
raw bytes between pickle opcodes. ``load_pickle`` reads both that layout
(uncompressed) and plain pickles with the standard library and numpy, so
the port needs no joblib.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from egoego_release_tpu_torch.data.native_loader import load_npy_batch
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import NormStats
from egoego_release_tpu_torch.ops.rotations import quat_to_matrix_np


class _ArrayWrapper:
    """Stands in for joblib.numpy_pickle.NumpyArrayWrapper: the metadata
    (shape, order, dtype, alignment) of the array bytes that follow it."""


class _Unpickler(pickle._Unpickler):
    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, fh):
        super().__init__(fh)
        self._fh = fh

    def find_class(self, module, name):
        if module == "joblib.numpy_pickle" and name == "NumpyArrayWrapper":
            return _ArrayWrapper
        return super().find_class(module, name)

    def load_build(self):
        super().load_build()
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self._read_array(self.stack.pop()))

    dispatch[pickle.BUILD[0]] = load_build

    def _read_array(self, w: _ArrayWrapper) -> np.ndarray:
        dtype = np.dtype(w.dtype)
        if dtype.hasobject:
            return pickle.load(self._fh)
        if getattr(w, "numpy_array_alignment_bytes", None) is not None:
            self._fh.read(self._fh.read(1)[0])
        count = int(np.prod(w.shape, dtype=np.int64))
        data = self._fh.read(count * dtype.itemsize)
        if len(data) != count * dtype.itemsize:
            raise ValueError("truncated array data in pickle")
        a = np.frombuffer(data, dtype=dtype, count=count).copy()
        a = a.reshape(w.shape[::-1]).T if w.order == "F" else a.reshape(w.shape)
        if not a.dtype.isnative:
            a = a.byteswap().view(a.dtype.newbyteorder("="))
        return a


def load_pickle(path: str):
    """A plain pickle or an uncompressed joblib file."""
    with open(path, "rb") as fh:
        if fh.read(1) != b"\x80":
            raise ValueError(f"{path}: not a pickle (compressed joblib files are not supported)")
        fh.seek(0)
        return _Unpickler(fh).load()


def load_motion_dict(path: str) -> dict:
    """Load a reference-format motion pickle ({index: record})."""
    return load_pickle(path)


def load_norm_stats(path: str, device="cpu") -> NormStats:
    """Load min/max stats (cano_min_max_mean_std_data_window_120.p)."""
    d = load_pickle(path)
    r = lambda k: torch.as_tensor(np.asarray(d[k], np.float32).reshape(22, 3), device=device)
    return NormStats(jpos_min=r("global_jpos_min"), jpos_max=r("global_jpos_max"))


def load_droidslam(path: str):
    """(T, 7) npy -> (trans (T, 3), rot_mat (T, 3, 3), quat wxyz (T, 4))."""
    data = np.load(path)
    trans = data[:, :3].astype(np.float32)
    quat = data[:, 3:].astype(np.float32)
    return trans, quat_to_matrix_np(quat), quat


def load_of_feats(of_files: list[str], rewrite: tuple[str, str] | None = None,
                  feat_dim: int = 512) -> np.ndarray:
    """Stack per-frame optical-flow feature npys -> (T, feat_dim) f32.
    ``rewrite`` maps the absolute paths stored in the pickles onto the local
    data root; flow paths (raft_flows) are read as feature paths
    (raft_of_feats). Read by the native multithreaded loader
    (data/native_loader.py), or numpy where it is missing."""
    paths = []
    for f in of_files:
        if rewrite is not None:
            f = f.replace(rewrite[0], rewrite[1])
        paths.append(f.replace("raft_flows", "raft_of_feats"))
    return load_npy_batch(paths, feat_dim)


def load_raw_flows(of_files: list[str], rewrite: tuple[str, str] | None = None, augment=None) -> np.ndarray:
    """Stack per-frame RAW optical-flow npys -> (T, H, W, 2) f32, the
    raw-flow HeadNet's input; ``augment`` is an optional per-frame callable
    (``headpose.augment_flow`` when training), applied before the stack and
    the cast. Read by ``np.load``: the native loader takes feature vectors."""
    flows = []
    for f in of_files:
        if rewrite is not None:
            f = f.replace(rewrite[0], rewrite[1])
        flow = np.load(f)
        if augment is not None:
            flow = augment(flow)
        flows.append(flow)
    return np.stack(flows).astype(np.float32)


def find_slam_npy(slam_res_folder: str, seq_name: str) -> str | None:
    """seq_name 'scene-rest-of-name' -> {folder}/{scene}/{rest}.npy, or None."""
    scene = seq_name.split("-")[0]
    path = os.path.join(slam_res_folder, scene, "-".join(seq_name.split("-")[1:]) + ".npy")
    return path if os.path.exists(path) else None
