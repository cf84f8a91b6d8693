"""GIMO VPoser-latent -> axis-angle pose extraction CLI (port of
egoego_release_tpu/preprocess/gimo_pose.py), on the card unless ``--device
cpu`` is given.

Walks ``<root>/<scene>/<seq>/smplx_local/*.pkl`` (per-frame dicts with
``latent`` (32,), ``trans`` (3,), ``orient`` (3,), ``beta`` (10,)), decodes
the latents to 21-joint axis-angle with the VPoser decoder
(``models/vposer.py``) and writes ``<dest>/<scene>/<seq>.npz`` with poses
(T, 21, 3), root_trans (T, 3), root_orient (T, 3) and beta (10,), the input
of the GIMO processing (JAX ``preprocess/ares.py --dataset gimo``). The
VPoser v1 snapshot is the user's licensed download (``--vposer_ckpt``).

    python -m egoego_release_tpu_torch.preprocess.gimo_pose \\
        --root <segmented_ori_data> --dest <out> --vposer_ckpt <snapshot.pt> [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from egoego_release_tpu_torch.models.vposer import VPoserDecoder, load_vposer_ckpt, vposer_decode
from egoego_release_tpu_torch.utils.device import resolve_device


def _frame_value(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32).reshape(-1)


def extract_sequence(smplx_folder: str, model: VPoserDecoder) -> dict | None:
    """Decode one ``smplx_local`` folder of per-frame pickles on the model's
    device; None if it holds none."""
    pkl_files = sorted(f for f in os.listdir(smplx_folder) if f.endswith(".pkl"))
    if not pkl_files:
        return None
    latents, trans, orients, beta = [], [], [], None
    for name in pkl_files:
        with open(os.path.join(smplx_folder, name), "rb") as f:
            rec = pickle.load(f)
        latents.append(_frame_value(rec["latent"])[:32])
        trans.append(_frame_value(rec["trans"])[:3])
        orients.append(_frame_value(rec["orient"])[:3])
        beta = _frame_value(rec["beta"])
    dev = next(model.parameters()).device
    poses = vposer_decode(model, torch.from_numpy(np.stack(latents)).to(dev), "aa").cpu().numpy()
    return {"poses": poses.astype(np.float32), "root_trans": np.stack(trans), "root_orient": np.stack(orients),
            "beta": beta}


def extract_all(root: str, dest: str, vposer_ckpt: str, device="cuda") -> int:
    """Every sequence under ``root`` -> one npz under ``dest``; returns the
    number written."""
    model = load_vposer_ckpt(vposer_ckpt, resolve_device(device))
    n = 0
    for scene in sorted(os.listdir(root)):
        scene_folder = os.path.join(root, scene)
        if not os.path.isdir(scene_folder):
            continue
        for seq in sorted(os.listdir(scene_folder)):
            smplx_folder = os.path.join(scene_folder, seq, "smplx_local")
            if not os.path.isdir(smplx_folder):
                continue
            rec = extract_sequence(smplx_folder, model)
            if rec is None:
                continue
            os.makedirs(os.path.join(dest, scene), exist_ok=True)
            np.savez(os.path.join(dest, scene, seq + ".npz"), **rec)
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="segmented_ori_data root")
    ap.add_argument("--dest", required=True, help="output npz root")
    ap.add_argument("--vposer_ckpt", required=True, help="VPoser v1 snapshot .pt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n = extract_all(args.root, args.dest, args.vposer_ckpt, args.device)
    print(f"extracted {n} sequences -> {args.dest}")
    return n


if __name__ == "__main__":
    main()
