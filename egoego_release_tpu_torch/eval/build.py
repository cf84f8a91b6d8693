"""Build the stage-2 ``EgoEgoPipeline`` from checkpoint and model files
(port of the stage-2 part of egoego_release_tpu/eval/build.py)."""

from __future__ import annotations

import os

import numpy as np
import torch

from egoego_release_tpu_torch.data.formats import load_norm_stats
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    new_denoiser,
)
from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline
from egoego_release_tpu_torch.ops.fk import NUM_JOINTS, SMPL_PARENTS
from egoego_release_tpu_torch.utils.convert import load_denoiser_weights, load_stage2_diffusion_ckpt
from egoego_release_tpu_torch.utils.device import resolve_device


def rest_offsets_from_smplh_npz(path: str) -> np.ndarray:
    """The 22 rest bone offsets used by FK: zero-beta rest joints
    (J_regressor @ v_template) minus their parents', root offset 0."""
    data = np.load(path, allow_pickle=True)
    j_reg = data["J_regressor"]
    j_reg = j_reg.toarray() if hasattr(j_reg, "toarray") else np.asarray(j_reg)
    joints = (np.asarray(j_reg, np.float32) @ np.asarray(data["v_template"], np.float32))[:NUM_JOINTS]
    parents = SMPL_PARENTS.copy()
    parents[0] = 0
    return joints - joints[parents]


def load_rest_offsets(smplh_path: str | None, rest_offsets_path: str | None) -> np.ndarray:
    """From a pre-extracted (22, 3) npy, or the SMPL-H male model npz."""
    if rest_offsets_path and os.path.exists(rest_offsets_path):
        return np.load(rest_offsets_path).astype(np.float32)
    if smplh_path and os.path.exists(os.path.join(smplh_path, "male", "model.npz")):
        return rest_offsets_from_smplh_npz(os.path.join(smplh_path, "male", "model.npz"))
    raise FileNotFoundError(
        "Need the SMPL-H model npz (--smplh_path) or a pre-extracted rest-offsets npy "
        "(--rest_offsets).")


def build_pipeline(*, stats_path: str, smplh_path: str | None = None,
                   rest_offsets_path: str | None = None, diffusion_ckpt: str | None = None,
                   window: int = 120, sampler: str = "ddpm", ddim_steps: int = 50,
                   timesteps: int = 1000, compute_dtype: str = "bfloat16", seed: int = 0,
                   device="cuda") -> EgoEgoPipeline:
    """Stage-2 pipeline on ``device`` (the card unless device="cpu" is
    passed). Without a checkpoint the denoiser is random-init from ``seed``."""
    dev = resolve_device(device)
    cfg = DiffusionConfig(window=window, sampler=sampler, ddim_steps=ddim_steps,
                          timesteps=timesteps, compute_dtype=compute_dtype)
    model = None
    if diffusion_ckpt and os.path.isfile(diffusion_ckpt):
        sd, _ = load_stage2_diffusion_ckpt(diffusion_ckpt)
        model = load_denoiser_weights(new_denoiser(cfg), sd)
    elif diffusion_ckpt:
        raise FileNotFoundError(f"stage-2 checkpoint {diffusion_ckpt!r}: need a .pt file")
    else:
        print("WARNING: no stage-2 checkpoint; using random init")
    diffusion = CondGaussianDiffusion(cfg, device=dev, model=model, seed=seed)
    rest = load_rest_offsets(smplh_path, rest_offsets_path)
    return EgoEgoPipeline(diffusion=diffusion, stats=load_norm_stats(stats_path, device=dev),
                          rest_offsets=torch.as_tensor(rest, device=dev))
