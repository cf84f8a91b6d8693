"""Build the ``EgoEgoPipeline`` (stage 2, and the stage-1 HeadNet and
GravityNet) from checkpoint and model files (port of
egoego_release_tpu/eval/build.py). Released ``.pt`` files load directly;
the JAX package's orbax checkpoint directories are not read here."""

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
from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline, check_of_upload
from egoego_release_tpu_torch.models.denoiser import init_weights_
from egoego_release_tpu_torch.models.gravitynet import HeadNormalFormer
from egoego_release_tpu_torch.models.headnet import HeadFormer
from egoego_release_tpu_torch.ops.smpl import load_smpl_npz, rest_offsets_22
from egoego_release_tpu_torch.utils.convert import (
    load_denoiser_weights,
    load_stage1_ckpt,
    load_stage2_diffusion_ckpt,
)
from egoego_release_tpu_torch.utils.device import resolve_device


def rest_offsets_from_smplh_npz(path: str) -> np.ndarray:
    """The 22 rest bone offsets used by FK, from a SMPL-H model npz
    (``ops.smpl.rest_offsets_22``)."""
    return rest_offsets_22(load_smpl_npz(path)).numpy()


def load_rest_offsets(smplh_path: str | None, rest_offsets_path: str | None) -> np.ndarray:
    """From a pre-extracted (22, 3) npy, or the SMPL-H male model npz."""
    if rest_offsets_path and os.path.exists(rest_offsets_path):
        return np.load(rest_offsets_path).astype(np.float32)
    if smplh_path and os.path.exists(os.path.join(smplh_path, "male", "model.npz")):
        return rest_offsets_from_smplh_npz(os.path.join(smplh_path, "male", "model.npz"))
    raise FileNotFoundError(
        "Need the SMPL-H model npz (--smplh_path) or a pre-extracted rest-offsets npy "
        "(--rest_offsets).")


def _stage1_model(model, kind: str, ckpt: str | None, n_layers: int, seed: int, **dims):
    """A stage-1 model from a released .pt, or random-init from ``seed``."""
    if ckpt and os.path.isdir(ckpt):
        raise NotImplementedError(f"{kind} checkpoint {ckpt!r}: orbax directories are not read by "
                                  "the PyTorch package (see ROADMAP.md); pass the released .pt")
    if ckpt and os.path.isfile(ckpt):
        return load_denoiser_weights(model, load_stage1_ckpt(ckpt, kind, n_layers, **dims))
    if ckpt:
        raise FileNotFoundError(f"{kind} checkpoint {ckpt!r} not found")
    print(f"WARNING: no {kind} checkpoint; using random init")
    return init_weights_(model, torch.Generator().manual_seed(seed))


def build_pipeline(*, stats_path: str, smplh_path: str | None = None,
                   rest_offsets_path: str | None = None, diffusion_ckpt: str | None = None,
                   headnet_ckpt: str | None = None, gravitynet_ckpt: str | None = None,
                   window: int = 120, headnet_window: int = 60, headnet_d_model: int = 256,
                   headnet_layers: int = 2, gravitynet_window: int = 120,
                   gravitynet_d_model: int = 256, gravitynet_layers: int = 2, n_head: int = 4,
                   d_k: int = 256, d_v: int = 256, sampler: str = "ddpm", ddim_steps: int = 50,
                   timesteps: int = 1000, compute_dtype: str = "float32",
                   fused_transformer: bool = False, sample_microbatch: int = 0, of_bf16: bool = False,
                   of_int8: bool = False, seed: int = 0, device="cuda") -> EgoEgoPipeline:
    """The pipeline on ``device`` (the card unless device="cpu" is passed).
    Models without a checkpoint are random-init: the denoiser from ``seed``,
    HeadNet from ``seed + 1`` and GravityNet from ``seed + 2``, as in JAX.
    The step kernels compute in ``compute_dtype``: f32 by default, as JAX's
    ``DiffusionConfig`` (its CLIs' default numerics); "bfloat16" is what the
    CLIs' ``--fused_step`` selects. ``fused_transformer`` selects the
    ``--fused`` denoiser path (bf16 layers whatever ``compute_dtype``),
    ``sample_microbatch`` the chunk of the reverse chain, and ``of_bf16`` /
    ``of_int8`` the batched stage 1's OF upload; asking for both raises
    ValueError before any model is built."""
    check_of_upload(of_bf16, of_int8)
    dev = resolve_device(device)
    cfg = DiffusionConfig(window=window, sampler=sampler, ddim_steps=ddim_steps,
                          timesteps=timesteps, compute_dtype=compute_dtype,
                          fused_transformer=fused_transformer, sample_microbatch=sample_microbatch)
    model = None
    if diffusion_ckpt and os.path.isfile(diffusion_ckpt):
        sd, _ = load_stage2_diffusion_ckpt(diffusion_ckpt)
        model = load_denoiser_weights(new_denoiser(cfg), sd)
    elif diffusion_ckpt:
        raise FileNotFoundError(f"stage-2 checkpoint {diffusion_ckpt!r}: need a .pt file")
    else:
        print("WARNING: no stage-2 checkpoint; using random init")
    diffusion = CondGaussianDiffusion(cfg, device=dev, model=model, seed=seed)
    headnet = _stage1_model(
        HeadFormer(d_model=headnet_d_model, n_layers=headnet_layers, n_head=n_head, d_k=d_k, d_v=d_v,
                   window=headnet_window),
        "headnet", headnet_ckpt, headnet_layers, seed + 1,
        d_model=headnet_d_model, n_head=n_head, d_k=d_k, d_v=d_v)
    gravitynet = _stage1_model(
        HeadNormalFormer(d_model=gravitynet_d_model, n_layers=gravitynet_layers, n_head=n_head, d_k=d_k,
                         d_v=d_v, window=gravitynet_window),
        "gravitynet", gravitynet_ckpt, gravitynet_layers, seed + 2,
        d_model=gravitynet_d_model, n_head=n_head, d_k=d_k, d_v=d_v)
    rest = load_rest_offsets(smplh_path, rest_offsets_path)
    return EgoEgoPipeline(diffusion=diffusion, stats=load_norm_stats(stats_path, device=dev),
                          rest_offsets=torch.as_tensor(rest, device=dev),
                          headnet=headnet.to(dev).eval(), gravitynet=gravitynet.to(dev).eval(),
                          of_bf16=of_bf16, of_int8=of_int8)
