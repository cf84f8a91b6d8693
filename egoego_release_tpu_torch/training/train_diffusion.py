"""Stage-2 diffusion training CLI (port of
egoego_release_tpu/training/train_diffusion.py), on the card unless
``--device cpu`` is given.

AMASS window dataset -> DiffusionTrainer (Adam 1e-4, grad-accum 2, EMA,
NaN guard) with ``model-<step>.pt`` checkpoints under
``{save_dir}/{exp_name}/weights`` (auto-resume from the newest; checkpoint
and stop on SIGTERM or SIGINT), JSONL / wandb logging, an opt.yaml of the
run's settings, and an optional torch.profiler trace. ``--sample`` loads
the newest checkpoint's EMA weights and runs the DDPM reverse chain through
the f32 step kernels. ``parallel.dp`` / ``parallel.tp`` above 1 train on
dp x tp ranks (one process each, rank r on ``cuda:r``, or all on the CPU
with ``--device cpu``; dp 0 = the cards / tp, as JAX's mesh): each
micro-batch split over dp, the layers over tp (``DiffusionTrainer(mesh=)``),
the bank replicated; rank 0 logs and writes the (full-layout) checkpoints.

    python -m egoego_release_tpu_torch.training.train_diffusion \\
        --train_data_path train_amass_smplh_motion.p \\
        --set data.rest_offsets=rest.npy train.num_steps=10000 [--config cfg.yaml] [--device cpu]
    python -m egoego_release_tpu_torch.training.train_diffusion --sample --set ... [--ckpt model-N.pt]
"""

from __future__ import annotations

import argparse
import os
import re
import signal

import numpy as np
import torch

from egoego_release_tpu_torch.data.amass import AMASSWindowDataset
from egoego_release_tpu_torch.data.prefetch import prefetch_to_device
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    head_condition_mask,
    new_denoiser,
)
from egoego_release_tpu_torch.eval.build import load_rest_offsets
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.parallel.mesh import spawn
from egoego_release_tpu_torch.training.trainer_diffusion import (
    DiffusionTrainer,
    restore_state,
    save_checkpoint,
)
from egoego_release_tpu_torch.utils.config import load_config
from egoego_release_tpu_torch.utils.convert import load_denoiser_weights, load_stage2_diffusion_ckpt
from egoego_release_tpu_torch.utils.device import resolve_device
from egoego_release_tpu_torch.utils.logging import MetricLogger, profile_trace, save_run_config


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """Newest model-<step>.pt checkpoint in a weights dir, by step number."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"model-(\d+)\.pt", name)
        if m and (best is None or int(m[1]) > best[0]):
            best = (int(m[1]), os.path.join(ckpt_dir, name))
    return best[1] if best else None


def diffusion_config(s2) -> DiffusionConfig:
    """The stage-2 model of a config, in f32 (JAX trains and samples here
    without ``compute_dtype``)."""
    return DiffusionConfig(
        d_model=s2.d_model, n_dec_layers=s2.n_dec_layers, n_head=s2.n_head, d_k=s2.d_k, d_v=s2.d_v,
        window=s2.window, timesteps=s2.timesteps, objective=s2.objective,
        beta_schedule=s2.beta_schedule, loss_type=s2.loss_type, remat=s2.remat,
        compute_dtype="float32")


def _run_rank(mesh, cfg, train_data_path, device):
    run(cfg, train_data_path, device, mesh=mesh)


def run(cfg, train_data_path: str, device="cuda", mesh=None, devices=None):
    """Train; returns the final TrainState. With parallel.dp / parallel.tp
    above 1 and no ``mesh``, trains on dp x tp new ranks (rank r on
    ``devices[r]``; by default on ``device``: ``parallel.mesh.spawn``) and
    returns None."""
    par = cfg.parallel
    if (par.dp > 1 or par.tp > 1) and mesh is None:
        n_dev = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
        dp = par.dp or max(1, n_dev // par.tp)
        spawn(_run_rank, (cfg, train_data_path, device), dp, par.tp, devices or device)
        return None
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and cfg.data.batch_size % mesh.dp:
        raise ValueError(f"data.batch_size {cfg.data.batch_size} must be divisible by dp={mesh.dp}")
    rank0 = mesh is None or mesh.rank == 0
    save_dir = os.path.join(cfg.logging.save_dir, cfg.logging.exp_name)
    logger = None
    if rank0:
        save_run_config(cfg, save_dir)
        logger = MetricLogger(save_dir, cfg.logging.use_wandb, cfg.logging.wandb_project, cfg.logging.exp_name)

    rest = load_rest_offsets(cfg.data.smplh_path or None, cfg.data.rest_offsets or None)
    ds = AMASSWindowDataset(train_data_path, rest, window=cfg.data.window,
                            canonicalize_init_head=cfg.data.canonicalize_init_head,
                            stats_path=cfg.data.stats_path or None)
    print(f"training windows: {len(ds)}")

    t = cfg.train
    trainer = DiffusionTrainer(
        CondGaussianDiffusion(diffusion_config(cfg.stage2), device=dev), lr=t.learning_rate,
        grad_accum=t.grad_accum, ema_decay=t.ema_decay, ema_update_every=t.ema_update_every,
        ema_step_start=t.ema_step_start, mesh=mesh)
    noise = TorchNoise(dev, seed=t.seed)
    ckpt_dir = os.path.join(save_dir, "weights")
    latest = latest_checkpoint(ckpt_dir)
    if t.resume and latest:
        # the newest model-<step>, as the reference picks the latest
        # checkpoint (trainer_amass_cond_motion_diffusion.py:233-242)
        state = restore_state(latest, trainer)
        print(f"resumed from {latest} at step {state.step}")
    else:
        state = trainer.init_state(torch.Generator().manual_seed(t.seed))

    # preemption safety: SIGTERM / SIGINT checkpoint and stop
    stopped = []

    def _handler(signum, frame):
        print(f"signal {signum}: checkpointing and stopping")
        stopped.append(signum)

    old_handlers = {s: signal.signal(s, _handler) for s in (signal.SIGTERM, signal.SIGINT)}
    n_batch = cfg.data.batch_size * t.grad_accum
    loop = dict(log_every=cfg.logging.log_every, ckpt_dir=ckpt_dir, save_every=t.save_every, logger=logger,
                stop=lambda: bool(stopped))
    try:
        with profile_trace(cfg.logging.profile_dir or None):
            if cfg.data.device_resident:
                # the window bank lives on the device; each step gathers its batch there
                bank, seq_lens = ds.materialize_windows()
                state, _ = trainer.fit_device(state, bank, seq_lens, t.num_steps, n_batch, noise, **loop)
            else:
                batches = ds.batch_iterator(n_batch, seed=t.seed)
                if cfg.data.prefetch > 0:
                    batches = prefetch_to_device(batches, prefetch=cfg.data.prefetch, device=dev)
                state, _ = trainer.fit(state, batches, t.num_steps, noise, **loop)
        save_checkpoint(ckpt_dir, state)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if logger is not None:
            logger.close()
    return state


def run_sample(cfg, ckpt_path: str | None = None, num_samples: int = 4, device="cuda") -> torch.Tensor:
    """Sampling mode: the EMA weights of the newest checkpoint (or
    ``ckpt_path``), the DDPM reverse chain on the f32 step kernels,
    ``num_samples`` windows saved to ``{save_dir}/{exp_name}/samples.npz``
    (the reference Trainer's cond_sample_res path,
    trainer_amass_cond_motion_diffusion.py:232-260)."""
    dev = resolve_device(device)
    save_dir = os.path.join(cfg.logging.save_dir, cfg.logging.exp_name)
    if ckpt_path is None:
        ckpt_path = latest_checkpoint(os.path.join(save_dir, "weights"))
        if ckpt_path is None:
            raise FileNotFoundError(f"no checkpoints under {save_dir}/weights")
    print("sampling from:", ckpt_path)
    sd, step = load_stage2_diffusion_ckpt(ckpt_path)
    dcfg = diffusion_config(cfg.stage2)
    diffusion = CondGaussianDiffusion(dcfg, device=dev, model=load_denoiser_weights(new_denoiser(dcfg), sd))
    x_start = torch.zeros(num_samples, dcfg.window, dcfg.d_feats, device=dev)
    out = diffusion.p_sample_loop(x_start, head_condition_mask(num_samples, dcfg.window, device=dev),
                                  noise=TorchNoise(dev, seed=cfg.train.seed))
    out_path = os.path.join(save_dir, "samples.npz")
    np.savez(out_path, samples=out.cpu().numpy(), step=step)
    print(f"saved {num_samples} samples -> {out_path}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--train_data_path", default=None)
    p.add_argument("--sample", action="store_true",
                   help="sampling mode: load the latest checkpoint and generate")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--set", nargs="*", default=[], help="dotted overrides a.b=c")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, overrides=args.set)
    if args.sample:
        return run_sample(cfg, args.ckpt, device=args.device)
    if not args.train_data_path:
        p.error("--train_data_path is required for training mode")
    return run(cfg, args.train_data_path, device=args.device)


if __name__ == "__main__":
    main()
