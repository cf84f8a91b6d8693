"""Stage-2 learning check (port of tools/train_overfit_check.py): train the
release stage-2 model on the windows of the demo sequence, then sample it
conditioned on the ground-truth head (the canonical sliding-window chain on
the f32 step kernels), run FK and the metric suite, and compare the
MPJPE of the random-init weights with the trained EMA weights. It closes
train -> EMA -> canonical chain -> FK -> metrics on the card.

    python -m egoego_release_tpu_torch.tools.train_overfit_check [--device cpu] \\
        --demo demo_ares_data.p --stats cano_min_max_mean_std_data_window_120.p
    OVERFIT_STEPS=500 OVERFIT_BS=32 OVERFIT_ACCUM=2 OVERFIT_REMAT=1 python -m ...

Knobs (the JAX tool's): OVERFIT_STEPS (4000), OVERFIT_BS (micro-batch,
32), OVERFIT_ACCUM (2), OVERFIT_REMAT (0; 1 checkpoints the layers).
Randomness comes from seeded sources: the weights from
``torch.Generator`` seed 0, the batch order from RandomState(1), the
training noise from ``TorchNoise`` seed 3 and the sampler's from seed 2
(JAX's PRNGKeys 0-3 in the same roles).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from egoego_release_tpu_torch.data.amass import AMASSWindowDataset
from egoego_release_tpu_torch.data.formats import load_motion_dict
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig, NormStats
from egoego_release_tpu_torch.eval import metrics as metrics_mod
from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline, gt_from_smpl_params
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.tools._data import tool_rest_offsets
from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer
from egoego_release_tpu_torch.utils.device import resolve_device


def eval_mpjpe(cfg, model, stats, rest, rec, noise, device) -> float:
    """GT-head-conditioned sampling of the demo record (one sample, the
    canonical sliding-window chain), FK and the metric suite: the MPJPE in
    mm against the record's FK. ``model`` is the denoiser to sample;
    ``stats`` (the dataset's, on the host) go to ``device``."""
    pipe = EgoEgoPipeline(diffusion=CondGaussianDiffusion(cfg, device=device, model=model),
                          stats=NormStats(*(t.to(device) for t in stats)),
                          rest_offsets=torch.as_tensor(rest, device=device))
    gq, gp, head_pose = gt_from_smpl_params(pipe, rec["trans"], rec["root_orient"], rec["body_pose"])
    with torch.no_grad():
        aa, root = pipe.stage2_generate(head_pose, noise, sample_bs=1)
        pj_rot, pj_pos = pipe.fk(root, aa)
        t = min(pj_pos.shape[1], gp.shape[0])
        md = metrics_mod.compute_metrics_for_smpl(gq[:t], gp[:t], 0.0, pj_rot[0, :t], pj_pos[0, :t], 0.0)
    return float(md["mpjpe"])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--demo", required=True, help="the demo motion pickle (demo_ares_data.p)")
    p.add_argument("--stats", required=True, help="the min/max stats pickle of its windows")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    steps = int(os.environ.get("OVERFIT_STEPS", "4000"))
    bs = int(os.environ.get("OVERFIT_BS", "32"))
    accum = int(os.environ.get("OVERFIT_ACCUM", "2"))
    remat = os.environ.get("OVERFIT_REMAT", "0") == "1"
    rest = tool_rest_offsets()

    cfg = dataclasses.replace(DiffusionConfig(), remat=remat)
    trainer = DiffusionTrainer(CondGaussianDiffusion(cfg, device=dev), grad_accum=accum)
    state = trainer.init_state(torch.Generator().manual_seed(0))

    ds = AMASSWindowDataset(args.demo, rest, window=cfg.window, stats_path=args.stats)
    print(f"windows: {len(ds)}")
    batches = ds.batch_iterator(bs * accum, seed=1)
    rec = list(load_motion_dict(args.demo).values())[0]
    evaluate = lambda model: eval_mpjpe(cfg, model, ds.stats, rest, rec, TorchNoise(dev, seed=2), dev)

    mpjpe0 = evaluate(state.model)
    print(f"random-init MPJPE: {mpjpe0:.1f} mm", flush=True)

    t0 = time.time()
    noise = TorchNoise(dev, seed=3)
    for i in range(steps):
        state, loss = trainer.train_step(state, next(batches), noise)
        if (i + 1) % max(steps // 8, 1) == 0:
            print(f"step {i + 1}/{steps}: loss {float(loss):.5f}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    mpjpe1 = evaluate(state.ema)
    result = {
        "metric": "stage-2 end-to-end learning check (demo windows)",
        "steps": steps, "micro_bs": bs, "grad_accum": accum, "remat": remat,
        "train_seconds": round(dt, 1),
        "window_grads_per_sec": round(bs * accum * steps / dt, 1),
        "mpjpe_random_init_mm": round(mpjpe0, 2),
        "mpjpe_trained_mm": round(mpjpe1, 2),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
