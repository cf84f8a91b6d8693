"""Full-system capability check on the demo sequence (port of
tools/train_full_system_check.py): train all three models from scratch on
it (HeadNet: OF features -> head orientation and distance; GravityNet:
the SLAM trajectory -> floor normal and scale; the stage-2 diffusion
model), then drive the whole ``run_egoego`` flow with the trained weights:
stage 1 -> gravity alignment -> the canonical sliding-window chain (the f32
step kernels) -> FK -> floor -> the metric suite. Four conditioning regimes
isolate each error source:

  stage1_random   untrained stage 1 -> stage 2           (the floor)
  stage1_trained  the trained system                     (the headline)
  gt_record_head  the record's head pose -> stage 2      (stage-1 error removed)
  gt_fk_head      the FK-derived head pose -> stage 2    (the skeleton mismatch
                                                          removed too)

    python -m egoego_release_tpu_torch.tools.train_full_system_check [--device cpu] \\
        --demo_root <dir of demo_ares_data.p and droid_slam_res/> --stats <stats.p>
    FULLSYS_S2_STEPS=2000 FULLSYS_S1_STEPS=800 python -m ...

Knobs (the JAX tool's): FULLSYS_S1_STEPS (1200), FULLSYS_S1_BS (16),
FULLSYS_S2_STEPS (4000), FULLSYS_S2_BS (32), FULLSYS_S2_ACCUM (2),
FULLSYS_SAVE (a directory for the trained weights as .pt files:
headnet.pt and gravitynet.pt in the reference's stage-1 layout, which
``eval_egoego --headnet_ckpt / --gravitynet_ckpt`` read, and stage2_ema.pt
in its stage-2 layout), FULLSYS_TINY (1: small widths, a CPU plumbing run).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from egoego_release_tpu_torch.data.amass import AMASSWindowDataset
from egoego_release_tpu_torch.data.amass_headpose import AMASSHeadPoseDataset
from egoego_release_tpu_torch.data.formats import load_motion_dict
from egoego_release_tpu_torch.data.headpose import ARESDemoDataset
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig, NormStats
from egoego_release_tpu_torch.eval.pipeline import (
    EgoEgoPipeline,
    evaluate_sequence,
    gt_from_smpl_params,
    stage1_metrics,
)
from egoego_release_tpu_torch.models.gravitynet import HeadNormalFormer
from egoego_release_tpu_torch.models.headnet import HeadFormer
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.tools._data import tool_rest_offsets
from egoego_release_tpu_torch.training.train_stage1 import stage1_model
from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer
from egoego_release_tpu_torch.training.trainer_stage1 import (
    Stage1Trainer,
    gravitynet_loss_fn,
    headnet_loss_fn,
    make_optimizer,
)
from egoego_release_tpu_torch.utils.config import Stage1ModelConfig, load_config
from egoego_release_tpu_torch.utils.device import resolve_device

TINY = dict(d_model=64, n_dec_layers=1, n_head=2, d_k=32, d_v=32)


def headnet_batch(of, head_pose, head_vels, window: int, bs: int, rng: np.random.RandomState) -> dict:
    """One HeadNet batch of ``bs`` random window crops of the sequence
    (trainer_head_estimation.py's training batch), the starts drawn from
    ``rng`` as the JAX tool draws them."""
    starts = rng.randint(0, of.shape[0] - window + 1, size=bs)
    return {"of": np.stack([of[s:s + window] for s in starts]),
            "head_pose": np.stack([head_pose[s:s + window + 1] for s in starts]),
            "head_vels": np.stack([head_vels[s:s + window] for s in starts]),
            "seq_len": np.full((bs,), window, np.float32)}


def train_headnet(cfg, rec, steps, bs, noise, device):
    """Overfit HeadFormer on random window crops of the demo sequence. Returns
    the trained model (in eval mode)."""
    m = cfg.headnet
    trainer = Stage1Trainer(headnet_loss_fn, make_optimizer(cfg.train.learning_rate,
                                                            step_size_epochs=max(steps // 2, 1)))
    state = trainer.init_state(stage1_model(HeadFormer, m, 0, device))
    of = np.asarray(rec["of"], np.float32)                # (T, 512)
    head_pose = np.asarray(rec["head_pose"], np.float32)  # (T+1, 7)
    head_vels = np.asarray(rec["head_vels"], np.float32)  # (T, 6)
    rng = np.random.RandomState(0)
    t0 = time.time()
    for i in range(steps):
        state, loss, _ = trainer.train_step(state, headnet_batch(of, head_pose, head_vels, m.window, bs, rng), noise)
        if (i + 1) % max(steps // 4, 1) == 0:
            print(f"headnet step {i + 1}/{steps}: loss {float(loss):.5f}", flush=True)
    print(f"headnet trained in {time.time() - t0:.1f}s", flush=True)
    return state.model.eval()


def train_gravitynet(cfg, rec, steps, bs, noise, device):
    """Overfit HeadNormalFormer on the rotation / scale augmentations of the
    demo head trajectory (amass_headpose_dataset.py). Returns the trained
    model (in eval mode)."""
    m = cfg.gravitynet
    trainer = Stage1Trainer(gravitynet_loss_fn, make_optimizer(cfg.train.learning_rate,
                                                               step_size_epochs=max(steps // 2, 1)))
    state = trainer.init_state(stage1_model(HeadNormalFormer, m, 0, device))
    # a "CMU-" name puts the sequence in the train split (amass_headpose.TRAIN_DATASETS)
    ds = AMASSHeadPoseDataset({"CMU-demo": {"head_pose": np.asarray(rec["head_pose"], np.float32)}},
                              train=True, window=m.window)
    assert len(ds) == 1
    batches = ds.batch_iterator(1)
    t0 = time.time()
    for i in range(steps):
        items = [next(batches) for _ in range(bs)]
        state, loss, _ = trainer.train_step(state, {k: np.concatenate([it[k] for it in items]) for k in items[0]},
                                            noise)
        if (i + 1) % max(steps // 4, 1) == 0:
            print(f"gravitynet step {i + 1}/{steps}: loss {float(loss):.5f}", flush=True)
    print(f"gravitynet trained in {time.time() - t0:.1f}s", flush=True)
    return state.model.eval()


def train_stage2(cfg_diff, ds, steps, bs, accum, noise, device):
    """Stage 2 on the demo windows; returns (the trainer's diffusion config
    with the EMA weights as its model, the final TrainState)."""
    trainer = DiffusionTrainer(CondGaussianDiffusion(cfg_diff, device=device), grad_accum=accum)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batches = ds.batch_iterator(bs * accum, seed=1)
    t0 = time.time()
    for i in range(steps):
        state, loss = trainer.train_step(state, next(batches), noise)
        if (i + 1) % max(steps // 4, 1) == 0:
            print(f"stage2 step {i + 1}/{steps}: loss {float(loss):.5f}", flush=True)
    print(f"stage2 trained in {time.time() - t0:.1f}s", flush=True)
    return CondGaussianDiffusion(cfg_diff, device=device, model=state.ema), state


def save_weights(save_dir: str, headnet, gravitynet, s2_state) -> None:
    """FULLSYS_SAVE: the trained weights as .pt (the JAX tool writes orbax)."""
    os.makedirs(save_dir, exist_ok=True)
    cpu = lambda module, prefix="": {prefix + k: v.detach().cpu() for k, v in module.state_dict().items()}
    for name, model in (("headnet", headnet), ("gravitynet", gravitynet)):
        torch.save({"transformer_encoder_state_dict": cpu(model), "epoch": 0}, os.path.join(save_dir, f"{name}.pt"))
    torch.save({"step": s2_state.step, "model": cpu(s2_state.model, "denoise_fn."),
                "ema": cpu(s2_state.ema, "ema_model.denoise_fn.")}, os.path.join(save_dir, "stage2_ema.pt"))
    print(f"saved trained params under {save_dir}", flush=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--demo_root", required=True,
                   help="the directory of demo_ares_data.p, its OF features and droid_slam_res/")
    p.add_argument("--stats", required=True, help="the min/max stats pickle of the demo's windows")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    s1_steps = int(os.environ.get("FULLSYS_S1_STEPS", "1200"))
    s1_bs = int(os.environ.get("FULLSYS_S1_BS", "16"))
    s2_steps = int(os.environ.get("FULLSYS_S2_STEPS", "4000"))
    s2_bs = int(os.environ.get("FULLSYS_S2_BS", "32"))
    s2_accum = int(os.environ.get("FULLSYS_S2_ACCUM", "2"))
    save_dir = os.environ.get("FULLSYS_SAVE", "")
    tiny = os.environ.get("FULLSYS_TINY", "0") == "1"  # CPU plumbing run

    cfg = load_config(None)
    cfg_diff = DiffusionConfig()
    if tiny:
        cfg = dataclasses.replace(cfg, headnet=Stage1ModelConfig(window=30, **TINY),
                                  gravitynet=Stage1ModelConfig(window=40, **TINY))
        # two layers: the step kernels' chain has a first and a last layer (JAX's flax path takes one)
        cfg_diff = DiffusionConfig(window=60, timesteps=8, **dict(TINY, n_dec_layers=2))
    demo_path = os.path.join(args.demo_root, "demo_ares_data.p")
    rec = ARESDemoDataset(args.demo_root)[0]  # the whole-sequence eval record (of, head_pose, SLAM fields)
    # GT body motion and its FK through the shared synthetic skeleton (the
    # SMPL assets are licence-gated): GT and prediction decode alike
    rest = tool_rest_offsets()
    motion = list(load_motion_dict(demo_path).values())[0]
    ds2 = AMASSWindowDataset(demo_path, rest, window=cfg_diff.window, stats_path=args.stats)

    # -- train all three models --------------------------------------------
    headnet = train_headnet(cfg, rec, s1_steps, s1_bs, TorchNoise(dev, seed=10), dev)
    gravitynet = train_gravitynet(cfg, rec, s1_steps, s1_bs, TorchNoise(dev, seed=11), dev)
    diff, s2_state = train_stage2(cfg_diff, ds2, s2_steps, s2_bs, s2_accum, TorchNoise(dev, seed=12), dev)
    hn_random = stage1_model(HeadFormer, cfg.headnet, 99, dev).eval()
    gn_random = stage1_model(HeadNormalFormer, cfg.gravitynet, 99, dev).eval()
    if save_dir:
        save_weights(save_dir, headnet, gravitynet, s2_state)

    stats = NormStats(*(t.to(dev) for t in ds2.stats))

    def build(hn, gn):
        return EgoEgoPipeline(diffusion=diff, stats=stats, rest_offsets=torch.as_tensor(rest, device=dev),
                              headnet=hn, gravitynet=gn)

    pipe = build(headnet, gravitynet)
    gq, gp, fk_head_pose = gt_from_smpl_params(pipe, motion["trans"], motion["root_orient"], motion["body_pose"])
    record_head_pose = np.asarray(rec["head_pose"][:-1], np.float32)

    results, conds = {}, {}
    # stage-1 head-pose metrics, trained against random (eval_egoego.py:297-312)
    for tag, hn, gn in (("trained", headnet, gravitynet), ("random", hn_random, gn_random)):
        s1 = build(hn, gn).stage1_head_pose(rec)
        hp = s1["head_pose"].cpu().numpy()
        t = min(hp.shape[0], record_head_pose.shape[0])
        hd, hrd, hte = stage1_metrics(hp[:t], record_head_pose[:t])
        # hd / hrd: the reference's Frobenius pose / rotation distances; hte in mm
        results[f"stage1_{tag}"] = {"head_pose_frob": round(hd, 4), "head_rot_frob": round(hrd, 4),
                                    "head_traj_err_mm": round(hte, 2),
                                    "pred_scale": round(float(s1["pred_scale"]), 4)}
        conds[f"stage1_{tag}"] = hp

    # end-to-end MPJPE under the four regimes (the demo floor offset: run_egoego.py:136)
    conds = {"stage1_trained": conds["stage1_trained"], "stage1_random": conds["stage1_random"],
             "gt_record_head": record_head_pose, "gt_fk_head": fk_head_pose.cpu().numpy()}
    for tag, hp in conds.items():
        hp = np.array(hp, np.float32)
        if tag.startswith("stage1"):
            hp[:, 2] += -0.13
        with torch.no_grad():
            md, _ = evaluate_sequence(pipe, hp, gq, gp, TorchNoise(dev, seed=7), sample_bs=1)
        results[f"e2e_{tag}"] = {"mpjpe_mm": round(float(md["mpjpe"]), 2),
                                 "head_trans_dist_mm": round(float(md["head_trans_dist"]), 2),
                                 "pred_fs_mm": round(float(md["pred_fs"]), 2)}
        print(f"e2e {tag}: {results[f'e2e_{tag}']}", flush=True)

    result = {"metric": "full-system capability check (demo sequence, all models trained from scratch)",
              "s1_steps": s1_steps, "s2_steps": s2_steps, **results}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
