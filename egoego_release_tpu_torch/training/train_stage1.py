"""Stage-1 training CLIs, HeadNet and GravityNet (port of
egoego_release_tpu/training/train_stage1.py), on the card unless
``--device cpu`` is given.

The reference's epoch loop (trainer_head_estimation.py,
trainer_amass_head_gravity_normal_estimation.py): AdamW with StepLR(step,
0.3) and a gradient clip of 1.0 (``training.trainer_stage1``), and a
checkpoint after every epoch, ``{save_dir}/{exp_name}/weights/epoch-<n>.pt``
in the reference's layout, which ``eval_egoego --headnet_ckpt /
--gravitynet_ckpt`` load as they are. The JAX package's orbax directories
are neither read nor written. ``--raw_flow`` (HeadNet from raw flow frames
through a ResNet-18) is not ported yet (ROADMAP A.7) and raises.

    python -m egoego_release_tpu_torch.training.train_stage1 headnet \\
        --dataset ares --data_root_folder <root> [--epochs N] [--set ...] [--device cpu]
    python -m egoego_release_tpu_torch.training.train_stage1 gravitynet \\
        --motion_path <motion pickle with head_pose records> [--epochs N] [--set ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from egoego_release_tpu_torch.data.prefetch import prefetch_to_device
from egoego_release_tpu_torch.models.denoiser import init_weights_
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.training.trainer_stage1 import (
    Stage1Trainer,
    gravitynet_loss_fn,
    headnet_loss_fn,
    make_optimizer,
    save_stage1_ckpt,
    train_epochs,
)
from egoego_release_tpu_torch.utils.config import load_config
from egoego_release_tpu_torch.utils.device import resolve_device
from egoego_release_tpu_torch.utils.logging import MetricLogger, save_run_config

GRAVITYNET_LR_STEP_EPOCHS = 2000  # the reference's StepLR step for GravityNet (the JAX CLI's constant)


def _model(cls, m, seed: int, dev):
    """A stage-1 model of config ``m`` with random weights from ``seed``."""
    model = cls(d_model=m.d_model, n_layers=m.n_dec_layers, n_head=m.n_head, d_k=m.d_k, d_v=m.d_v, window=m.window)
    return init_weights_(model, torch.Generator().manual_seed(seed)).to(dev)


def _run(cfg, trainer, state, batches, steps_per_epoch: int, num_epochs: int, dev, noise):
    """Both CLIs' ``train_epochs`` over ``batches``, an iterator of the
    run's steps_per_epoch x num_epochs host batches, prefetched to the
    device by a thread when ``cfg.data.prefetch`` > 0: the loss logged
    every ``log_every`` steps, a checkpoint after every epoch."""
    save_dir = os.path.join(cfg.logging.save_dir, cfg.logging.exp_name)
    save_run_config(cfg, save_dir)
    logger = MetricLogger(save_dir, cfg.logging.use_wandb, cfg.logging.wandb_project, cfg.logging.exp_name)
    if cfg.data.prefetch > 0:
        batches = prefetch_to_device(batches, prefetch=cfg.data.prefetch, device=dev)

    def log(state, loss, aux):
        logger.log(state.step, loss=float(loss), **{k: float(v) for k, v in aux.items()})

    def checkpoint(state, epoch):
        print(f"epoch {epoch}: {save_stage1_ckpt(os.path.join(save_dir, 'weights'), state, epoch)}")

    try:
        return train_epochs(trainer, state, batches, steps_per_epoch, num_epochs, noise, val_fn=checkpoint,
                            log_every=cfg.logging.log_every, log_fn=log)
    finally:
        logger.close()


def run_headnet(cfg, dataset_name: str, data_root_folder: str, num_epochs: int, input_of_feats: bool = True,
                device="cuda"):
    """Train HeadFormer on precomputed OF features of the ARES, GIMO or
    Kinpoly-RealWorld training split; returns the final Stage1State."""
    if not input_of_feats:
        raise NotImplementedError("--raw_flow: HeadNet from raw flow frames (HeadFormerWithCNN, its ResNet-18, "
                                  "freeze_subtrees) is not ported to the PyTorch package yet (ROADMAP A.7)")
    from egoego_release_tpu_torch.data.headpose import (
        ARESHeadPoseDataset,
        GIMOHeadPoseDataset,
        RealWorldHeadPoseDataset,
    )
    from egoego_release_tpu_torch.models.headnet import HeadFormer

    dev = resolve_device(device)
    mk = {"ares": ARESHeadPoseDataset, "gimo": GIMOHeadPoseDataset, "kinpoly": RealWorldHeadPoseDataset}
    m = cfg.headnet
    ds = mk[dataset_name](data_root_folder, train=True, window=m.window)
    bs = cfg.data.batch_size
    steps_per_epoch = max(1, len(ds) // bs)
    trainer = Stage1Trainer(headnet_loss_fn, make_optimizer(cfg.train.learning_rate, cfg.train.lr_step_size,
                                                           cfg.train.lr_gamma, steps_per_epoch))
    state = trainer.init_state(_model(HeadFormer, m, cfg.train.seed, dev))
    rng = np.random.RandomState(cfg.train.seed)

    def batches():
        """The run's host batches, a fresh permutation each epoch; the OF
        files are read here, so the prefetch thread overlaps the reading
        with the step."""
        for _ in range(num_epochs):
            order = rng.permutation(len(ds))
            for s in range(steps_per_epoch):
                items = [ds[int(j)] for j in order[s * bs:(s + 1) * bs]]
                yield {"of": np.stack([it["of"] for it in items]),
                       "head_pose": np.stack([it["head_pose"] for it in items]),
                       "head_vels": np.stack([it["head_vels"] for it in items]),
                       "seq_len": np.asarray([it["seq_len"] for it in items], np.int64)}

    return _run(cfg, trainer, state, batches(), steps_per_epoch, num_epochs, dev,
                TorchNoise(dev, seed=cfg.train.seed))


def run_gravitynet(cfg, motion_path: str, num_epochs: int, device="cuda"):
    """Train HeadNormalFormer on augmented GT head trajectories of a motion
    pickle ({seq_name: {"head_pose": (T, 7), ...}}); returns the final
    Stage1State."""
    from egoego_release_tpu_torch.data.amass_headpose import AMASSHeadPoseDataset
    from egoego_release_tpu_torch.data.formats import load_motion_dict
    from egoego_release_tpu_torch.models.gravitynet import HeadNormalFormer

    dev = resolve_device(device)
    m = cfg.gravitynet
    ds = AMASSHeadPoseDataset(load_motion_dict(motion_path), train=True, window=m.window, seed=cfg.train.seed)
    steps_per_epoch = max(1, len(ds) // cfg.data.batch_size)
    trainer = Stage1Trainer(gravitynet_loss_fn, make_optimizer(cfg.train.learning_rate, GRAVITYNET_LR_STEP_EPOCHS,
                                                              cfg.train.lr_gamma, steps_per_epoch))
    state = trainer.init_state(_model(HeadNormalFormer, m, cfg.train.seed, dev))
    batches = itertools.islice(ds.batch_iterator(cfg.data.batch_size), steps_per_epoch * num_epochs)
    return _run(cfg, trainer, state, batches, steps_per_epoch, num_epochs, dev, TorchNoise(dev, seed=cfg.train.seed))


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="which", required=True)
    ph = sub.add_parser("headnet")
    ph.add_argument("--dataset", choices=["ares", "gimo", "kinpoly"], required=True)
    ph.add_argument("--data_root_folder", required=True)
    ph.add_argument("--epochs", type=int, default=250)
    ph.add_argument("--raw_flow", action="store_true",
                    help="train from raw flow frames through a ResNet-18 (not ported yet: raises)")
    pg = sub.add_parser("gravitynet")
    pg.add_argument("--motion_path", required=True)
    pg.add_argument("--epochs", type=int, default=2000)
    for q in (ph, pg):
        q.add_argument("--config", default=None)
        q.add_argument("--set", nargs="*", default=[], help="dotted overrides a.b=c")
        q.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, overrides=args.set)
    if args.which == "headnet":
        return run_headnet(cfg, args.dataset, args.data_root_folder, args.epochs, input_of_feats=not args.raw_flow,
                           device=args.device)
    return run_gravitynet(cfg, args.motion_path, args.epochs, device=args.device)


if __name__ == "__main__":
    main()
