"""TrajARNet (kin-poly baseline) training CLI (port of
egoego_release_tpu/training/train_trajar.py; the reference's
kinpoly/scripts/exp_arnet_all.py).

Adam after a global-norm clip of 1.0, as optax's chain: the clip scales
only when the norm exceeds 1 (``trainer_stage1.clip_by_global_norm_``),
Adam's epsilon is 1e-8 outside the square root. Each step rolls the
network out over fr_num frames of ``data.kinpoly.StateARDataset`` windows,
from the ground truth's first qpos, under autograd, and takes
``trajar_loss``. The dataset's ``random.Random(seed)`` draws the windows in
the JAX CLI's order (its first batch goes to shape the initialization
there, and is drawn and dropped here too). Writes ``final.pt`` (the
model's state_dict and its widths) under ``--save_dir``.

    python -m egoego_release_tpu_torch.training.train_trajar --expert_path mocap_annotations.p \\
        --rest_offsets rest.npy [--epochs 100 --fr_num 90 --batch_size 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from egoego_release_tpu_torch.data.kinpoly import StateARDataset
from egoego_release_tpu_torch.models.trajar import STEP_KEYS, TrajARNet, init_trajar_, trajar_loss
from egoego_release_tpu_torch.training.trainer_stage1 import clip_by_global_norm_
from egoego_release_tpu_torch.utils.device import resolve_device


def make_optimizer(model: TrajARNet, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(model: TrajARNet, opt: torch.optim.Adam, batch: dict) -> torch.Tensor:
    """One step on a batch of device tensors: the rollout from the GT's
    first qpos, ``trajar_loss``, the clip and Adam (whose moments then decay
    for the parameters the loss does not reach, as optax's do). Returns the
    loss (on the device, not synchronized)."""
    gt_qpos = batch["qpos"]
    opt.zero_grad(set_to_none=True)
    out = model({k: batch[k] for k in STEP_KEYS}, init_qpos=gt_qpos[:, 0])
    loss = trajar_loss(out, gt_qpos, model.rest_offsets)
    loss.backward()
    for p in model.parameters():  # the context head, unused from a GT start: a zero gradient, as optax sees it
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in model.parameters()], 1.0)
    opt.step()
    return loss.detach()


def to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def load_trajar(path: str, rest_offsets, device="cpu", rnn_hdim: int | None = None) -> TrajARNet:
    """A ``final.pt`` of this CLI -> the TrajARNet on ``device``: its widths
    from the file (``rnn_hdim``, when given, must agree)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if rnn_hdim is not None and ckpt["rnn_hdim"] != rnn_hdim:
        raise ValueError(f"{path}: rnn_hdim {ckpt['rnn_hdim']}, expected {rnn_hdim}")
    model = TrajARNet(rnn_hdim=ckpt["rnn_hdim"], mlp_hsize=tuple(ckpt["mlp_hsize"]), rest_offsets=rest_offsets)
    model.load_state_dict(ckpt["model"])
    return model.to(device)


def run(expert_path: str, rest_offsets, epochs: int = 100, fr_num: int = 90, batch_size: int = 8, lr: float = 5e-4,
        rnn_hdim: int = 512, mlp_hsize=(1024, 512), save_dir: str = "./results/trajar", seed: int = 0,
        device="cuda", state_dict: dict | None = None):
    """Train and save ``{save_dir}/final.pt``; the weights are drawn from
    ``seed`` (``models.trajar.init_trajar_``) unless ``state_dict``
    (e.g. ``utils.convert.trajar_state_dict_from_jax``) is given. Returns
    (the model, the loss of each step)."""
    dev = resolve_device(device)
    ds = StateARDataset(expert_path, fr_num=fr_num, train=True, seed=seed)
    print(f"expert sequences: {len(ds)}")
    model = TrajARNet(rnn_hdim=rnn_hdim, mlp_hsize=tuple(mlp_hsize), rest_offsets=np.asarray(rest_offsets))
    if state_dict is None:
        init_trajar_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model.to(dev)
    batches = ds.batch_iterator(batch_size)
    next(batches)  # the JAX CLI shapes its init with the first batch
    opt = make_optimizer(model, lr)

    steps_per_epoch = max(1, len(ds) // batch_size)
    os.makedirs(save_dir, exist_ok=True)
    losses = []
    for epoch in range(epochs):
        for _ in range(steps_per_epoch):
            losses.append(train_step(model, opt, to_device(next(batches), dev)))
        print(f"epoch {epoch}: loss {float(losses[-1]):.5f}")
    torch.save({"model": model.state_dict(), "rnn_hdim": rnn_hdim, "mlp_hsize": list(mlp_hsize)},
               os.path.join(save_dir, "final.pt"))
    return model, [float(v) for v in losses]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--expert_path", required=True)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--fr_num", type=int, default=90)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--save_dir", default="./results/trajar")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from egoego_release_tpu_torch.eval.build import load_rest_offsets

    rest = load_rest_offsets(args.smplh_path, args.rest_offsets)
    return run(args.expert_path, rest, epochs=args.epochs, fr_num=args.fr_num, batch_size=args.batch_size,
               lr=args.lr, save_dir=args.save_dir, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
