"""Posereg baseline training CLI, VideoRegNet: OF features -> qpos (port of
egoego_release_tpu/training/train_posereg.py; the reference's
kinpoly/scripts/exp_pose_reg.py and its baseline_posereg_* statear
configs).

AdamW (weight decay 1e-4, torch's decoupled form, which is optax.adamw's
arithmetic) over windows of fr_num frames with stride fr_num, in
``np.random.RandomState(seed)`` orders, as the JAX CLI draws them. A batch
whose loss is not finite is skipped whole: the parameters and AdamW's state
(its step count and moments) stay as they were (exp_pose_reg.py:210-213).
The JAX step applies the network with flax's default
``deterministic=True``, so no dropout runs in training, and none runs here.
The LSTMs and convolutions run on cuDNN in f32 (``f32_convolutions``). Saves
``epoch_{n}.pt`` (the state_dict and ``VideoRegNet.settings``) every
``--save_interval`` epochs under ``--save_dir``.

Inputs follow the reference's statear layout: --expert_path and
--of_feats_path ({take: (T, cnn_fdim)}); records that carry an "of_feats"
array need no separate pickle.

    python -m egoego_release_tpu_torch.training.train_posereg --expert_path mocap_annotations.p \\
        --of_feats_path mocap_img_feats.p [--cfg baseline_posereg_of_only_on_syn_amass_v1.yml] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from egoego_release_tpu_torch.data.formats import load_motion_dict
from egoego_release_tpu_torch.models.init import flax_init_
from egoego_release_tpu_torch.models.posereg import VideoRegNet, posereg_loss
from egoego_release_tpu_torch.models.resnet import f32_convolutions
from egoego_release_tpu_torch.utils.device import resolve_device

QPOS_DIM = 76


def load_windows(expert_path: str, of_feats_path: str | None, fr_num: int):
    """(of (N, fr_num, F), qpos (N, fr_num, 76)) windows of stride fr_num
    (JAX ``training/train_posereg.py:34``)."""
    data = load_motion_dict(expert_path)
    of_data = load_motion_dict(of_feats_path) if of_feats_path else {}
    of_w, q_w = [], []
    for key, rec in data.items():
        name = rec.get("seq_name", str(key))
        feats = rec.get("of_feats")
        if feats is None:
            feats = of_data.get(name, of_data.get(key))
        if feats is None:
            continue
        feats = np.asarray(feats, np.float32)
        qpos = np.asarray(rec["qpos"], np.float32)
        t = min(len(feats), len(qpos))
        for s in range(0, t - fr_num + 1, fr_num):
            of_w.append(feats[s:s + fr_num])
            q_w.append(qpos[s:s + fr_num])
    if not of_w:
        raise ValueError("no windows: no OF features found for any take")
    return np.stack(of_w), np.stack(q_w)


def build_net(opt, model_specs: dict, feat_dim: int) -> VideoRegNet:
    """The network of the CLI's settings: ``model_specs`` (a statear YAML's)
    over the flags for rnn_hdim and cnn_fdim, the features' width as the
    input."""
    return VideoRegNet(out_dim=QPOS_DIM, v_hdim=int(model_specs.get("rnn_hdim", opt.v_hdim)),
                       cnn_fdim=int(model_specs.get("cnn_fdim", feat_dim)), v_net_type=opt.v_net_type,
                       causal=opt.causal, feat_dim=feat_dim)


def train_step(net: VideoRegNet, opt: torch.optim.AdamW, of_b: torch.Tensor, q_b: torch.Tensor) -> float:
    """One AdamW step; a non-finite loss leaves the parameters and the
    optimizer untouched. Returns the loss (synchronized, as the JAX CLI
    reads each)."""
    opt.zero_grad(set_to_none=True)
    loss = posereg_loss(net(of_b), q_b)
    value = float(loss.detach())
    if np.isfinite(value):
        loss.backward()
        opt.step()
    return value


def train(opt, state_dict: dict | None = None) -> dict:
    """Train at ``opt`` (``parse_opt``'s namespace); the weights are drawn
    from ``opt.seed`` (flax's initializers) unless ``state_dict`` (e.g.
    ``utils.convert.posereg_state_dict_from_jax``) is given. Returns the
    network, the loss of each step and the last epoch's mean loss."""
    dev = resolve_device(opt.device)
    model_specs = {}
    fr_num = opt.fr_num
    if opt.cfg:
        from egoego_release_tpu_torch.utils.config import KinpolyConfig

        cfg = KinpolyConfig(opt.cfg)
        model_specs = cfg.model_specs
        fr_num = opt.fr_num or cfg.fr_num
    fr_num = fr_num or 90  # the statear window when neither the flag nor the cfg sets one
    assert fr_num > 0, f"fr_num must be positive, got {fr_num}"

    of, qpos = load_windows(opt.expert_path, opt.of_feats_path, fr_num)
    net = build_net(opt, model_specs, of.shape[-1])
    if state_dict is None:
        flax_init_(net, torch.Generator().manual_seed(opt.seed))
    else:
        net.load_state_dict(state_dict)
    net.to(dev).train()
    adamw = torch.optim.AdamW(net.parameters(), lr=opt.lr, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=opt.weight_decay)
    of_dev, q_dev = torch.as_tensor(of, device=dev), torch.as_tensor(qpos, device=dev)

    n = len(of)
    rng = np.random.RandomState(opt.seed)
    last, history = float("nan"), []
    with f32_convolutions():
        for epoch in range(opt.epochs):
            order = rng.permutation(n)
            losses = []
            for s in range(0, n, opt.batch_size):
                idx = torch.as_tensor(order[s:s + opt.batch_size], device=dev)
                loss = train_step(net, adamw, of_dev[idx], q_dev[idx])
                history.append(loss)
                if np.isfinite(loss):
                    losses.append(loss)
                else:
                    print("WARNING: NaN loss, batch skipped")  # exp_pose_reg.py:210-213
            last = float(np.mean(losses)) if losses else float("nan")
            print(f"epoch {epoch}: loss {last:.5f}")
            if opt.save_dir and (epoch + 1) % opt.save_interval == 0:
                os.makedirs(opt.save_dir, exist_ok=True)
                torch.save({"model": net.state_dict(), "settings": net.settings},
                           os.path.join(opt.save_dir, f"epoch_{epoch + 1}.pt"))
    return {"net": net, "losses": history, "last": last}


def run(opt, state_dict: dict | None = None) -> float:
    """``train``; returns the last epoch's mean loss, as the JAX CLI does."""
    return train(opt, state_dict)["last"]


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--expert_path", required=True)
    p.add_argument("--of_feats_path", default=None)
    p.add_argument("--cfg", default=None, help="statear YAML (model_specs)")
    p.add_argument("--fr_num", type=int, default=0)
    p.add_argument("--v_hdim", type=int, default=128)
    p.add_argument("--v_net_type", choices=["lstm", "tcn"], default="lstm")
    p.add_argument("--causal", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--save_interval", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    return run(parse_opt(argv))


if __name__ == "__main__":
    main()
