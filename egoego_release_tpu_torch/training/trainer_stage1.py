"""Stage-1 trainers, HeadNet and GravityNet (port of
egoego_release_tpu/training/trainer_stage1.py).

The reference trains both with AdamW, a StepLR(step_size, 0.3) stepped per
epoch and the gradients clipped to a global norm of 1.0. The JAX package
writes that as ``optax.chain(clip_by_global_norm(1.0),
adamw(exponential_decay(staircase=True)))``, and this module follows optax
to the letter, where torch's own helpers differ:

- the clip scales the gradients by max_norm / norm only when norm exceeds
  max_norm (``clip_grad_norm_`` divides by norm + 1e-6 whenever it is
  called), computed on the device, so the step never waits for the norm;
- AdamW's weight decay is optax's default, 1e-4 (torch's is 1e-2). optax's
  update lr (m_hat / (sqrt(v_hat) + eps) + wd p) is the arithmetic of
  torch's AdamW, which scales p by 1 - lr wd and then takes the Adam step;
- the learning rate of optimizer step k (from 0) is lr gamma^floor(k /
  transition_steps), transition_steps = step_size_epochs x steps_per_epoch:
  optax counts optimizer steps, not epochs.

A step is f32 autograd through the ``nn.Module``s: the JAX package has no
backward kernel and neither has this one. Dropout is on (the transformer's
own dropout modules, in train mode), seeded each step from the noise
source's ``dropout_seed``, with the global RNG forked around the forward,
as the stage-2 trainer seeds it. HeadNet's loss integrates the predicted
velocities on the tensors' device (``models.headnet.headformer_loss``).

The raw-flow HeadNet (``HeadFormerWithCNN``) trains with
``headnet_cnn_loss_fn``; ``freeze_subtrees`` freezes its ResNet-18, whose
parameters then stay out of AdamW (no update, no weight decay, not in the
clip's norm), as JAX's ``optax.multi_transform`` with ``set_to_zero``
leaves them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from egoego_release_tpu_torch.models.gravitynet import gravitynet_loss, slam_traj_features
from egoego_release_tpu_torch.models.headnet import headformer_loss, padding_mask_from_len
from egoego_release_tpu_torch.utils.convert import load_denoiser_weights


@dataclass
class Stage1Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule)) on a
    ``torch.optim.AdamW``: ``init`` makes the optimizer, ``step`` clips the
    gradients and takes optimizer step ``count`` at the schedule's rate."""

    lr: float
    transition_steps: int
    gamma: float = 0.3
    max_norm: float = 1.0
    weight_decay: float = 1e-4

    def learning_rate(self, count: int) -> float:
        """optax.exponential_decay(lr, transition_steps, gamma, staircase=True) at ``count``."""
        return self.lr * self.gamma ** (count // self.transition_steps)

    def init(self, params) -> torch.optim.AdamW:
        """AdamW over ``params`` with optax's state from the start: zero
        moments and count 0 (so that a state can be loaded into it)."""
        params = list(params)
        opt = torch.optim.AdamW(params, lr=self.lr, weight_decay=self.weight_decay, fused=True)
        for p in params:
            opt.state[p] = {"step": torch.zeros((), device=p.device), "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        return opt

    def clip_(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """optax.clip_by_global_norm in place: g / norm * max_norm where
        the global norm exceeds max_norm, else g. Returns the norm."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        over = norm >= self.max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(over, norm, one))
        torch._foreach_mul_(grads, torch.where(over, torch.full_like(norm, self.max_norm), one))
        return norm

    def step(self, opt: torch.optim.AdamW, count: int) -> None:
        """Clip the gradients of ``opt``'s parameters and take optimizer step
        ``count`` (from 0)."""
        params = [p for group in opt.param_groups for p in group["params"]]
        self.clip_([p.grad for p in params])
        for group in opt.param_groups:
            group["lr"] = self.learning_rate(count)
        opt.step()


def freeze_subtrees(model: nn.Module, frozen_keys: tuple[str, ...]) -> nn.Module:
    """Freeze (``requires_grad`` off) every parameter of ``model`` whose
    dotted name has a component in ``frozen_keys``; ``Stage1Trainer``
    gives AdamW only the rest. JAX's ``freeze_subtrees`` also freezes the
    "batch_stats" collection, which has no counterpart here (the
    batch-statistics BatchNorm keeps no buffers)."""
    for name, p in model.named_parameters():
        if set(name.split(".")) & set(frozen_keys):
            p.requires_grad_(False)
    return model


def make_optimizer(lr: float, step_size_epochs: int, gamma: float = 0.3, steps_per_epoch: int = 1,
                   weight_decay: float = 1e-4) -> Stage1Optimizer:
    """AdamW (weight decay 1e-4, optax's default) with the StepLR schedule
    counted in optimizer steps, after a global-norm clip of 1.0."""
    return Stage1Optimizer(lr, step_size_epochs * steps_per_epoch, gamma, weight_decay=weight_decay)


@dataclass
class Stage1State:
    """The model (its parameters), the AdamW holding the moments, the
    epoch, and the count of optimizer steps taken (host ints)."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    epoch: int = 0
    step: int = 0


class Stage1Trainer:
    """One trainer for both stage-1 models: ``loss_fn(model, batch)`` ->
    (loss, aux) on a batch of device tensors."""

    def __init__(self, loss_fn: Callable, optimizer: Stage1Optimizer):
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def init_state(self, model: nn.Module) -> Stage1State:
        """AdamW over the parameters that require a gradient (the frozen ones
        of ``freeze_subtrees`` stay out)."""
        return Stage1State(model, self.optimizer.init(p for p in model.parameters() if p.requires_grad))

    def state_from_dict(self, model: nn.Module, ckpt: dict) -> Stage1State:
        """A state from ``utils.convert.stage1_state_from_jax``'s dict (or a
        checkpoint's): the weights into ``model``, AdamW's count and
        moments by parameter name (of the parameters it trains), the epoch."""
        load_denoiser_weights(model, ckpt["model"])
        state = self.init_state(model)
        adam = ckpt["adam"]
        with torch.no_grad():
            for name, p in model.named_parameters():
                if not p.requires_grad:
                    continue
                st = state.optimizer.state[p]
                st["step"].fill_(adam["step"])
                st["exp_avg"].copy_(adam["exp_avg"][name])
                st["exp_avg_sq"].copy_(adam["exp_avg_sq"][name])
        state.epoch, state.step = int(ckpt["epoch"]), int(adam["step"])
        return state

    def train_step(self, state: Stage1State, batch: dict, noise):
        """One optimizer step on ``batch`` (host arrays or tensors, moved to
        the model's device; ``seq_len`` as int64, the rest f32), dropout
        seeded from ``noise.dropout_seed()``. Returns (state, loss, aux), the
        loss and aux as device scalars."""
        model = state.model
        dev = next(model.parameters()).device
        batch = {k: torch.as_tensor(v).to(dev, torch.int64 if k == "seq_len" else torch.float32)
                 for k, v in batch.items()}
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with torch.random.fork_rng(devices=[dev.index] if dev.type == "cuda" else []):
            torch.manual_seed(noise.dropout_seed())
            loss, aux = self.loss_fn(model, batch)
        loss.backward()
        self.optimizer.step(state.optimizer, state.step)
        state.step += 1
        return state, loss.detach(), {k: v.detach() for k, v in aux.items()}


# -- loss closures -----------------------------------------------------------


def headnet_loss_fn(model, batch: dict, w_rotation: float = 1.0, w_va: float = 1.0, w_dist: float = 1.0,
                    dist_scale: float = 10.0):
    """HeadFormer's loss on a batch: of (B, T, 512), head_pose (B, T+1, 7),
    head_vels (B, T, 6), seq_len (B,) (the reference's training batch)."""
    mask = padding_mask_from_len(batch["seq_len"].float(), model.window)
    va, dist = model(batch["of"], mask)
    hp = batch["head_pose"]
    loss, (ol, vl, dl) = headformer_loss(va, dist, hp[:, 0, 3:], batch["head_vels"][:, :, 3:], hp[:, :, 3:],
                                         hp[:, :, :3], w_rotation=w_rotation, w_va=w_va, w_dist=w_dist,
                                         dist_scale=dist_scale)
    return loss, {"orient": ol, "va": vl, "dist": dl}


# The raw-flow HeadNet's loss (JAX: ``headnet_cnn_loss_fn``, which applies
# the model mutable over its batch statistics and discards them): batch["of"]
# holds flow frames (B, T, H, W, 2), which HeadFormerWithCNN encodes itself,
# and its batch-statistics BatchNorm keeps no state, so the closure is
# HeadFormer's.
headnet_cnn_loss_fn = headnet_loss_fn


def gravitynet_loss_fn(model, batch: dict):
    """HeadNormalFormer's loss on a batch of ``AMASSHeadPoseDataset``:
    head_rot_mat (B, T+1, 3, 3), head_trans (B, T+1, 3), seq_len (B,),
    floor_normal (B, 3)."""
    feats = slam_traj_features(batch["head_rot_mat"], batch["head_trans"])
    window, t = model.window, feats.shape[1]
    if t < window:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, window - t))
    mask = (torch.arange(window, device=feats.device)[None, :] < (batch["seq_len"] - 1)[:, None]).float()
    loss = gravitynet_loss(model(feats, mask), batch["floor_normal"])
    return loss, {"normal": loss}


def train_epochs(trainer: Stage1Trainer, state: Stage1State, batches, steps_per_epoch: int, num_epochs: int,
                 noise, val_fn=None, log_every: int = 50, log_fn=None) -> Stage1State:
    """``num_epochs`` epochs of ``steps_per_epoch`` steps over the iterator
    ``batches``: every ``log_every`` optimizer steps (a device sync)
    ``log_fn(state, loss, aux)``, by default a printed line, and after each
    epoch ``val_fn(state, epoch)``. The training CLIs' loop
    (``train_stage1``) is this one."""
    if log_fn is None:
        log_fn = lambda st, loss, aux: print(f"epoch {st.epoch} step {st.step}: loss {float(loss):.5f}")
    for epoch in range(num_epochs):
        for _ in range(steps_per_epoch):
            state, loss, aux = trainer.train_step(state, next(batches), noise)
            if state.step % log_every == 0:
                log_fn(state, loss, aux)
        state.epoch += 1
        if val_fn is not None:
            val_fn(state, epoch)
    return state


def save_stage1_ckpt(ckpt_dir: str, state: Stage1State, epoch: int) -> str:
    """``{ckpt_dir}/epoch-<epoch>.pt`` in the reference's layout
    (``transformer_encoder_state_dict``, ``optimizer_state_dict``,
    ``epoch``), which ``utils.convert.load_stage1_ckpt`` and the eval CLIs'
    ``--headnet_ckpt`` / ``--gravitynet_ckpt`` read. Written to a temporary
    name and renamed."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"epoch-{epoch}.pt")
    to_cpu = lambda v: v.detach().cpu() if torch.is_tensor(v) else v
    opt = state.optimizer.state_dict()
    opt["state"] = {k: {n: to_cpu(v) for n, v in s.items()} for k, s in opt["state"].items()}
    torch.save({"transformer_encoder_state_dict": {k: to_cpu(v) for k, v in state.model.state_dict().items()},
                "optimizer_state_dict": opt, "epoch": epoch}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path
