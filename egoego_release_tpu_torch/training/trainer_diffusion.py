"""Stage-2 diffusion trainer (port of
egoego_release_tpu/training/trainer_diffusion.py).

The reference trainer's hyper-parameters (trainer_amass_cond_motion_diffusion.py
:37-41,58,144-179): Adam(1e-4), the loss and gradients averaged over
``grad_accum`` micro-batches, EMA(0.995, every 10, from step 2000), and the
NaN guard. The step is f32 (JAX trains without ``compute_dtype``), plain
``nn.Module`` forwards with autograd: the JAX package has no backward
kernel, and neither has this one.

The NaN guard, to the JAX package's letter: on a non-finite loss or
gradient the parameters and the Adam state (moments and step count) stay
as they were, while ``step`` and ``nan_count`` advance and the EMA update
runs at the new step. It never waits for the device: the gradients are
checked into a device flag (``_amp_foreach_non_finite_check_and_unscale_``)
that the fused Adam kernel reads as ``found_inf`` and skips on.

Checkpoints are ``model-<step>.pt`` in the reference's layout (``step``,
``model`` with ``denoise_fn.*`` keys, ``ema`` with ``ema_model.denoise_fn.*``
keys) plus ``adam`` and ``nan_count``; ``utils.convert.load_stage2_diffusion_ckpt``
reads them as released checkpoints. The JAX package's orbax directories are
neither read nor written here.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass

import torch

from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    head_condition_mask,
    new_denoiser,
)
from egoego_release_tpu_torch.models.denoiser import TransformerDiffusionModel, init_weights_
from egoego_release_tpu_torch.training.ema import ema_update
from egoego_release_tpu_torch.utils.convert import load_denoiser_weights, strip_prefix


@dataclass
class TrainState:
    """What the JAX TrainState holds, as live objects: the model's
    parameters, the Adam state (inside ``optimizer``), the EMA weights, the
    step count (host int: it advances every step, so the host knows it
    without asking the device) and ``nan_count`` (a device scalar)."""

    model: TransformerDiffusionModel
    ema: TransformerDiffusionModel
    optimizer: torch.optim.Adam
    step: int
    nan_count: torch.Tensor


class DiffusionTrainer:
    def __init__(self, diffusion: CondGaussianDiffusion, lr: float = 1e-4, grad_accum: int = 2,
                 ema_decay: float = 0.995, ema_update_every: int = 10, ema_step_start: int = 2000):
        self.diffusion = diffusion
        self.device = diffusion.device
        self.lr = lr
        self.grad_accum = grad_accum
        self.ema_cfg = (ema_decay, ema_update_every, ema_step_start)
        self._one = torch.ones((), device=self.device)

    def _new_state(self, model: TransformerDiffusionModel) -> TrainState:
        model = model.to(self.device)
        ema = copy.deepcopy(model).requires_grad_(False)
        # fused: one kernel for the whole update, and the only Adam that
        # takes a device-side found_inf
        opt = torch.optim.Adam(model.parameters(), lr=self.lr, fused=True)
        # optax.adam's state exists from init: zero moments, count 0
        for p in model.parameters():
            opt.state[p] = {"step": torch.zeros((), device=self.device),
                            "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        return TrainState(model, ema, opt, 0, torch.zeros((), dtype=torch.int64, device=self.device))

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Random weights drawn from ``generator`` (models.denoiser.init_weights_)."""
        return self._new_state(init_weights_(new_denoiser(self.diffusion.cfg), generator))

    def state_from_dict(self, ckpt: dict) -> TrainState:
        """A TrainState from a checkpoint's dict (``load_checkpoint``, or
        ``utils.convert.trainer_state_from_jax``)."""
        model = load_denoiser_weights(new_denoiser(self.diffusion.cfg),
                                      strip_prefix(ckpt["model"], "denoise_fn."))
        state = self._new_state(model)
        load_denoiser_weights(state.ema, strip_prefix(strip_prefix(ckpt["ema"], "ema_model."), "denoise_fn."))
        adam = ckpt["adam"]
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                st = state.optimizer.state[p]
                st["step"].fill_(adam["step"])
                st["exp_avg"].copy_(adam["exp_avg"][name])
                st["exp_avg_sq"].copy_(adam["exp_avg_sq"][name])
        state.step = int(ckpt["step"])
        state.nan_count.fill_(int(ckpt["nan_count"]))
        return state

    def _train_step(self, state: TrainState, motion: torch.Tensor, seq_len: torch.Tensor, noise):
        """motion (accum B, T, D), seq_len (accum B,) on the device. One
        optimizer step over ``grad_accum`` micro-batches; ``noise.split``
        gives each micro-batch its source. Returns (state, loss), the loss
        a device scalar."""
        window = motion.shape[1]
        # padding mask incl. the noise token (trainer:223-231)
        pad = (torch.arange(window + 1, device=motion.device)[None, :]
               < (seq_len + 1)[:, None]).float()[:, None, :]
        micro = self.grad_accum
        mb = motion.shape[0] // micro
        cond_mask = head_condition_mask(mb, window, device=motion.device)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = None
        for i, src in enumerate(noise.split(micro)):
            sl = slice(i * mb, (i + 1) * mb)
            li = self.diffusion.p_losses(model, motion[sl], cond_mask, pad[sl], noise=src, train=True)
            li.backward()
            loss = li.detach() if loss is None else loss + li.detach()
        loss = loss / micro
        grads = [p.grad for p in model.parameters()]
        torch._foreach_div_(grads, micro)

        # NaN guard (trainer:144-160): Adam skips the update on found_inf
        found_inf = (~torch.isfinite(loss)).float()
        torch._amp_foreach_non_finite_check_and_unscale_(grads, found_inf, self._one)
        opt.found_inf = found_inf
        opt.step()
        state.step += 1
        state.nan_count += found_inf.long()
        decay, every, start = self.ema_cfg
        ema_update(list(state.ema.parameters()), list(model.parameters()), state.step, decay, every, start)
        return state, loss

    def _train_step_device(self, state: TrainState, data: torch.Tensor, seq_lens: torch.Tensor, noise,
                           batch_size: int):
        """The device-resident data path: the window bank ``data`` (N, T, D)
        (f32 or bf16) and ``seq_lens`` (N,) live on the device, and the batch
        is gathered there, uniform with replacement, from indices drawn on
        the device (``noise.split(2)``: indices, then the step). The
        reference cycles a shuffled DataLoader instead: the same stationary
        distribution."""
        idx_src, step_src = noise.split(2)
        idx = idx_src.randint(batch_size, data.shape[0]).to(data.device)
        motion = data.index_select(0, idx).float()
        return self._train_step(state, motion, seq_lens.index_select(0, idx), step_src)

    def train_step(self, state: TrainState, batch: dict, noise):
        """One step on a host or device batch {"motion", "seq_len"}."""
        motion = torch.as_tensor(batch["motion"]).to(self.device, torch.float32)
        seq_len = torch.as_tensor(batch["seq_len"]).to(self.device, torch.int64)
        return self._train_step(state, motion, seq_len, noise)

    def fit_device(self, state: TrainState, data, seq_lens, num_steps: int, batch_size: int, noise,
                   data_dtype: torch.dtype | None = None, **loop):
        """fit() over a device-resident window bank ((N, T, D) + (N,)).
        ``data_dtype=torch.bfloat16`` halves its footprint; each step casts
        the gathered batch back to f32. ``loop``: as ``_loop``."""
        data = torch.as_tensor(data).to(self.device, data_dtype or torch.float32)
        seq_lens = torch.as_tensor(seq_lens).to(self.device, torch.int64)
        step = lambda s: self._train_step_device(s, data, seq_lens, noise, batch_size)
        return self._loop(state, step, num_steps, **loop)

    def fit(self, state: TrainState, batches, num_steps: int, noise, **loop):
        """Steps over the batches {"motion", "seq_len"} that the iterator
        ``batches`` yields (host or device tensors). ``loop``: as ``_loop``."""
        step = lambda s: self.train_step(s, next(batches), noise)
        return self._loop(state, step, num_steps, **loop)

    @staticmethod
    def _loop(state, step, num_steps, log_every: int = 100, ckpt_dir: str | None = None,
              save_every: int = 200_000, logger=None, stop=None):
        """``num_steps`` steps. Every ``log_every`` steps one device sync: the
        step's loss (as JAX logs it) goes to stdout and the returned list,
        and with it the mean loss since the last line and ``nan_count`` to
        ``logger``. A checkpoint every ``save_every`` steps, and at once when
        ``stop()`` turns true, which ends the loop. Returns (state, losses)."""
        losses = []
        loss_sum = 0.0
        for i in range(num_steps):
            state, loss = step(state)
            loss_sum = loss_sum + loss
            if (i + 1) % log_every == 0:
                losses.append(float(loss))
                if logger is not None:
                    logger.log(state.step, loss=losses[-1], loss_mean=float(loss_sum) / log_every,
                               nan_count=int(state.nan_count))
                print(f"step {state.step}: loss {losses[-1]:.5f}")
                loss_sum = 0.0
            stopping = stop is not None and stop()
            if ckpt_dir is not None and (state.step % save_every == 0 or stopping):
                print("checkpoint:", save_checkpoint(ckpt_dir, state))
            if stopping:
                break
        return state, losses


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """``{ckpt_dir}/model-<step>.pt``: step, model, ema, adam (step count,
    moments by parameter name), nan_count. Written to a temporary name and
    renamed, so a stop mid-write leaves no partial checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"model-{state.step}.pt")
    cpu = lambda sd, prefix: {prefix + k: v.detach().cpu() for k, v in sd.items()}
    params = dict(state.model.named_parameters())
    adam = {name: state.optimizer.state[p] for name, p in params.items()}
    torch.save({
        "step": state.step,
        "model": cpu(state.model.state_dict(), "denoise_fn."),
        "ema": cpu(state.ema.state_dict(), "ema_model.denoise_fn."),
        # the reference keeps no optimizer state (its schema is {step,
        # model, ema, scaler}); the Adam moments make resuming exact
        "adam": {"step": int(next(iter(adam.values()))["step"]),
                 "exp_avg": cpu({k: s["exp_avg"] for k, s in adam.items()}, ""),
                 "exp_avg_sq": cpu({k: s["exp_avg_sq"] for k, s in adam.items()}, "")},
        "nan_count": int(state.nan_count),
    }, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(path: str, trainer: DiffusionTrainer) -> TrainState:
    """A checkpoint back into a TrainState (exact resume)."""
    return trainer.state_from_dict(load_checkpoint(path))
