"""Exponential moving average of the parameters (port of
egoego_release_tpu/training/ema.py).

The reference trainer's EMA (beta 0.995, every 10 steps, from step 2000):
it acts only at steps that are multiples of ``update_every``; before
``step_start_ema`` it copies the parameters, after that it blends them in
with ``beta``. This is the JAX package's rule, not ema-pytorch's, whose
counter and warm-up differ.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_update(ema_params: list[torch.Tensor], params: list[torch.Tensor], step: int,
               beta: float = 0.995, update_every: int = 10, step_start_ema: int = 2000) -> None:
    """In place on ``ema_params``, after the optimizer step that made the
    step count ``step``: e = p (step < step_start_ema) or e = beta e +
    (1 - beta) p, at steps divisible by ``update_every`` only."""
    if step % update_every != 0:
        return
    if step < step_start_ema:
        torch._foreach_copy_(ema_params, params)
    else:
        torch._foreach_mul_(ema_params, beta)
        torch._foreach_add_(ema_params, params, alpha=1.0 - beta)
