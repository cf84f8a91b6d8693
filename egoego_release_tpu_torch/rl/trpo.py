"""TRPO over the batched kinematic humanoid env (port of
egoego_release_tpu/rl/trpo.py; the reference's khrylib TRPO agent,
kinpoly/copycat/khrylib/rl/agents/agent_trpo.py): the natural-gradient
policy step from conjugate gradient on the Fisher (KL Hessian) vector
product, and a backtracking line search that keeps the KL inside the trust
region, on a flat parameter vector as the reference's.

The Fisher-vector product is a double backward (``torch.autograd.grad``
with ``create_graph``) of the KL's gradient at the current parameters. The
line search is branch free, as JAX's (``rl/trpo.py:146-159``): each
candidate is taken or not by ``torch.where`` on the device, so no decision
waits on the host. The flat order is ``named_parameters``' with torch's
(out, in) weights, not ``ravel_pytree``'s of flax's (in, out) kernels:
compare two packages' parameters after unflattening.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import functional_call

from egoego_release_tpu_torch.rl.env import KinematicHumanoidEnv
from egoego_release_tpu_torch.rl.ppo import (
    GaussianPolicy,
    ValueNet,
    advantages_and_returns,
    fit_value,
    gaussian_logprob,
    init_rl_module_,
    merge_time,
    optax_adam,
    rollout,
)


@dataclass(frozen=True)
class TRPOConfig:
    horizon: int = 32
    gamma: float = 0.95
    gae_lambda: float = 0.95
    max_kl: float = 1e-2
    cg_iters: int = 10
    cg_damping: float = 1e-2
    backtrack_coeff: float = 0.8
    backtrack_iters: int = 10
    value_lr: float = 3e-4
    value_epochs: int = 5


def gaussian_kl(mean0, log_std0, mean1, log_std1) -> torch.Tensor:
    """KL(pi0 || pi1) of diagonal Gaussians, the mean over the batch."""
    var0, var1 = torch.exp(2 * log_std0), torch.exp(2 * log_std1)
    kl = log_std1 - log_std0 + (var0 + (mean0 - mean1) ** 2) / (2 * var1) - 0.5
    return kl.sum(-1).mean()


def conjugate_gradient(fvp, b: torch.Tensor, iters: int) -> torch.Tensor:
    """F x = b by ``iters`` steps of conjugate gradient; ``fvp`` the
    Fisher-vector product. Every scalar stays on the device."""
    x, r, p = torch.zeros_like(b), b.clone(), b.clone()
    rdotr = b @ b
    for _ in range(iters):
        fp = fvp(p)
        alpha = rdotr / (p @ fp + 1e-8)
        x = x + alpha * p
        r = r - alpha * fp
        new_rdotr = r @ r
        p = r + (new_rdotr / (rdotr + 1e-8)) * p
        rdotr = new_rdotr
    return x


class FlatParams:
    """A module's parameters as one flat vector (``named_parameters``
    order) and back, for ``functional_call``."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self.names, self.shapes = zip(*((n, p.shape) for n, p in module.named_parameters()))
        self.sizes = [s.numel() for s in self.shapes]

    def flatten(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.module.parameters()])

    def unflatten(self, flat: torch.Tensor) -> dict:
        return {n: x.view(s) for n, x, s in zip(self.names, flat.split(self.sizes), self.shapes)}

    def __call__(self, flat: torch.Tensor, *args):
        return functional_call(self.module, self.unflatten(flat), args)

    @torch.no_grad()
    def load_(self, flat: torch.Tensor) -> None:
        for p, x in zip(self.module.parameters(), self.unflatten(flat).values()):
            p.copy_(x)


class TRPOAgent:
    def __init__(self, env: KinematicHumanoidEnv, cfg: TRPOConfig = TRPOConfig(), hsize=(512, 256)):
        self.env = env
        self.cfg = cfg
        self.hsize = tuple(hsize)

    def init_state(self, generator: torch.Generator) -> dict:
        """The policy and the value net (``ppo.init_rl_module_`` from
        ``generator``) on the env's device, and the value's Adam."""
        env = self.env
        policy = init_rl_module_(GaussianPolicy(env.obs_dim, env.action_dim, self.hsize), generator).to(env.device)
        value = init_rl_module_(ValueNet(env.obs_dim, self.hsize), generator).to(env.device)
        return self.state_for(policy, value)

    def state_for(self, policy, value) -> dict:
        return {"policy": policy, "value": value, "v_opt": optax_adam(value, self.cfg.value_lr)}

    def iterate(self, state: dict, noise, env_state, expert: dict):
        """One TRPO iteration (JAX ``rl/trpo.py:104-190``): the rollout, GAE,
        the natural-gradient step under the KL line search, then
        ``value_epochs`` Adam steps of the value net. Updates ``state``'s
        modules in place; returns (state, the final env state, metrics as
        device scalars)."""
        cfg, env = self.cfg, self.env
        expert = env.prepare_expert(expert)  # the expert's FK once, not every step
        policy, value = state["policy"], state["value"]
        final_env, (obs, actions, logps, values, rewards, dones) = rollout(
            env, policy, value, noise, env_state, expert, cfg.horizon)
        advs, returns = advantages_and_returns(env, value, final_env, expert, values, rewards, dones, cfg.gamma,
                                               cfg.gae_lambda)
        obs_f, act_f, logp_f, adv_f, ret_f = map(merge_time, (obs, actions, logps, advs, returns))

        fp = FlatParams(policy)
        p0 = fp.flatten()
        with torch.no_grad():
            mean0, log_std0 = policy(obs_f)

        def surrogate(flat):
            mean, log_std = fp(flat, obs_f)
            return (torch.exp(gaussian_logprob(mean, log_std, act_f) - logp_f) * adv_f).mean()

        def kl_fn(flat):
            return gaussian_kl(mean0, log_std0, *fp(flat, obs_f))

        flat = p0.clone().requires_grad_(True)
        g = torch.autograd.grad(surrogate(flat), flat)[0]
        kl_grad = torch.autograd.grad(kl_fn(flat), flat, create_graph=True)[0]

        def fvp(v):
            return torch.autograd.grad(kl_grad, flat, grad_outputs=v, retain_graph=True)[0] + cfg.cg_damping * v

        step_dir = conjugate_gradient(fvp, g, cfg.cg_iters)
        shs = 0.5 * (step_dir @ fvp(step_dir))
        full_step = torch.sqrt(cfg.max_kl / torch.clamp(shs, min=1e-8)) * step_dir
        with torch.no_grad():
            surr_before = surrogate(p0)
            # backtracking under the KL constraint, the first candidate that
            # improves the surrogate inside the trust region taken on the device
            p_new, accepted = p0, torch.zeros((), dtype=torch.bool, device=p0.device)
            for i in range(cfg.backtrack_iters):
                cand = p0 + cfg.backtrack_coeff ** i * full_step
                ok = (surrogate(cand) - surr_before > 0) & (kl_fn(cand) < cfg.max_kl) & ~accepted
                p_new = torch.where(ok, cand, p_new)
                accepted = accepted | ok
            fp.load_(p_new)
            kl_new = kl_fn(p_new)
        vl = fit_value(value, state["v_opt"], obs_f, ret_f, cfg.value_epochs)
        metrics = {"reward_mean": rewards.mean(), "kl": kl_new, "accepted": accepted.float(), "value_loss": vl}
        return state, final_env, metrics


class ZFilter:
    """Running mean and std normalization of observations (khrylib
    zfilter), as a dict of tensors: count, mean, m2 (Welford updates)."""

    @staticmethod
    def init(dim: int, device="cpu") -> dict:
        return {"count": torch.zeros((), device=device), "mean": torch.zeros(dim, device=device),
                "m2": torch.ones(dim, device=device)}

    @staticmethod
    def update(state: dict, batch: torch.Tensor) -> dict:
        """batch (N, dim)."""
        n = batch.shape[0]
        new_count = state["count"] + n
        delta = batch.mean(0) - state["mean"]
        new_mean = state["mean"] + delta * n / new_count
        new_m2 = state["m2"] + ((batch - state["mean"]) * (batch - new_mean)).sum(0)
        return {"count": new_count, "mean": new_mean, "m2": new_m2}

    @staticmethod
    def apply(state: dict, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        std = torch.sqrt(state["m2"] / torch.clamp(state["count"], min=1.0))
        return torch.clamp((x - state["mean"]) / (std + 1e-8), -clip, clip)
