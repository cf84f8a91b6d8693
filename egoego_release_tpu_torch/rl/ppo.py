"""PPO over the batched kinematic humanoid env (port of
egoego_release_tpu/rl/ppo.py; the reference's khrylib RL core,
kinpoly/copycat/khrylib/rl/agents/{agent,agent_ppo}.py, policy_gaussian.py,
critic.py and core/common.py's GAE).

A diagonal-Gaussian MLP policy (or the UHC's mixture of primitives) and a
value MLP, GAE(lambda) advantages and the clipped PPO objective. One
iteration is a rollout of ``horizon`` steps of every env at once (JAX: a
``lax.scan`` over time of a vmap over envs, jitted with the updates; here a
Python loop whose steps queue on the device without a host sync), then
``epochs`` full-batch Adam steps of the policy and of the value net. The
products run on cuBLAS in f32 (``torch.matmul``), as JAX computes them
outside Pallas: nothing here reaches a kernel of the port's.

Randomness comes from outside: the rollout draws its action noise with
``noise.step(shape)`` (``ops.fused_step.TorchNoise`` in the CLI), so that a
test can replay JAX's key stream.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from egoego_release_tpu_torch.models.init import flax_init_
from egoego_release_tpu_torch.models.mlp import MLP
from egoego_release_tpu_torch.rl.env import EnvState, KinematicHumanoidEnv


class GaussianPolicy(nn.Module):
    """MLP -> mean; a state-independent log_std (policy_gaussian.py)."""

    def __init__(self, obs_dim: int, action_dim: int, hsize=(512, 256), log_std_init: float = -2.3):
        super().__init__()
        self.mlp = MLP(obs_dim, tuple(hsize), "relu")
        self.fc = nn.Linear(self.mlp.out_dim, action_dim)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(log_std_init)))

    def forward(self, obs: torch.Tensor):
        return self.fc(self.mlp(obs)), self.log_std


class MCPPolicy(nn.Module):
    """The mixture-of-primitives actor (copycat/core/policy_mcp.py:9-38, the
    UHC configs' actor_type "mcp"): K primitive MLPs, each emitting an
    action mean from an output layer initialized at 0.1 of its scale (the
    reference's weight.mul_(0.1)), blended by a softmax composer MLP; a
    state-independent log_std. The same (mean, log_std) interface as
    ``GaussianPolicy``."""

    def __init__(self, obs_dim: int, action_dim: int, num_primitive: int = 8, hsize=(512, 256),
                 composer_hsize=(300, 200), log_std_init: float = -2.3):
        super().__init__()
        self.primitives = nn.ModuleList(MLP(obs_dim, tuple(hsize), "relu") for _ in range(num_primitive))
        self.primitive_outs = nn.ModuleList(nn.Linear(hsize[-1], action_dim) for _ in range(num_primitive))
        self.composer = MLP(obs_dim, tuple(composer_hsize), "relu")
        self.composer_out = nn.Linear(self.composer.out_dim, num_primitive)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(log_std_init)))

    def forward(self, obs: torch.Tensor):
        means = torch.stack([out(mlp(obs)) for mlp, out in zip(self.primitives, self.primitive_outs)], dim=-2)
        weight = torch.softmax(self.composer_out(self.composer(obs)), dim=-1)  # (..., K)
        return (weight[..., None] * means).sum(-2), self.log_std


def make_policy(obs_dim: int, action_dim: int, hsize=(512, 256), actor_type: str = "gauss",
                num_primitive: int = 8, log_std_init: float = -2.3) -> nn.Module:
    """actor_type 'gauss' (relive PolicyGaussian) or 'mcp' (UHC PolicyMCP)."""
    if actor_type == "mcp":
        return MCPPolicy(obs_dim, action_dim, num_primitive=num_primitive, hsize=tuple(hsize),
                         log_std_init=log_std_init)
    return GaussianPolicy(obs_dim, action_dim, tuple(hsize), log_std_init)


class ValueNet(nn.Module):
    def __init__(self, obs_dim: int, hsize=(512, 256)):
        super().__init__()
        self.mlp = MLP(obs_dim, tuple(hsize), "relu")
        self.fc = nn.Linear(self.mlp.out_dim, 1)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.fc(self.mlp(obs))[..., 0]


@torch.no_grad()
def init_rl_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's defaults drawn from ``generator`` (``models.init.flax_init_``:
    LeCun-normal kernels, zero biases), the MCP primitives' output layers
    LeCun-uniform at 0.1 of their scale; log_std keeps its value. The
    draws are torch's: weights for parity come through ``utils.convert``."""
    flax_init_(module, generator)
    if isinstance(module, MCPPolicy):
        for out in module.primitive_outs:
            limit = math.sqrt(3.0 / out.weight.shape[1])
            u = torch.rand(out.weight.shape, generator=generator, dtype=torch.float64)
            out.weight.copy_(((2 * u - 1) * limit * 0.1).float())
    return module


def optax_adam(module: nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8 outside the square root)
    over ``module``'s parameters."""
    params = list(module.parameters())
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=params[0].is_cuda)


@dataclass(frozen=True)
class PPOConfig:
    horizon: int = 32
    gamma: float = 0.95
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    policy_lr: float = 5e-5
    value_lr: float = 3e-4
    epochs: int = 5


def gaussian_logprob(mean: torch.Tensor, log_std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi))).sum(-1)


def gae_advantages(rewards, values, last_value, dones, gamma: float, lam: float):
    """GAE(lambda) over (T, B) tensors (core/common.py estimate_advantages),
    a reverse loop over T (JAX: a reverse scan). Returns (advantages,
    returns)."""
    adv_next, v_next = torch.zeros_like(last_value), last_value
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t].float()
        delta = rewards[t] + gamma * v_next * nonterminal - values[t]
        adv_next = delta + gamma * lam * nonterminal * adv_next
        v_next = values[t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def rollout(env: KinematicHumanoidEnv, policy: nn.Module, value: nn.Module, noise, env_state: EnvState,
            expert: dict, horizon: int):
    """``horizon`` steps of every env (JAX ``rl/ppo.py:163``): per step the
    observation, the policy's Gaussian action (``noise.step`` draws its
    noise), its log-probability, the value, then the env's step. Returns
    (the final state, (obs, actions, logps, values, rewards, dones) stacked
    over time)."""
    cols = [[] for _ in range(6)]
    with torch.no_grad():
        for _ in range(horizon):
            obs = env.obs(env_state, expert)
            mean, log_std = policy(obs)
            action = mean + torch.exp(log_std) * noise.step(tuple(mean.shape)).to(mean.device, mean.dtype)
            logp = gaussian_logprob(mean, log_std, action)
            v = value(obs)
            env_state, reward, done = env.step(env_state, action, expert)
            for col, x in zip(cols, (obs, action, logp, v, reward, done)):
                col.append(x)
    return env_state, tuple(torch.stack(c) for c in cols)


def advantages_and_returns(env, value, final_env, expert, values, rewards, dones, gamma, lam):
    """GAE over the rollout, bootstrapped from the final state's value, with
    the advantages normalized over the whole batch (std with ddof 0, as
    jnp.std)."""
    with torch.no_grad():
        last_value = value(env.obs(final_env, expert))
    advs, returns = gae_advantages(rewards, values, last_value, dones, gamma, lam)
    return (advs - advs.mean()) / (advs.std(correction=0) + 1e-8), returns


def fit_value(value: nn.Module, opt: torch.optim.Optimizer, obs_f, ret_f, epochs: int) -> torch.Tensor:
    """``epochs`` full-batch Adam steps on the squared error; returns the
    loss of the last, before its step."""
    for _ in range(epochs):
        opt.zero_grad(set_to_none=False)
        vl = ((value(obs_f) - ret_f) ** 2).mean()
        vl.backward()
        opt.step()
    return vl.detach()


def clipped_epochs(state: dict, obs_f, act_f, logp_f, adv_f, ret_f, epochs: int, clip_eps: float):
    """``epochs`` full-batch Adam steps of the policy's clipped objective,
    each followed by one of the value's squared error (JAX: a ``lax.scan``
    over the epochs). Updates ``state``'s modules and optimizers in place;
    returns the last epoch's losses, before its steps, as device scalars."""
    policy, p_opt = state["policy"], state["p_opt"]
    for _ in range(epochs):
        p_opt.zero_grad(set_to_none=False)
        mean, log_std = policy(obs_f)
        ratio = torch.exp(gaussian_logprob(mean, log_std, act_f) - logp_f)
        clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps)
        pl = -torch.minimum(ratio * adv_f, clipped * adv_f).mean()
        pl.backward()
        p_opt.step()
        vl = fit_value(state["value"], state["v_opt"], obs_f, ret_f, 1)
    return pl.detach(), vl


def merge_time(x: torch.Tensor) -> torch.Tensor:
    """(T, B, ...) -> (T B, ...): a rollout's steps as one batch."""
    return x.reshape((-1,) + x.shape[2:])


class PPOAgent:
    def __init__(self, env: KinematicHumanoidEnv, cfg: PPOConfig = PPOConfig(), hsize=(512, 256),
                 log_std_init: float = -2.3):
        self.env = env
        self.cfg = cfg
        self.hsize = tuple(hsize)
        self.log_std_init = log_std_init

    def init_state(self, generator: torch.Generator) -> dict:
        """The policy, the value net (flax's initializers drawn from
        ``generator``, ``init_rl_module_``) on the env's device, and an
        Adam for each."""
        env = self.env
        policy = init_rl_module_(GaussianPolicy(env.obs_dim, env.action_dim, self.hsize, self.log_std_init),
                                 generator).to(env.device)
        value = init_rl_module_(ValueNet(env.obs_dim, self.hsize), generator).to(env.device)
        return self.state_for(policy, value)

    def state_for(self, policy: nn.Module, value: nn.Module) -> dict:
        """An iteration state over given modules, with fresh optimizers."""
        return {"policy": policy, "value": value, "p_opt": optax_adam(policy, self.cfg.policy_lr),
                "v_opt": optax_adam(value, self.cfg.value_lr)}

    def iterate(self, state: dict, noise, env_state: EnvState, expert: dict):
        """One PPO iteration (JAX ``rl/ppo.py:179-228``): the rollout, GAE,
        then ``epochs`` steps of the policy's clipped objective and of the
        value's squared error, each one Adam step on the whole batch.
        Updates ``state``'s modules and optimizers in place and returns
        (state, the final env state, metrics as device scalars)."""
        cfg, env = self.cfg, self.env
        expert = env.prepare_expert(expert)  # the expert's FK once, not every step
        policy, value = state["policy"], state["value"]
        final_env, (obs, actions, logps, values, rewards, dones) = rollout(
            env, policy, value, noise, env_state, expert, cfg.horizon)
        advs_n, returns = advantages_and_returns(env, value, final_env, expert, values, rewards, dones, cfg.gamma,
                                                 cfg.gae_lambda)
        obs_f, act_f, logp_f, adv_f, ret_f = map(merge_time, (obs, actions, logps, advs_n, returns))
        pl, vl = clipped_epochs(state, obs_f, act_f, logp_f, adv_f, ret_f, cfg.epochs, cfg.clip_eps)
        metrics = {"reward_mean": rewards.mean(), "episode_alive": 1.0 - dones[-1].float().mean(),
                   "policy_loss": pl, "value_loss": vl}
        return state, final_env, metrics
