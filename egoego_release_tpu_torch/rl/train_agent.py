"""The kinematic-policy RL training CLI (port of
egoego_release_tpu/rl/train_agent.py; the reference's ``AgentAR``,
kinpoly/relive/core/agent_ar.py, driven by a statear YAML's policy_specs:
reward_id, reward_weights, gamma / tau, the learning rates, clip_epsilon,
the hidden sizes).

Each iteration samples ``num_envs`` expert windows of the YAML's fr_num
frames (``data.kinpoly.StateARDataset``, in the JAX CLI's order for a
seed), resets the batched ``rl.env.KinematicHumanoidEnv`` on the device to
their first frames and runs one ``rl.ppo.PPOAgent`` iteration. Every
``save_model_interval`` iterations, and at the last, it writes
``iter-<n>.pt`` under ``--save_dir``: the policy's and the value net's
``state_dict``s and their hidden sizes (``load_agent``; JAX writes orbax
directories).

    python -m egoego_release_tpu_torch.rl.train_agent --cfg config/statear/exp.yml \\
        --expert_path mocap_annotations.p --rest_offsets rest.npy [--iters 200] [--num_envs 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from egoego_release_tpu_torch.data.kinpoly import StateARDataset
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.rl.env import KinematicHumanoidEnv
from egoego_release_tpu_torch.rl.ppo import GaussianPolicy, PPOAgent, PPOConfig, ValueNet
from egoego_release_tpu_torch.utils.config import KinpolyConfig
from egoego_release_tpu_torch.utils.device import resolve_device

EXPERT_KEYS = ("qpos", "head_pose", "head_vels")


def make_expert_batch(ds: StateARDataset, num_envs: int, rng, device="cpu") -> dict:
    """``num_envs`` expert windows -> time-major tensors (T, B, ...) on
    ``device`` for the batched env (one copy a key)."""
    items = [ds.sample_seq(int(rng.randint(len(ds)))) for _ in range(num_envs)]
    return {k: torch.as_tensor(np.stack([it[k] for it in items], axis=1), device=device) for k in EXPERT_KEYS}


def build_from_config(cfg: KinpolyConfig, rest_offsets, num_envs: int = 16, device="cuda"):
    """(env, agent) from a statear YAML's policy_specs
    (statear_smpl_config.py's model and policy groups)."""
    ps = cfg.policy_specs
    env = KinematicHumanoidEnv(rest_offsets, reward_id=ps.get("reward_id", "dynamic_supervision_v3"),
                               reward_weights=ps.get("reward_weights"), device=device)
    ppo_cfg = PPOConfig(gamma=float(ps.get("gamma", 0.95)), gae_lambda=float(ps.get("tau", 0.95)),
                        clip_eps=float(ps.get("clip_epsilon", 0.2)), policy_lr=float(ps.get("policy_lr", 5e-5)),
                        value_lr=float(ps.get("value_lr", 3e-4)), epochs=int(ps.get("num_optim_epoch", 5)))
    agent = PPOAgent(env, ppo_cfg, hsize=tuple(ps.get("policy_hsize", [512, 256])),
                     log_std_init=float(ps.get("log_std", -2.3)))
    return env, agent


def save_agent(path: str, state: dict, hsize) -> None:
    torch.save({"policy": {k: v.cpu() for k, v in state["policy"].state_dict().items()},
                "value": {k: v.cpu() for k, v in state["value"].state_dict().items()}, "hsize": list(hsize)}, path)


def load_agent(path: str, device="cpu"):
    """An ``iter-<n>.pt`` -> (GaussianPolicy, ValueNet) on ``device``."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    w = ck["policy"]["fc.weight"]
    obs_dim = ck["policy"]["mlp.affine_layers.0.weight"].shape[1]
    policy = GaussianPolicy(obs_dim, w.shape[0], tuple(ck["hsize"]))
    value = ValueNet(obs_dim, tuple(ck["hsize"]))
    policy.load_state_dict(ck["policy"])
    value.load_state_dict(ck["value"])
    return policy.to(device), value.to(device)


def train(cfg_path: str, expert_path: str, rest_offsets, iters: int = 100, num_envs: int = 16, seed: int = 0,
          save_dir: str | None = None, save_interval: int = 50, log_every: int = 10, init_policy_params=None,
          takes: list[str] | None = None, device="cuda", noise=None) -> dict:
    """``init_policy_params``: a policy ``state_dict`` to start the actor
    from (the reference's AgentAR fine-tunes a supervised ARNet policy; PPO
    from a random 80-d absolute-pose actor has no reward signal). ``takes``:
    the take names to sample windows from (the statear protocol samples
    across a take list, statear_smpl_dataset.py:31). ``noise``: the
    rollouts' action noise (``noise.step``), ``TorchNoise(device, seed)`` by
    default. Returns {"state", "history"} (one dict of floats an
    iteration)."""
    dev = resolve_device(device)
    cfg = KinpolyConfig(cfg_path)
    env, agent = build_from_config(cfg, rest_offsets, num_envs, device=dev)
    fr_num = int(cfg.get("fr_num", 90))
    ds = StateARDataset(expert_path, fr_num=fr_num, train=True, seed=seed, takes=takes)
    assert len(ds) > 0, f"no expert windows of length {fr_num} in {expert_path}"

    rng = np.random.RandomState(seed)
    state = agent.init_state(torch.Generator().manual_seed(seed))
    if init_policy_params is not None:
        state["policy"].load_state_dict(init_policy_params)
        state = agent.state_for(state["policy"], state["value"])
    noise = TorchNoise(dev, seed) if noise is None else noise

    history = []
    for it in range(iters):
        expert = make_expert_batch(ds, num_envs, rng, dev)
        state, _, metrics = agent.iterate(state, noise, env.reset(expert["qpos"][0]), expert)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        if (it + 1) % log_every == 0 or it == 0:
            print(f"iter {it}: reward {metrics['reward_mean']:.4f} alive {metrics['episode_alive']:.2f} "
                  f"ploss {metrics['policy_loss']:.4f}")
        if save_dir and ((it + 1) % save_interval == 0 or it + 1 == iters):
            os.makedirs(save_dir, exist_ok=True)
            save_agent(os.path.join(save_dir, f"iter-{it + 1}.pt"), state, agent.hsize)
    return {"state": state, "history": history}


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True, help="statear experiment YAML")
    p.add_argument("--expert_path", required=True)
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--iters", type=int, default=0, help="override policy_specs.max_iter_num")
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_dir", default="./results/agent")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    from egoego_release_tpu_torch.eval.build import load_rest_offsets

    rest = load_rest_offsets(opt.smplh_path, opt.rest_offsets)
    cfg = KinpolyConfig(opt.cfg)
    iters = opt.iters or int(cfg.policy_specs.get("max_iter_num", 100))
    save_interval = int(cfg.policy_specs.get("save_model_interval", 50))
    return train(opt.cfg, opt.expert_path, rest, iters=iters, num_envs=opt.num_envs, seed=opt.seed,
                 save_dir=opt.save_dir, save_interval=save_interval, device=opt.device)


if __name__ == "__main__":
    main()
