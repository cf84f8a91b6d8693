"""PPO training over the PHYSICS imitation env, host rollouts (port of
egoego_release_tpu/rl/train_physics_agent.py).

The reference trains its control policies by farming MuJoCo rollouts to CPU
multiprocessing workers and updating with PPO
(copycat/khrylib/rl/agents/{agent,agent_ppo}.py, relive/core/agent_ar.py).
MuJoCo steps on the host, so this trainer keeps that split: rollouts run
host-side against rl/imitation.PhysicsImitation, and the policy / value
updates are the kinematic PPO's (rl/ppo.py: the policies, GAE, the clipped
objective, optax's Adam) on ``device``, with autograd where JAX jits a
``lax.scan`` over the epochs. Every control step makes one ``act`` call:
the observation goes to the device, the policy's sample, its
log-probability and the value come back in one copy. The products run on
cuBLAS in f32 (``torch.matmul``), as JAX computes them outside Pallas:
nothing here reaches a kernel of the port's.

Randomness comes from outside: a noise source whose ``step(shape)`` draws
the action noise and whose ``split(k)`` gives each parallel rollout its
own (``ops.fused_step.TorchNoise`` in the CLI), so that a test can replay
JAX's key stream.

  python -m egoego_release_tpu_torch.rl.train_physics_agent \\
      --xml kinpoly/assets/mujoco_models/humanoid_smpl_neutral_mesh.xml \\
      --expert_path mocap_annotations.p [--iters 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from egoego_release_tpu_torch.rl.imitation import PhysicsImitation
from egoego_release_tpu_torch.rl.ppo import (
    ValueNet,
    clipped_epochs,
    gae_advantages,
    gaussian_logprob,
    init_rl_module_,
    make_policy,
    optax_adam,
)
from egoego_release_tpu_torch.rl.trpo import ZFilter


def physics_obs_dim(env, obs_v: int | None = None, obs_specs: dict | None = None) -> int:
    """The observation width for ``env`` (an env or anything with its
    ``model.nq``, ``model.nbody``, ``nv`` and ``ndof``): the proprioceptive
    default, or the UHC contract of ``obs_v`` 0/1/2 (JAX
    ``rl/train_physics_agent.py:59-72``)."""
    ndof, nq, nv = env.ndof, env.model.nq, env.nv
    if obs_v is None:
        return (nq - 2) + nv + ndof
    from egoego_release_tpu_torch.rl.uhc_obs import DEFAULT_OBS_SPECS

    s = dict(DEFAULT_OBS_SPECS, **(obs_specs or {}))
    nb = min(env.model.nbody, 25) - 1
    vel = 6 if s["obs_vel"] == "root" else nv
    if obs_v == 0:
        return int(s["obs_heading"]) + (nq - 2) + vel + (nq - 7) + int(s["obs_phase"])
    return (4 + 3 * (nq - 2) + vel + 1 + 2 + 2 * (3 * nb) + 2 * (4 * nb)
            + (2 * (3 * nb) if obs_v == 1 else 0))


class PhysicsPPO:
    """Host-rollout PPO over PhysicsImitation.

    Observation: by default the env's proprioceptive state + target
    differences (heading-free qpos, qvel, target joint offsets); pass
    obs_v=0/1/2 to use the exact UHC observation contract
    (humanoid_im.py get_full_obs/get_full_obs_v1/get_full_obs_v2, in
    rl/uhc_obs.py — obs_v 2 is the bundled copycat.yml config), which makes
    the policy input layout checkpoint-compatible.

    The modules live in the state (``init_state`` / ``state_for``) on the
    session's ``device``, and so does the observation filter (``ZFilter``).
    """

    def __init__(self, sess: PhysicsImitation, hsize=(256, 128),
                 gamma=0.95, lam=0.95, clip_eps=0.2,
                 policy_lr=5e-5, value_lr=3e-4, epochs=5,
                 actor_type="gauss", num_primitive=8,
                 obs_v=None, obs_specs=None):
        self.sess = sess
        self.device = sess.device
        self.obs_v = obs_v
        self.obs_specs = obs_specs
        self.obs_dim = physics_obs_dim(sess.env, obs_v, obs_specs)
        self.action_dim = sess.env.action_dim
        self.hsize = tuple(hsize)
        self.gamma, self.lam, self.clip_eps, self.epochs = gamma, lam, clip_eps, epochs
        self.policy_lr, self.value_lr = policy_lr, value_lr
        # actor_type "mcp" = the UHC configs' mixture-of-primitives actor
        # (copycat.yml actor_type: mcp, num_primitive: 8)
        self.actor_type, self.num_primitive = actor_type, num_primitive
        self.zfilter = ZFilter.init(self.obs_dim, self.device)

    # -- state ------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> dict:
        """The policy and the value net (flax's initializers drawn from
        ``generator``, ``ppo.init_rl_module_``) on the device, and an Adam
        for each."""
        policy = make_policy(self.obs_dim, self.action_dim, self.hsize, self.actor_type,
                             num_primitive=self.num_primitive)
        policy = init_rl_module_(policy, generator).to(self.device)
        value = init_rl_module_(ValueNet(self.obs_dim, self.hsize), generator).to(self.device)
        return self.state_for(policy, value)

    def state_for(self, policy, value) -> dict:
        """An iteration state over given modules, with fresh optimizers."""
        return {"policy": policy, "value": value, "p_opt": optax_adam(policy, self.policy_lr),
                "v_opt": optax_adam(value, self.value_lr)}

    # -- acting -----------------------------------------------------------

    def obs(self, target_qpos: np.ndarray, sess=None, cur_t: int = 0) -> np.ndarray:
        sess = sess or self.sess
        if self.obs_v is not None:
            from egoego_release_tpu_torch.rl import uhc_rewards as U
            from egoego_release_tpu_torch.rl.uhc_obs import uhc_observation

            assert sess._expert is not None, "obs_v needs set_expert()"
            cur = {
                "qpos": sess.env.get_qpos(),
                "qvel": sess.env.get_qvel(),
                "wbpos": U.env_wbpos(sess.env),
                "body_com": U.env_body_com(sess.env),
                "wbquat": U.env_wbquat(sess.env),
            }
            return uhc_observation(cur, sess._expert, cur_t,
                                   obs_v=self.obs_v,
                                   specs=self.obs_specs).astype(np.float32)
        qpos = sess.env.get_qpos()
        qvel = sess.env.get_qvel()
        return np.concatenate(
            [qpos[2:], qvel, target_qpos[7:] - qpos[7:]]
        ).astype(np.float32)

    @torch.no_grad()
    def act(self, state: dict, zf: dict, raw: np.ndarray, noise):
        """One control step's policy call (JAX's jitted ``act_fn``,
        ``:89-96``): the raw observation to the device, filtered by the
        snapshot ``zf``, the policy's mean and std, a Gaussian sample with
        ``noise.step``'s draw, its log-probability and the value; one copy
        back. Returns (the filtered observation, the action) as numpy and
        (logp, value) as floats."""
        o = ZFilter.apply(zf, torch.as_tensor(raw, device=self.device))
        mean, log_std = state["policy"](o[None])
        a = mean + torch.exp(log_std) * noise.step(tuple(mean.shape)).to(mean.device, mean.dtype)
        logp = gaussian_logprob(mean, log_std, a)
        val = state["value"](o[None])
        host = torch.cat([o.to(a.dtype), a[0], logp, val]).cpu().numpy()
        n = o.shape[0]
        return host[:n], host[n:-2], float(host[-2]), float(host[-1])

    @torch.no_grad()
    def value_of(self, state: dict, zf: dict, raw: np.ndarray) -> float:
        """The value of a filtered raw observation (a rollout's bootstrap)."""
        o = ZFilter.apply(zf, torch.as_tensor(raw, device=self.device))
        return float(state["value"](o[None])[0])

    # -- rollouts ---------------------------------------------------------

    def collect(self, state, noise, qpos0: np.ndarray, targets: np.ndarray,
                horizon: int, sess=None, qvel0: np.ndarray | None = None,
                on_fail: str = "break",
                fail_qvels: np.ndarray | None = None) -> dict:
        """One host rollout tracking a (T, 76) kinematic target sequence.

        The observation filter is applied as a per-iteration SNAPSHOT (the
        caller batch-updates it with the raw observations afterwards), so
        concurrent rollouts see consistent normalization.  qvel0 seeds the
        initial joint velocities (the reference's expert-state resets —
        humanoid_im.py reset_model uses expert qvel); default zeros.

        on_fail: what a mid-rollout termination (body_diff past the
        threshold) does during TRAINING collection:
          "break"    — end the rollout (the reference's done -> new episode)
          "failsafe" — reset the sim to the expert state at the NEXT frame
                       and keep collecting the same window — the
                       reference's fail_safe playback
                       (copycat/envs/humanoid_im.py:267; relive
                       ar_fail_safe, humanoid_ar_v1.py:642) applied at
                       TRAINING time. The failure step keeps done=True in
                       the batch, so GAE does not bootstrap across the
                       reset.
        fail_qvels: (T, qvel_dim) expert finite-difference velocities used
        to seed fail-safe resets; zeros when absent.
        """
        sess = sess or self.sess
        zf = self.zfilter
        sess.reset(qpos0, qvel0)
        if (sess.uhc_reward is not None or sess.sim_reward is not None
                or self.obs_v is not None):
            # UHC/relive sim rewards and the UHC obs contract score against
            # the expert trajectory at the step's time index (copycat
            # get_expert_index) — the kinematic targets ARE the expert here
            sess.set_expert(np.asarray(targets))
            sess.reset(qpos0, qvel0)  # set_expert restores state; re-seed
        raw_l, obs_l, act_l, logp_l, val_l, rew_l, done_l = [], [], [], [], [], [], []
        for t in range(horizon):
            ind = min(t, len(targets) - 1)
            target = targets[ind]
            raw = self.obs(target, sess, cur_t=ind)
            o, a, logp, val = self.act(state, zf, raw, noise)
            r, done, _ = sess.step(a, target, expert_ind=ind)
            raw_l.append(raw); obs_l.append(o); act_l.append(a)
            logp_l.append(logp); val_l.append(val)
            rew_l.append(r); done_l.append(done)
            if done:
                if on_fail == "failsafe" and t < horizon - 1:
                    nxt = min(ind + 1, len(targets) - 1)
                    qv = (fail_qvels[min(nxt, len(fail_qvels) - 1)]
                          if fail_qvels is not None else None)
                    sess.reset(np.asarray(targets[nxt], np.float64), qv)
                    continue
                break
        last_val = self.value_of(state, zf, self.obs(targets[-1], sess, cur_t=len(targets) - 1))
        return batch_of(raw_l, obs_l, act_l, logp_l, val_l, rew_l, done_l, last_val)

    # -- updates ----------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        """A batch array on the device; floats keep their dtype (JAX's
        ``jnp.asarray``), so f32 rewards promote against a float64 module
        as in JAX under x64."""
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _gae(self, batch: dict):
        """GAE over one rollout on the host, in the batch's f32 (JAX's scan
        carries the rewards' dtype, so the bootstrap value rounds to it):
        a loop of a few scalar operations a step, which would be as many
        launches on the card. -> (advantages, returns), each (T,)."""
        rewards = torch.from_numpy(batch["rewards"][:, None])
        last = torch.tensor([batch["last_value"]], dtype=rewards.dtype)
        advs, returns = gae_advantages(rewards, torch.from_numpy(batch["values"][:, None]), last,
                                       torch.from_numpy(batch["dones"][:, None]), self.gamma, self.lam)
        return advs[:, 0], returns[:, 0]

    def update(self, state: dict, batch: dict):
        """GAE over one rollout, the advantages normalized (std with ddof
        0, as jnp.std), then ``flat_update`` (JAX ``_update_impl``,
        ``:203-214``)."""
        advs, returns = self._gae(batch)
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        t = self._tensor
        return self.flat_update(state, t(batch["obs"]), t(batch["actions"]), t(batch["logps"]), t(advs), t(returns))

    def flat_update(self, state: dict, obs, act, logp_old, adv_f, ret_f):
        """``ppo.clipped_epochs`` over the whole batch (JAX
        ``_flat_update_impl``, ``:216-242``) -> (state, the last epoch's
        losses as device scalars)."""
        pl, vl = clipped_epochs(state, obs, act, logp_old, adv_f, ret_f, self.epochs, self.clip_eps)
        return state, {"policy_loss": pl, "value_loss": vl}

    def _filter_update(self, raw_obs: np.ndarray) -> None:
        self.zfilter = ZFilter.update(self.zfilter, torch.as_tensor(raw_obs, device=self.device))

    def iterate(self, state, noise, *rollout):
        """One PPO iteration on one rollout -> (state, metrics). rollout:
        ``collect``'s arguments after the noise (qpos0, targets, horizon;
        ARAgentPPO's ar_context, horizon)."""
        batch = self.collect(state, noise, *rollout)
        self._filter_update(batch["raw_obs"])
        state, losses = self.update(state, batch)
        return state, {
            "reward_mean": float(batch["rewards"].mean()),
            "episode_len": len(batch["rewards"]),
            **{k: float(v) for k, v in losses.items()},
        }

    def iterate_parallel(self, state, noise, tasks, horizon: int,
                         num_threads: int = 4, on_fail: str = "break"):
        """One PPO iteration over several rollouts collected concurrently —
        the reference's multiprocess `agent.sample`
        (copycat/khrylib/rl/agents/agent.py:107-131) as threads: MuJoCo
        stepping releases the GIL, each worker gets its own env clone and
        its own noise source (``noise.split``, where JAX splits its key),
        and the policy/value/ZFilter are read-only snapshots during
        collection.

        tasks: list of (qpos0, targets), (qpos0, targets, qvel0), or
        (qpos0, targets, qvel0, fail_qvels) tuples; on_fail/fail_qvels as
        in collect (training-time fail-safe resets).
        """
        import concurrent.futures as cf

        sessions = [self.sess] + [self.sess.clone() for _ in range(len(tasks) - 1)]
        noises = noise.split(len(tasks))

        def roll(i):
            qpos0, targets, *rest = tasks[i]
            return self.collect(state, noises[i], qpos0, targets, horizon, sess=sessions[i],
                                qvel0=rest[0] if rest else None, on_fail=on_fail,
                                fail_qvels=rest[1] if len(rest) > 1 else None)

        with cf.ThreadPoolExecutor(max_workers=num_threads) as ex:
            batches = list(ex.map(roll, range(len(tasks))))
        return self.update_batches(state, batches)

    def update_batches(self, state, batches: list[dict]):
        """The rest of ``iterate_parallel`` (JAX ``:292-317``): the filter
        updated once from every raw observation, GAE per rollout, the
        advantages normalized over all of them (numpy, as JAX), then one
        ``flat_update`` over everything -> (state, metrics)."""
        self._filter_update(np.concatenate([b["raw_obs"] for b in batches]))
        adv_l, ret_l = zip(*(map(torch.Tensor.numpy, self._gae(b)) for b in batches))
        adv = np.concatenate(adv_l)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        cat = lambda k: self._tensor(np.concatenate([b[k] for b in batches]))
        state, losses = self.flat_update(state, cat("obs"), cat("actions"), cat("logps"), self._tensor(adv),
                                         self._tensor(np.concatenate(ret_l)))
        rewards = np.concatenate([b["rewards"] for b in batches])
        return state, {
            "reward_mean": float(rewards.mean()),
            "num_rollouts": len(batches),
            "total_steps": int(rewards.shape[0]),
            **{k: float(v) for k, v in losses.items()},
        }


def batch_of(raw_l, obs_l, act_l, logp_l, val_l, rew_l, done_l, last_val) -> dict:
    """A rollout's lists as JAX's batch dict, in its dtypes (log-probs,
    values and rewards f32)."""
    return {
        "raw_obs": np.stack(raw_l),
        "obs": np.stack(obs_l), "actions": np.stack(act_l),
        "logps": np.asarray(logp_l, np.float32),
        "values": np.asarray(val_l, np.float32),
        "rewards": np.asarray(rew_l, np.float32),
        "dones": np.asarray(done_l),
        "last_value": last_val,
    }


class ARAgentPPO(PhysicsPPO):
    """PPO fine-tuning of the AR (kinematic) policy THROUGH the physics loop
    — the reference's AgentAR physics training mode (relive/core/agent_ar.py
    driving HumanoidAREnv.step): the cc controller inside ARPhysicsSession is
    frozen; the learned policy outputs 80-dim AR actions (step_ar layout)
    and observes get_ar_obs_v1.  Reuses the PhysicsPPO GAE/clipped-update
    machinery with AR-loop rollouts; the actor is Gaussian."""

    def __init__(self, ar_sess, obs_dim: int, hsize=(256, 128), **kw):
        from egoego_release_tpu_torch.models.trajar import ACTION_DIM

        super().__init__(ar_sess.im, hsize=hsize, **kw)
        self.ar_sess = ar_sess
        self.obs_dim = obs_dim
        self.action_dim = ACTION_DIM
        self.actor_type = "gauss"
        self.zfilter = ZFilter.init(obs_dim, self.device)

    def collect(self, state, noise, ar_context: dict, horizon: int, sess=None) -> dict:
        sess = sess or self.ar_sess
        zf = self.zfilter
        sess.set_context(ar_context)
        sess.reset(np.asarray(ar_context["qpos"][0]))
        raw = sess.ar_obs()
        raw_l, obs_l, act_l, logp_l, val_l, rew_l, done_l = [], [], [], [], [], [], []
        for _ in range(horizon):
            o, a, logp, val = self.act(state, zf, raw, noise)
            next_raw, r, done, _ = sess.step(a)
            raw_l.append(raw); obs_l.append(o); act_l.append(a)
            logp_l.append(logp); val_l.append(val)
            rew_l.append(r); done_l.append(done)
            raw = next_raw
            if done:
                break
        return batch_of(raw_l, obs_l, act_l, logp_l, val_l, rew_l, done_l, self.value_of(state, zf, raw))


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--xml", required=True)
    p.add_argument("--expert_path", required=True)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--horizon", type=int, default=90)
    p.add_argument("--reward_id", default="dynamic_supervision_v4")
    p.add_argument("--obs_v", type=int, default=None, choices=(0, 1, 2),
                   help="UHC observation contract (humanoid_im get_full_obs*)"
                        "; default keeps the proprioceptive obs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the policy, its updates and the per-step reward; MuJoCo and the control laws on the host")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """The JAX CLI's loop: one expert window a PPO iteration. Returns
    {"state", "history"} (one dict of floats an iteration)."""
    from egoego_release_tpu_torch.data.kinpoly import StateARDataset
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise
    from egoego_release_tpu_torch.utils.device import resolve_device

    args = parse_opt(argv)
    dev = resolve_device(args.device)
    sess = PhysicsImitation(args.xml, reward_id=args.reward_id, device=dev)
    agent = PhysicsPPO(sess, obs_v=args.obs_v)
    ds = StateARDataset(args.expert_path, fr_num=args.horizon, train=True,
                        seed=args.seed)
    state = agent.init_state(torch.Generator().manual_seed(args.seed))
    noise = TorchNoise(dev, args.seed)
    history = []
    for it in range(args.iters):
        rec = ds.sample_seq()
        state, m = agent.iterate(state, noise, rec["qpos"][0], rec["qpos"], args.horizon)
        history.append(m)
        print(f"iter {it}: reward {m['reward_mean']:.4f} len {m['episode_len']} "
              f"ploss {m['policy_loss']:.4f}", flush=True)
    return {"state": state, "history": history}


if __name__ == "__main__":
    main()
