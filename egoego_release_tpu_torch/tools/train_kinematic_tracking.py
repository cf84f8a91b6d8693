"""Capability run of the kinematic AR policy: train it to track expert motion
and score the tracking (port of tools/train_kinematic_tracking.py).

1. The demo sequence (demo_ares_data.p, AMASS-retargeted motion) becomes a
   kinpoly expert record (qpos, qvel, head pose and velocities) through
   ``preprocess.qpos``.
2. The 80-wide AR policy of a statear YAML's policy_specs
   (``rl.train_agent.build_from_config``) is pretrained by behaviour cloning
   (``bc_pretrain``: a regression on the inverse dynamics, then closed-loop
   supervision through its own rollouts) and fine-tuned by PPO in the
   batched kinematic env (``rl.train_agent.train``).
3. A deterministic (mean-action) rollout over the whole sequence scores the
   per-frame FK error against the expert (``eval_tracking``): root-centred
   MPJPE, global MPJPE and the head distance, in mm.

Modes, as the JAX tool's: ``KIN_HOLDOUT=n`` trains on frames [0, n) and
scores the unseen tail two ways; ``KIN_CROSS_TAKE=1`` trains on one take
and cold-starts the other (the demo and standing_neutral.pkl, both
directions; BC only); ``KIN_MULTI_TAKE=1`` trains one policy jointly on
take lists with mirrored and rotated variants (``preprocess.augment``) and
runs a take-list PPO leg. Everything runs on ``--device`` (the card unless
``--device cpu`` is given); one JSON line of results comes last.

    python -m egoego_release_tpu_torch.tools.train_kinematic_tracking [--device cpu] \\
        --demo demo_ares_data.p --neutral standing_neutral.pkl --cfg statear.yml [--work_dir DIR]
    KIN_ITERS=50 KIN_ENVS=8 KIN_BC_STEPS=2000 python -m egoego_release_tpu_torch.tools.train_kinematic_tracking
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from egoego_release_tpu_torch.data.formats import load_pickle, save_pickle
from egoego_release_tpu_torch.models.trajar import QVEL_DIM, inverse_step_qpos, step_qpos
from egoego_release_tpu_torch.preprocess.qpos import convert_motion_pickle, motion_to_expert
from egoego_release_tpu_torch.rl import train_agent as ta
from egoego_release_tpu_torch.rl.env import EnvState
from egoego_release_tpu_torch.rl.ppo import GaussianPolicy, init_rl_module_, optax_adam
from egoego_release_tpu_torch.tools._data import tool_rest_offsets
from egoego_release_tpu_torch.utils.device import resolve_device

ACTION_CLIP, TARGET_CLIP, ROOT_VEL_WEIGHT = 20.0, 12.0, 5.0


def neutral_expert_record(rest_offsets, path: str, device="cuda") -> dict:
    """kinpoly's standing_neutral.pkl -> an expert record through the demo's
    codec (``neutral_motion``); the take is joint-space sway."""
    rec = motion_to_expert(*neutral_motion(path), np.asarray(rest_offsets), device=device)
    rec["seq_name"] = "standing_neutral"
    return rec


def _tensor(env, a) -> torch.Tensor:
    """A record's array on the env's device, in its own float dtype (f32 in
    the records the tool makes)."""
    return torch.as_tensor(np.asarray(a), device=env.device)


def _expert_tensors(env, rec: dict, envs: int = 1) -> dict:
    """A record's qpos, head pose and head velocities as time-major (T, envs,
    ...) tensors on the env's device."""
    return {k: _tensor(env, rec[k])[:, None].expand(-1, envs, -1).contiguous() for k in ta.EXPERT_KEYS}


@torch.no_grad()
def eval_tracking(env, agent, state, expert_rec, rest_offsets, start=0) -> dict:
    """Deterministic mean-action rollout from frame ``start`` to the end of
    the sequence; per-frame FK error against the expert. ``start`` > 0 rolls
    from the expert's state at that frame with zero velocity (a cold start
    at a take boundary). No fail-safe freeze: the claim is the raw rollout.
    A Python loop where JAX scans."""
    expert = _expert_tensors(env, expert_rec)
    qpos_e = expert["qpos"]
    t_total = qpos_e.shape[0]
    policy = state["policy"]
    st = EnvState(qpos=qpos_e[start], qvel=qpos_e.new_zeros(1, QVEL_DIM),
                  t=torch.full((1,), start, dtype=torch.int64, device=env.device),
                  done=torch.zeros(1, dtype=torch.bool, device=env.device))
    traj = [qpos_e[start]]
    for _ in range(t_total - 1 - start):
        mean, _ = policy(env.obs(st, expert))
        nq, nv = step_qpos(st.qpos, torch.clamp(mean, -ACTION_CLIP, ACTION_CLIP))
        st = EnvState(qpos=nq, qvel=nv, t=st.t + 1, done=st.done)
        traj.append(nq)
    _, pred_jpos = env._body_pose(torch.cat(traj, dim=0))
    _, gt_jpos = env._body_pose(qpos_e[start:, 0])
    per_frame = root_centred_mpjpe(pred_jpos, gt_jpos)
    return {"mpjpe_mm": float(per_frame.mean()),
            "global_mpjpe_mm": float(torch.linalg.norm(pred_jpos - gt_jpos, dim=-1).mean() * 1000.0),
            "head_dist_mm": float(torch.linalg.norm(pred_jpos[:, 15] - gt_jpos[:, 15], dim=-1).mean() * 1000.0),
            "per_frame_mpjpe_mm": per_frame.cpu().numpy()}


def root_centred_mpjpe(pred_jpos, gt_jpos) -> torch.Tensor:
    """Per-frame root-centred MPJPE in mm of (T, J, 3) joint positions
    (eval_metrics_imu_rec.py:297-301)."""
    pred_c, gt_c = pred_jpos - pred_jpos[:, 0:1], gt_jpos - gt_jpos[:, 0:1]
    return torch.linalg.norm(pred_c - gt_c, dim=-1).mean(-1) * 1000.0


@torch.no_grad()
def one_step_tracking(env, state, expert_rec) -> np.ndarray:
    """Teacher-forced tracking: from each expert state (phase 1's
    observations, ``regression_data``) one step of the policy's mean,
    clipped to +-20; the root-centred MPJPE in mm of each stepped frame
    against the next expert frame, (T-1,). Unlike ``eval_tracking``'s free
    rollout, no error compounds, so it holds a policy at any magnitude."""
    obs, _ = regression_data(env, [expert_rec])
    qpos = _tensor(env, expert_rec["qpos"])
    mean, _ = state["policy"](obs)
    nq, _ = step_qpos(qpos[:-1], torch.clamp(mean, -ACTION_CLIP, ACTION_CLIP))
    return root_centred_mpjpe(env._body_pose(nq)[1], env._body_pose(qpos[1:])[1]).cpu().numpy()


def cl_learning_rate(count: int, lr: float, cl_steps: int) -> float:
    """optax.cosine_decay_schedule(0.3 lr, cl_steps, alpha=0.05) at update
    ``count`` (from 0: optax reads the count before it increments it): the
    cosine from 0.3 lr down to its floor 0.05 x 0.3 lr, held past cl_steps."""
    c = min(count, cl_steps)
    return lr * 0.3 * ((1 - 0.05) * 0.5 * (1 + math.cos(math.pi * c / cl_steps)) + 0.05)


def regression_data(env, recs: list[dict]):
    """Phase 1's batch: every expert step of every take as one env (t indexes
    the expert), its observation and the exact inverse-dynamics target
    (``inverse_step_qpos`` of consecutive frames). Returns (obs, target)."""
    obs_parts, target_parts = [], []
    for rec in recs:
        qpos, qvel_fd = _tensor(env, rec["qpos"]), _tensor(env, rec["qvel"])
        b = qpos.shape[0] - 1
        # the state velocity at step t is the one that produced qpos_t (zero at 0)
        qvel = torch.cat([qvel_fd.new_zeros(1, qvel_fd.shape[1]), qvel_fd])
        state = EnvState(qpos=qpos[:-1], qvel=qvel[:b], t=torch.arange(b, device=env.device),
                         done=torch.zeros(b, dtype=torch.bool, device=env.device))
        obs_parts.append(env.obs(state, _expert_tensors(env, rec, b)))
        target_parts.append(inverse_step_qpos(qpos[:-1], qpos[1:]))
    return torch.cat(obs_parts), torch.cat(target_parts)


def regression_step(policy, opt, obs, target) -> torch.Tensor:
    """One Adam step of phase 1 on the mean squared error; the loss before it."""
    opt.zero_grad(set_to_none=False)
    loss = ((policy(obs)[0] - target) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def closed_loop_rollout(env, policy, rec: dict):
    """The policy's own rollout over one take from its first frame: at each
    step the observation and the action that would reach the NEXT expert
    frame from the CURRENT (drifted) state, capped at +-12; the state moves
    by the policy's mean clipped to +-20. Returns (obs (T-1, D), targets
    (T-1, 80))."""
    expert = _expert_tensors(env, rec)
    qpos = expert["qpos"][:, 0]
    st = EnvState(qpos=qpos[:1], qvel=qpos.new_zeros(1, QVEL_DIM),
                  t=torch.zeros(1, dtype=torch.int64, device=env.device),
                  done=torch.zeros(1, dtype=torch.bool, device=env.device))
    obs, tgt = [], []
    for t in range(qpos.shape[0] - 1):
        o = env.obs(st, expert)
        mean, _ = policy(o)
        obs.append(o)
        tgt.append(torch.clamp(inverse_step_qpos(st.qpos, qpos[t + 1][None]), -TARGET_CLIP, TARGET_CLIP))
        nq, nv = step_qpos(st.qpos, torch.clamp(mean, -ACTION_CLIP, ACTION_CLIP))
        st = EnvState(qpos=nq, qvel=nv, t=st.t + 1, done=st.done)
    return torch.cat(obs), torch.cat(tgt)


def closed_loop_step(env, policy, opt, recs: list[dict], lr: float) -> torch.Tensor:
    """One Adam step of phase 2 (JAX's ``closed_loop_step``) at the learning
    rate ``lr``: per take the weighted squared error of the policy's mean
    against its rollout's targets, averaged over steps (the 6 root-velocity
    dims weighted 5: global xy and heading come only from integrating
    them), then over takes. The dynamics carry no gradient (JAX's
    stop_gradient on the action), so the gradient reaches the parameters
    only through each step's mean: the rollout runs without autograd and
    the loss takes one forward over its observations. Returns the loss."""
    data = [closed_loop_rollout(env, policy, rec) for rec in recs]
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=False)
    w = torch.ones(80, dtype=data[0][1].dtype, device=env.device)
    w[74:] = ROOT_VEL_WEIGHT
    loss = torch.stack([(w * (policy(o)[0] - t) ** 2).mean() for o, t in data]).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def new_policy(env, agent, generator: torch.Generator) -> GaussianPolicy:
    """The agent's Gaussian actor with flax's initializers drawn from ``generator``."""
    policy = GaussianPolicy(env.obs_dim, env.action_dim, agent.hsize, agent.log_std_init)
    return init_rl_module_(policy, generator).to(env.device)


def bc_pretrain(env, agent, expert_rec, generator: torch.Generator, steps=2000, lr=1e-3, policy=None):
    """Supervised pretraining of the actor's mean on expert transitions (the
    role of the reference's ARNet stage that AgentAR fine-tunes). Phase 1:
    ``steps`` Adam(lr) steps regressing the observation onto
    ``inverse_step_qpos(qpos_t, qpos_{t+1})``. Phase 2: max(steps // 2, 50)
    closed-loop steps (the reference ARNet's scheduled sampling, DAgger
    style) with Adam under ``cl_learning_rate``. ``expert_rec``: one record
    or a list, trained jointly (the statear multi-take protocol). A fresh
    policy from ``generator`` unless ``policy`` is given. Returns (policy,
    the last closed-loop loss)."""
    recs = list(expert_rec) if isinstance(expert_rec, (list, tuple)) else [expert_rec]
    obs, target = regression_data(env, recs)
    policy = new_policy(env, agent, generator) if policy is None else policy
    opt = optax_adam(policy, lr)
    for _ in range(steps):
        regression_step(policy, opt, obs, target)

    cl_steps = max(steps // 2, 50)
    cl_opt = optax_adam(policy, lr)
    for i in range(cl_steps):
        loss = closed_loop_step(env, policy, cl_opt, recs, cl_learning_rate(i, lr, cl_steps))
        if (i + 1) % max(cl_steps // 8, 1) == 0:
            print(f"  closed-loop {i + 1}/{cl_steps}: loss {float(loss):.4f}", flush=True)
    return policy, float(loss)


def trim_record(rec: dict, n: int) -> dict:
    """First-n-frames view of an expert record: arrays with leading dim T
    slice to n, finite-difference arrays (leading dim T-1) to n-1."""
    t = rec["qpos"].shape[0]
    out = {}
    for k, v in rec.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == t:
            out[k] = v[:n]
        elif isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == t - 1:
            out[k] = v[:n - 1]
        else:
            out[k] = v
    return out


def summarize(m: dict) -> dict:
    return {k: round(v, 2) for k, v in m.items() if not isinstance(v, np.ndarray)}


def demo_motion(path: str):
    d = load_pickle(path)
    rec = d if "trans" in d else list(d.values())[0]
    trans = np.asarray(rec["trans"], np.float32)
    aa22 = np.concatenate([np.asarray(rec["root_orient"], np.float32), np.asarray(rec["body_pose"], np.float32)],
                          axis=-1).reshape(trans.shape[0], 22, 3)
    return trans, aa22


def neutral_motion(path: str):
    """standing_neutral.pkl's pose_aa (T, 72), SMPL local axis-angles, as
    (trans, aa (T, 22, 3)); it has no root translation, so its one rest
    qpos's root position is held for every frame."""
    d = load_pickle(path)
    aa22 = np.asarray(d["pose_aa"], np.float32).reshape(-1, 24, 3)[:, :22]
    return np.tile(np.asarray(d["qpos"][:3], np.float32), (aa22.shape[0], 1)), aa22


def flip_take(trans, aa22):
    """Sagittal mirror: the joints by ``flip_smpl`` (R -> S R S and the
    left/right swap), the root path by S t, anchored at its start."""
    from egoego_release_tpu_torch.preprocess.augment import flip_smpl

    t = trans.shape[0]
    aa24 = np.concatenate([aa22, np.zeros((t, 2, 3), aa22.dtype)], axis=1).reshape(t, 72)
    aa_f = flip_smpl(aa24).reshape(t, 24, 3)[:, :22].astype(np.float32)
    tr = trans * np.array([-1, 1, 1], np.float32)
    return tr - tr[0:1] + trans[0:1], aa_f


def rot_take(trans, aa22, angle=np.pi / 4):
    """Global heading rotation: Rz pre-multiplies the root orientation and
    turns the root path about its start."""
    from egoego_release_tpu_torch.preprocess.augment import _aa_to_matrix_np, _matrix_to_aa_np

    rz = _aa_to_matrix_np(np.array([[0.0, 0.0, angle]]))[0]
    tr = (trans - trans[0:1]) @ rz.T + trans[0:1]
    root_r = _matrix_to_aa_np(rz[None] @ _aa_to_matrix_np(aa22[:, 0])).astype(np.float32)
    aa_r = np.array(aa22, copy=True)
    aa_r[:, 0] = root_r
    return tr.astype(np.float32), aa_r


def multi_take(args, dev, rest, iters_env, bc_steps, num_envs, seed) -> dict:
    """KIN_MULTI_TAKE=1: (A) joint BC on the two real takes; (B) joint BC on
    a take and its two variants, the OTHER real take cold-started, both
    directions; (C) take-list PPO through StateARDataset(takes=...), warm
    from A's policy."""
    motions = {"demo": demo_motion(args.demo), "standing_neutral": neutral_motion(args.neutral)}
    for name in ("demo", "standing_neutral"):
        tr, aa = motions[name]
        motions[f"{name}_flip"] = flip_take(tr, aa)
        motions[f"{name}_rot"] = rot_take(tr, aa)
    takes = {}
    for name, (tr, aa) in motions.items():
        rec = motion_to_expert(tr, aa, rest, device=dev)
        rec["seq_name"] = name
        takes[name] = rec

    env, agent = ta.build_from_config(ta.KinpolyConfig(args.cfg), rest, num_envs, device=dev)
    state0 = agent.init_state(torch.Generator().manual_seed(seed))
    ev = lambda policy, rec: eval_tracking(env, agent, {"policy": policy}, rec, rest)
    result = {"metric": "kinematic AR-policy MULTI-TAKE training (joint BC closed-loop across take lists; "
                        "statear protocol)",
              "bc_steps": bc_steps, "take_frames": {k: int(v["qpos"].shape[0]) for k, v in takes.items()}}

    t0 = time.time()
    policy_a, _ = bc_pretrain(env, agent, [takes["demo"], takes["standing_neutral"]],
                              torch.Generator().manual_seed(seed), steps=bc_steps)
    result["joint_real"] = {
        "bc_seconds": round(time.time() - t0, 1),
        "demo_mpjpe_mm": round(ev(policy_a, takes["demo"])["mpjpe_mm"], 2),
        "standing_neutral_mpjpe_mm": round(ev(policy_a, takes["standing_neutral"])["mpjpe_mm"], 2)}
    print(f"joint_real: {result['joint_real']}", flush=True)

    result["heldout_take"] = {}
    for train_name, test_name in (("demo", "standing_neutral"), ("standing_neutral", "demo")):
        t0 = time.time()
        policy_b, _ = bc_pretrain(env, agent, [takes[train_name], takes[f"{train_name}_flip"],
                                               takes[f"{train_name}_rot"]],
                                  torch.Generator().manual_seed(seed), steps=bc_steps)
        seen, held = ev(policy_b, takes[train_name]), ev(policy_b, takes[test_name])
        held0 = ev(state0["policy"], takes[test_name])
        row = result["heldout_take"][f"{train_name}+aug->{test_name}"] = {
            "bc_seconds": round(time.time() - t0, 1),
            "seen_take_mpjpe_mm": round(seen["mpjpe_mm"], 2),
            "heldout_take_mpjpe_mm": round(held["mpjpe_mm"], 2),
            "heldout_take_global_mpjpe_mm": round(held["global_mpjpe_mm"], 2),
            "heldout_take_untrained_mpjpe_mm": round(held0["mpjpe_mm"], 2)}
        print(f"{train_name}+aug->{test_name}: {row}", flush=True)

    multi_path = os.path.join(args.work_dir, "_kin_expert_multi.p")
    save_pickle(takes, multi_path)
    ppo_iters = iters_env if iters_env is not None else 20
    out = ta.train(args.cfg, multi_path, rest, iters=ppo_iters, num_envs=num_envs, seed=seed,
                   log_every=max(ppo_iters // 4, 1), init_policy_params=policy_a.state_dict(),
                   takes=["demo", "standing_neutral"], device=dev)
    rewards = [h["reward_mean"] for h in out["history"]]
    policy_c = out["state"]["policy"]
    result["take_list_ppo"] = {
        "iters": ppo_iters, "takes": ["demo", "standing_neutral"],
        "reward_first": round(float(rewards[0]), 4), "reward_last": round(float(rewards[-1]), 4),
        "demo_mpjpe_mm": round(ev(policy_c, takes["demo"])["mpjpe_mm"], 2),
        "standing_neutral_mpjpe_mm": round(ev(policy_c, takes["standing_neutral"])["mpjpe_mm"], 2)}
    return result


def cross_take(args, dev, rest, expert_rec, bc_steps, num_envs, seed) -> dict:
    """KIN_CROSS_TAKE=1: BC on one take, cold-start eval on the other, both
    directions (the statear held-out-take protocol)."""
    env, agent = ta.build_from_config(ta.KinpolyConfig(args.cfg), rest, num_envs, device=dev)
    takes = {"demo": expert_rec, "standing_neutral": neutral_expert_record(rest, args.neutral, device=dev)}
    state0 = agent.init_state(torch.Generator().manual_seed(seed))
    directions = {}
    for train_name, test_name in (("demo", "standing_neutral"), ("standing_neutral", "demo")):
        t0 = time.time()
        policy, bc_loss = bc_pretrain(env, agent, takes[train_name], torch.Generator().manual_seed(seed),
                                      steps=bc_steps)
        st = {"policy": policy}
        seen = eval_tracking(env, agent, st, takes[train_name], rest)
        held = eval_tracking(env, agent, st, takes[test_name], rest)
        held0 = eval_tracking(env, agent, state0, takes[test_name], rest)
        row = directions[f"{train_name}->{test_name}"] = {
            "bc_seconds": round(time.time() - t0, 1), "bc_loss": round(bc_loss, 6),
            "seen_take_mpjpe_mm": round(seen["mpjpe_mm"], 2),
            "heldout_take_mpjpe_mm": round(held["mpjpe_mm"], 2),
            "heldout_take_global_mpjpe_mm": round(held["global_mpjpe_mm"], 2),
            "heldout_take_untrained_mpjpe_mm": round(held0["mpjpe_mm"], 2)}
        print(f"{train_name}->{test_name}: {row}", flush=True)
    return {"metric": "kinematic AR-policy CROSS-TAKE tracking (BC closed-loop train on one take, cold-start "
                      "eval on the other; statear held-out-take protocol)",
            "bc_steps": bc_steps, "take_frames": {k: int(v["qpos"].shape[0]) for k, v in takes.items()},
            "directions": directions}


def single_take(args, dev, rest, expert_rec, expert_path, iters, bc_steps, num_envs, seed, holdout) -> dict:
    """BC + PPO on the demo take (its first ``holdout`` frames when > 0),
    the tracking scored over the whole take."""
    train_rec, train_path = expert_rec, expert_path
    if holdout > 0:
        train_rec = trim_record(expert_rec, holdout)
        train_path = os.path.join(args.work_dir, "_kin_expert_train.p")
        save_pickle({train_rec.get("seq_name", "take"): train_rec}, train_path)
    env, agent = ta.build_from_config(ta.KinpolyConfig(args.cfg), rest, num_envs, device=dev)

    t0 = time.time()
    bc_policy, bc_loss = bc_pretrain(env, agent, train_rec, torch.Generator().manual_seed(seed), steps=bc_steps)
    bc_time = time.time() - t0
    metrics_bc = eval_tracking(env, agent, {"policy": bc_policy}, expert_rec, rest)
    print(f"BC: {bc_steps} steps, loss {bc_loss:.6f}, tracking {summarize(metrics_bc)}", flush=True)

    t0 = time.time()
    if iters > 0:
        out = ta.train(args.cfg, train_path, rest, iters=iters, num_envs=num_envs, seed=seed,
                       log_every=max(iters // 10, 1), init_policy_params=bc_policy.state_dict(), device=dev)
    else:
        out = {"state": {"policy": bc_policy}, "history": [{"reward_mean": 0.0}]}
    train_time = time.time() - t0
    metrics = eval_tracking(env, agent, out["state"], expert_rec, rest)
    metrics0 = eval_tracking(env, agent, agent.init_state(torch.Generator().manual_seed(seed)), expert_rec, rest)

    result = {
        "metric": "kinematic AR-policy expert tracking (BC pretrain + PPO fine-tune, dynamic_supervision_v3, "
                  "demo sequence %d frames)" % expert_rec["qpos"].shape[0],
        "iters": iters, "num_envs": num_envs, "bc_steps": bc_steps,
        "bc_seconds": round(bc_time, 1), "train_seconds": round(train_time, 1),
        "tracking_bc": summarize(metrics_bc), "tracking_final": summarize(metrics),
        "tracking_untrained": summarize(metrics0)}
    rewards = [h["reward_mean"] for h in out["history"]]
    result["reward_first10"] = round(float(np.mean(rewards[:10])), 4)
    result["reward_last10"] = round(float(np.mean(rewards[-10:])), 4)
    if holdout > 0:
        pf = metrics["per_frame_mpjpe_mm"]
        cold = eval_tracking(env, agent, out["state"], expert_rec, rest, start=holdout)
        result["holdout"] = {
            "train_frames": holdout,
            "seen_span_mpjpe_mm": round(float(pf[:holdout].mean()), 2),
            "unseen_tail_mpjpe_mm": round(float(pf[holdout:].mean()), 2),
            "cold_start_unseen_mpjpe_mm": round(cold["mpjpe_mm"], 2),
            "cold_start_unseen_global_mpjpe_mm": round(cold["global_mpjpe_mm"], 2)}
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--demo", required=True, help="the demo motion pickle (demo_ares_data.p)")
    p.add_argument("--neutral", required=True, help="kinpoly's standing_neutral.pkl")
    p.add_argument("--cfg", required=True, help="the statear YAML whose policy_specs build the policy")
    p.add_argument("--work_dir", default=None, help="where the expert pickles go (a temporary directory if unset)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    iters_env = os.environ.get("KIN_ITERS")
    iters = int(iters_env if iters_env is not None else "400")
    num_envs = int(os.environ.get("KIN_ENVS", "32"))
    seed = int(os.environ.get("KIN_SEED", "0"))
    bc_steps = int(os.environ.get("KIN_BC_STEPS", "2000"))
    holdout = int(os.environ.get("KIN_HOLDOUT", "0"))
    cross = os.environ.get("KIN_CROSS_TAKE", "") == "1"
    multi = os.environ.get("KIN_MULTI_TAKE", "") == "1"
    rest = tool_rest_offsets()

    with tempfile.TemporaryDirectory() as tmp:
        args.work_dir = args.work_dir or tmp
        os.makedirs(args.work_dir, exist_ok=True)
        expert_path = os.path.join(args.work_dir, "_kin_expert.p")
        convert_motion_pickle(args.demo, expert_path, rest, device=dev)
        expert_rec = list(load_pickle(expert_path).values())[0]
        if multi:
            result = multi_take(args, dev, rest, None if iters_env is None else iters, bc_steps, num_envs, seed)
        elif cross:
            if iters_env is not None or holdout:
                print("KIN_CROSS_TAKE=1 is BC-only (PPO on top of converged BC does not help); ignoring "
                      "KIN_ITERS/KIN_HOLDOUT", flush=True)
            result = cross_take(args, dev, rest, expert_rec, bc_steps, num_envs, seed)
        else:
            result = single_take(args, dev, rest, expert_rec, expert_path, iters, bc_steps, num_envs, seed,
                                 holdout)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
