"""Trained physics controller (port of tools/train_physics_controller.py):
PPO learns a residual (joint offsets and the implicit residual force) on top
of the stable-PD controller of ``physics_tracking_check`` and is scored
closed-loop on the whole demo take, beside the open-loop baseline
recomputed here.

The bar: the deterministic (mean-action) closed-loop rollout must beat
open-loop stable PD on both the first-30-frame root-centred MPJPE and the
frames upright (root height above 0.8 m).

Training (copycat's agent, ``rl.train_physics_agent.PhysicsPPO``: host
MuJoCo rollouts, the policy and its updates on ``--device``):
- action = the ndof joint residual + 6 implicit-RFC on top of PD tracking
  the expert's next frame;
- a near-zero-residual start: the policy's mean head scaled by 1e-2, so PPO
  starts at the open-loop baseline;
- rollouts start at random expert frames with expert-state resets, horizon
  H; the frame-0 window (the eval start) is always in the batch;
- the reward world_rfc_implicit (both bundled UHC configs' reward_id).

    PHYS_ITERS=120 PHYS_ROLLOUTS=4 python -m egoego_release_tpu_torch.tools.train_physics_controller \\
        [--device cpu] --demo demo_ares_data.p --xml humanoid.xml [--work_dir DIR]

Knobs (the JAX tool's): PHYS_ITERS (120), PHYS_ROLLOUTS (4), PHYS_HORIZON
(30), PHYS_HORIZON_SCHEDULE ("30x100,60x100": a horizon curriculum),
PHYS_SAVE (a pickle of the best policy, value and observation filter, as
numpy), PHYS_INIT (warm start from such a pickle), PHYS_EVAL_EVERY (20),
PHYS_REWARD, PHYS_SEED, PHYS_ON_FAIL (break | failsafe), PHYS_WALL (a
wall-clock budget in seconds for the training loop). MuJoCo steps on the
host; on the card every control step pays a round trip (ROADMAP B12), so
``--device cpu`` is the faster choice today.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time

import numpy as np
import torch

from egoego_release_tpu_torch.rl.trpo import ZFilter
from egoego_release_tpu_torch.tools.physics_tracking_check import expert_qpos_qvel, fk_positions
from egoego_release_tpu_torch.utils.device import resolve_device

UPRIGHT_Z = 0.8


@torch.no_grad()
def scale_mean_head(policy, factor=1e-2):
    """Near-zero-residual warm start: the Gaussian policy's mean head (its
    last Linear, ``fc``) scaled by ``factor`` in place, so the initial
    policy is about open-loop PD (zero residual, zero RFC). Returns it."""
    sd = policy.state_dict()
    for k in ("fc.weight", "fc.bias"):
        sd[k].mul_(factor)
    return policy


@torch.no_grad()
def rollout_closed_loop(agent, state, qpos_e, qvel_e, ref_fk):
    """Deterministic (mean-action) closed-loop rollout over the whole take;
    per-frame metrics against the expert's FK. No termination: the claim is
    the raw rollout, as for the open-loop baseline."""
    sess = agent.sess
    sess.set_expert(qpos_e)
    sess.reset(qpos_e[0], qvel_e[0])
    sim = []
    for t in range(1, qpos_e.shape[0]):
        target = qpos_e[t]
        raw = agent.obs(target, sess, cur_t=t - 1)
        o = ZFilter.apply(agent.zfilter, torch.as_tensor(raw, device=agent.device))
        mean, _ = state["policy"](o[None])
        sess.env.do_simulation(mean[0].double().cpu().numpy(), np.asarray(target[7:7 + sess.env.ndof], np.float64))
        sim.append(sess.env.get_wbody_pos().reshape(-1, 3))
    return score(np.asarray(sim), ref_fk)


def rollout_open_loop(sess, qpos_e, qvel_e, ref_fk):
    """Stable PD tracking the expert's next frame with a zero residual."""
    sess.reset(qpos_e[0], qvel_e[0])
    zero = np.zeros(sess.env.action_dim)
    sim = []
    for t in range(1, qpos_e.shape[0]):
        sess.env.do_simulation(zero, qpos_e[t][7:7 + sess.env.ndof])
        sim.append(sess.env.get_wbody_pos().reshape(-1, 3))
    return score(np.asarray(sim), ref_fk)


def score(sim, ref):
    """sim / ref: (T-1, nbody, 3) world body positions."""
    per_frame = np.linalg.norm((sim - sim[:, 0:1]) - (ref - ref[:, 0:1]), axis=-1).mean(-1) * 1000
    heights = sim[:, 0, 2]
    up = heights > UPRIGHT_Z
    best_run = run = 0  # the longest run of upright frames
    for u in up:
        run = run + 1 if u else 0
        best_run = max(best_run, run)
    return {
        "first10_mpjpe_mm": round(float(per_frame[:10].mean()), 2),
        "first30_mpjpe_mm": round(float(per_frame[:30].mean()), 2),
        "full_mpjpe_mm": round(float(per_frame.mean()), 2),
        "frames_upright": int(up.sum()),
        "max_consecutive_upright": int(best_run),
        "total_frames": int(heights.shape[0]),
        "final_root_height_m": round(float(heights[-1]), 3),
    }


def fk_reference(env, qpos_e):
    """MuJoCo FK of the expert's frames 1.. (T-1, nbody, 3)."""
    return np.asarray([fk_positions(env, q) for q in qpos_e[1:]])


def horizon_schedule(iters: int, horizon: int, spec: str) -> list[int]:
    """PHYS_HORIZON_SCHEDULE "HxN,..." (N iterations at horizon H, in
    order), or ``iters`` iterations at ``horizon``."""
    if not spec:
        return [horizon] * iters
    schedule = []
    for part in spec.split(","):
        h, n = part.split("x")
        schedule += [int(h)] * int(n)
    return schedule


def main(argv=None) -> dict:
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise
    from egoego_release_tpu_torch.rl.imitation import PhysicsImitation
    from egoego_release_tpu_torch.rl.train_physics_agent import PhysicsPPO

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--demo", required=True, help="the demo motion pickle (demo_ares_data.p)")
    p.add_argument("--xml", required=True, help="the humanoid's MuJoCo model")
    p.add_argument("--work_dir", default=None, help="where the expert pickle goes (a temporary directory if unset)")
    p.add_argument("--device", default="cuda", help="the policy, its updates and the reward: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    n_roll = int(os.environ.get("PHYS_ROLLOUTS", "4"))
    horizon = int(os.environ.get("PHYS_HORIZON", "30"))
    sched_spec = os.environ.get("PHYS_HORIZON_SCHEDULE", "")
    schedule = horizon_schedule(int(os.environ.get("PHYS_ITERS", "120")), horizon, sched_spec)
    iters = len(schedule)
    save_path = os.environ.get("PHYS_SAVE", "")
    eval_every = int(os.environ.get("PHYS_EVAL_EVERY", "20"))
    reward_id = os.environ.get("PHYS_REWARD", "world_rfc_implicit")
    seed = int(os.environ.get("PHYS_SEED", "0"))
    # break: a fall ends the rollout; failsafe: it resets to the expert's next
    # frame and the window keeps collecting (humanoid_im.py:267 at training time)
    on_fail = os.environ.get("PHYS_ON_FAIL", "break")
    # the training loop stops past this many seconds (the eval, the save and
    # the JSON still run)
    wall_budget = float(os.environ.get("PHYS_WALL", "0"))

    with tempfile.TemporaryDirectory() as tmp:
        # qvel_e[t]: the finite-difference velocity qpos_t -> qpos_{t+1}, the
        # state velocity at frame t of an expert-state reset
        qpos_e, qvel_e = expert_qpos_qvel(args.demo, args.work_dir or tmp, dev)
    t_total = qpos_e.shape[0]

    sess = PhysicsImitation(args.xml, reward_id=reward_id, device=dev)
    agent = PhysicsPPO(sess, hsize=(256, 128), policy_lr=5e-5, value_lr=3e-4, epochs=5)
    ref_fk = fk_reference(sess.env, qpos_e)
    noise = TorchNoise(dev, seed)
    state = agent.init_state(torch.Generator().manual_seed(seed))
    scale_mean_head(state["policy"])

    init_path = os.environ.get("PHYS_INIT", "")
    if init_path:  # optimizer moments restart: the snapshot keeps none
        with open(init_path, "rb") as f:
            snap = pickle.load(f)
        for k in ("policy", "value"):
            state[k].load_state_dict({n: torch.as_tensor(v) for n, v in snap[k].items()})
        agent.zfilter = {k: torch.as_tensor(v, device=dev) for k, v in snap["zfilter"].items()}
        state = agent.state_for(state["policy"], state["value"])
        print(f"warm start from {init_path}", flush=True)

    open_loop = rollout_open_loop(sess, qpos_e, qvel_e, ref_fk)
    print(f"open-loop baseline: {open_loop}", flush=True)

    to_np = lambda tree: {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}  # noqa: E731
    sample_rng = np.random.RandomState(seed + 1)
    best = None
    best_snap = {"policy": to_np(state["policy"].state_dict()), "value": to_np(state["value"].state_dict()),
                 "zfilter": to_np(agent.zfilter)}
    history = []

    def dump_snapshot():
        # rewritten at every new best, so a killed run leaves its best policy
        if not save_path:
            return
        with open(save_path + ".tmp", "wb") as f:
            pickle.dump(best_snap, f)
        os.replace(save_path + ".tmp", save_path)

    t0 = time.time()
    iters_run = iters
    for it in range(iters):
        if wall_budget and time.time() - t0 > wall_budget:
            print(f"wall budget {wall_budget:.0f}s reached at iter {it}; stopping training loop", flush=True)
            iters_run = it
            break
        # a horizon past the take trains on the whole take (collect clamps
        # short target windows); only the start range needs the guard
        h = min(schedule[it], t_total - 1)
        starts = [0] + list(sample_rng.randint(0, max(t_total - 1 - h, 1), size=n_roll - 1))
        tasks = [(qpos_e[s], qpos_e[s + 1: s + 1 + h], qvel_e[min(s, qvel_e.shape[0] - 1)],
                  qvel_e[min(s + 1, qvel_e.shape[0] - 1): s + 1 + h]) for s in starts]
        state, m = agent.iterate_parallel(state, noise, tasks, h, num_threads=2, on_fail=on_fail)
        history.append(m["reward_mean"])
        if (it + 1) % eval_every == 0 or it == iters - 1:
            ev = rollout_closed_loop(agent, state, qpos_e, qvel_e, ref_fk)
            print(f"iter {it + 1}: reward {m['reward_mean']:.4f} steps {m['total_steps']} eval {ev}", flush=True)
            if best is None or ((ev["frames_upright"], -ev["first30_mpjpe_mm"])
                                > (best["frames_upright"], -best["first30_mpjpe_mm"])):
                best = ev
                # the filter WITH the policy: it keeps updating after this iteration
                best_snap = {"policy": to_np(state["policy"].state_dict()),
                             "value": to_np(state["value"].state_dict()), "zfilter": to_np(agent.zfilter)}
                dump_snapshot()
    wall = time.time() - t0

    final = rollout_closed_loop(agent, state, qpos_e, qvel_e, ref_fk)
    if best is None:  # PHYS_ITERS=0: the untrained residual, closed loop
        best = final
    result = {
        "metric": "physics-controller closed-loop expert tracking "
                  f"(PPO residual+RFC over stable-PD, {reward_id}, demo take {t_total} frames)",
        "iters": iters_run, "rollouts_per_iter": n_roll,
        "horizon": sched_spec if sched_spec else horizon,
        "on_fail": on_fail,
        "train_seconds": round(wall, 1),
        "reward_first10": round(float(np.mean(history[:10])), 4) if history else None,
        "reward_last10": round(float(np.mean(history[-10:])), 4) if history else None,
        "open_loop": open_loop,
        "closed_loop_final": final,
        "closed_loop_best": best,
        "bar": {"first30_mpjpe_beats_open_loop": best["first30_mpjpe_mm"] < open_loop["first30_mpjpe_mm"],
                "upright_beats_open_loop": best["frames_upright"] > open_loop["frames_upright"]},
    }
    dump_snapshot()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
