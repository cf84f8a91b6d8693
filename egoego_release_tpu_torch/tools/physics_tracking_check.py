"""Physics tracking baseline in MuJoCo (port of
tools/physics_tracking_check.py): track the demo expert with the stable-PD
controller and no learned policy.

1. The demo sequence -> a kinpoly qpos expert record (``preprocess.qpos``).
2. An open-loop stable-PD rollout: each 30 Hz control step PD-tracks the
   expert's next frame (a zero policy residual), with and without the
   implicit residual force (copycat.yml's rfc).
3. The simulated body positions (MuJoCo FK of the rolled state) against the
   expert's FK: root-centred and global MPJPE in mm.

It isolates the physics and controller stack (the PD gains, the torques,
the residual force, contacts). MuJoCo steps on the host; the control laws
and the expert conversion run on ``--device`` (the card unless ``--device
cpu`` is given), where the host is faster for this one-env loop.

    python -m egoego_release_tpu_torch.tools.physics_tracking_check [--device cpu] \\
        --demo demo_ares_data.p --xml humanoid_smpl_neutral_mesh.xml [--work_dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from egoego_release_tpu_torch.data.formats import load_pickle
from egoego_release_tpu_torch.preprocess.qpos import convert_motion_pickle
from egoego_release_tpu_torch.tools._data import tool_rest_offsets
from egoego_release_tpu_torch.utils.device import resolve_device


def fk_positions(env, qpos):
    """MuJoCo FK (no dynamics) of a qpos -> (nbody, 3) world body positions."""
    env.data.qpos[: qpos.shape[0]] = qpos
    env.data.qvel[:] = 0
    env._mj.mj_kinematics(env.model, env.data)
    return env.data.xpos[1:].copy()  # skip the world body


def expert_qpos_qvel(demo: str, work_dir: str, device):
    """The demo's expert record, converted once into ``work_dir``
    (_phys_expert.p, reused when present): float64 (qpos (T, 76), qvel
    (T-1, 75))."""
    path = os.path.join(work_dir, "_phys_expert.p")
    if not os.path.exists(path):
        convert_motion_pickle(demo, path, tool_rest_offsets(), device=device)
    rec = list(load_pickle(path).values())[0]
    return np.asarray(rec["qpos"], np.float64), np.asarray(rec["qvel"], np.float64)


def main(argv=None) -> dict:
    from egoego_release_tpu_torch.rl.mujoco_env import MujocoHumanoidEnv

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--demo", required=True, help="the demo motion pickle (demo_ares_data.p)")
    p.add_argument("--xml", required=True, help="the humanoid's MuJoCo model")
    p.add_argument("--work_dir", default=None, help="where the expert pickle goes (a temporary directory if unset)")
    p.add_argument("--device", default="cuda", help="where the control laws run: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        qpos_e, qvel_e = expert_qpos_qvel(args.demo, args.work_dir or tmp, dev)
    t_total = qpos_e.shape[0]
    out = {"metric": "physics-sim open-loop stable-PD expert tracking (MuJoCo 3, demo sequence %d frames)"
                     % t_total, "frames": t_total}
    for rfc in (True, False):
        env = MujocoHumanoidEnv(args.xml, residual_force=rfc, device=dev)
        ref = np.asarray([fk_positions(env, q) for q in qpos_e[1:]])  # the expert's FK, before the rollout
        env.reset(qpos_e[0], qvel_e[0])
        action = np.zeros(env.action_dim)
        sim = []
        t0 = time.time()
        for t in range(1, t_total):
            env.do_simulation(action, qpos_e[t][7:])
            sim.append(env.get_wbody_pos().reshape(-1, 3))
        wall = time.time() - t0
        sim = np.asarray(sim)

        global_mm = float(np.linalg.norm(sim - ref, axis=-1).mean() * 1000)
        per_frame_root = np.linalg.norm((sim - sim[:, 0:1]) - (ref - ref[:, 0:1]), axis=-1).mean(-1) * 1000
        out["rfc" if rfc else "no_rfc"] = {
            "root_centered_mpjpe_mm": round(float(per_frame_root.mean()), 2),
            # the root is unactuated, so open-loop PD cannot balance dynamic
            # motion (the learned residual's job); the early frames isolate
            # the joint-tracking stack
            "first10_root_centered_mpjpe_mm": round(float(per_frame_root[:10].mean()), 2),
            "first30_root_centered_mpjpe_mm": round(float(per_frame_root[:30].mean()), 2),
            "global_mpjpe_mm": round(global_mm, 2),
            "final_root_height_m": round(float(sim[-1, 0, 2]), 3),
            "sim_seconds": round(wall, 1),
        }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
