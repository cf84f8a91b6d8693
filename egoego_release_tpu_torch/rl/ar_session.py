"""The relive two-level AR -> physics control loop (port of
egoego_release_tpu/rl/ar_session.py; the reference's `HumanoidAREnv.step`,
kinpoly/relive/envs/humanoid_ar_v1.py:554-650):

  AR action --step_ar--> target qpos --FK--> target pose dict
  cc_obs = get_cc_obs(sim state, target) --zfilter snapshot--> cc policy
  (mean action) --stable-PD + RFC + mj_step--> simulated state
  fail  = body_diff > 10 [or body_gt_diff > 12 in train mode]  (:612-625)
  end   = cur_t >= episode_len or start_ind + cur_t >= context len (:630)

plus `ar_fail_safe` (:645-649: reset the sim onto the ARNet pose on
failure).  This composes pieces that are each already oracle-tested:
models/trajar.step_qpos (step_ar :524-551), rl/ar_obs.get_cc_obs,
rl/uhc_obs layouts, rl/mujoco_env stable-PD, and the sim/UHC reward
registries via PhysicsImitation.  The cc policy is any (obs) -> action
callable — a PhysicsPPO-trained policy slot where the reference loads its
pretrained UHC checkpoint (:86-104, not redistributable): numpy in and
numpy out, as in JAX. ``step_ar`` and the target FK run on the session's
``device`` (PhysicsImitation's), each a copy in and a copy out a step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from egoego_release_tpu_torch.models.trajar import step_qpos
from egoego_release_tpu_torch.ops.mujoco_xml import qpos_fk
from egoego_release_tpu_torch.rl import uhc_rewards as U
from egoego_release_tpu_torch.rl.ar_obs import get_ar_obs_v1, get_cc_obs
from egoego_release_tpu_torch.rl.imitation import PhysicsImitation

BODY_DIFF_FAIL = 10.0     # :618 (wild mode uses 8, :612)
BODY_GT_DIFF_FAIL = 12.0  # :621


class ARPhysicsSession:
    """One sequence's AR + physics rollout state (the HumanoidAREnv loop)."""

    def __init__(
        self,
        xml_path: str,
        cc_policy: Callable[[np.ndarray], np.ndarray],
        reward_id: str = "dynamic_supervision_v4",
        reward_weights: dict | None = None,
        cc_obs_v: int = 1,
        cc_obs_specs: dict | None = None,
        cc_obs_filter: Callable[[np.ndarray], np.ndarray] | None = None,
        episode_len: int = 200,   # cc_cfg.env_episode_len
        mode: str = "train",
        wild: bool = False,
        body_diff_fail: float | None = None,   # override :612-625 thresholds
        *,
        device,
        **env_kwargs,
    ):
        self.im = PhysicsImitation(xml_path, reward_id=reward_id,
                                   reward_weights=reward_weights,
                                   term_body_diff=np.inf, device=device, **env_kwargs)
        self.device = self.im.device
        self.env = self.im.env
        self.cc_policy = cc_policy
        self.cc_obs_v = cc_obs_v
        self.cc_obs_specs = cc_obs_specs
        self.cc_obs_filter = cc_obs_filter or (lambda o: o)
        self.episode_len = episode_len
        self.mode = mode
        self.wild = wild
        self.body_diff_fail = body_diff_fail
        self.ar_context: dict | None = None
        self.cur_t = 0
        self.start_ind = 0
        self._prev_target: np.ndarray | None = None
        # body_ipos: body-frame inertial offsets -> target body_com
        # (xipos = xpos + R_body @ ipos)
        self._ipos = np.asarray(self.env.model.body_ipos[1:U._lim(self.env)])

    # -- context / reset ------------------------------------------------------

    def set_context(self, ar_context: dict):
        """ar_context: the kinpoly record arrays (qpos/head_pose/head_vels/
        ... as in data/kinpoly.StateARDataset records) + optional ar_qpos/
        ar_qvel (ARNet playback for ar_fail_safe)."""
        self.ar_context = dict(ar_context)
        self.ar_context.setdefault("len", len(ar_context["qpos"]))

    def reset(self, init_qpos: np.ndarray, init_qvel: np.ndarray | None = None,
              start_ind: int = 0):
        self.cur_t = 0
        self.start_ind = start_ind
        self._prev_target = None
        self.env.reset(init_qpos, init_qvel)
        if self.im.uhc_reward is not None or self.im.sim_reward is not None:
            self.im.set_expert(np.asarray(self.ar_context["qpos"]))
            self.env.reset(init_qpos, init_qvel)
        return self.env.get_qpos()

    # -- internals ------------------------------------------------------------

    def _target_dict(self, target_qpos: np.ndarray) -> dict:
        quat, pos = qpos_fk(self.im.skeleton, self.im.target.f32(target_qpos))
        quat = quat[0].cpu().numpy().astype(np.float64)
        pos = pos[0].cpu().numpy().astype(np.float64)
        nb = self._ipos.shape[0]
        body_com = np.stack([
            pos[i] + U.quat_mul_vec(quat[i], self._ipos[i])
            for i in range(nb)
        ])
        return {"qpos": np.asarray(target_qpos, np.float64),
                "wbpos": pos[:nb].ravel(),
                "body_com": body_com.ravel(),
                "wbquat": quat[:nb].ravel()}

    def _cur_state(self) -> dict:
        return {
            "qpos": self.env.get_qpos(),
            "qvel": self.env.get_qvel(),
            "wbpos": U.env_wbpos(self.env),
            "body_com": U.env_body_com(self.env),
            "wbquat": U.env_wbquat(self.env),
        }

    def step_ar(self, ar_action: np.ndarray) -> np.ndarray:
        """AR action -> next kinematic target qpos (:524-551)."""
        # the state rounded to f32, the action in its own dtype, both then
        # in the wider one: JAX's promotion of a float64 action under x64
        qpos = self.im.target.f32(self.env.get_qpos())
        action = torch.as_tensor(np.asarray(ar_action)[None], device=self.device)
        dtype = torch.promote_types(qpos.dtype, action.dtype)
        nxt, _ = step_qpos(qpos.to(dtype), action.to(dtype))
        return nxt[0].cpu().numpy().astype(np.float64)

    # -- the loop -------------------------------------------------------------

    def step(self, ar_action: np.ndarray | None = None,
             target_qpos: np.ndarray | None = None):
        """One control step.  Either an AR action (policy_v 1, integrated
        through step_ar) or a direct target qpos (policy_v 2, :563-566).
        -> (ar_obs, reward, done, info)."""
        assert self.ar_context is not None, "call set_context() first"
        if target_qpos is None:
            target_qpos = self.step_ar(np.asarray(ar_action))
        target = self._target_dict(target_qpos)

        cc_obs = get_cc_obs(self._cur_state(), target, obs_v=self.cc_obs_v,
                            specs=self.cc_obs_specs)
        cc_a = np.asarray(self.cc_policy(self.cc_obs_filter(cc_obs)))

        ind = min(self.start_ind + self.cur_t,
                  self.ar_context["len"] - 1)
        # the ARNet raw prediction feeding the v3 reward's action terms IS
        # the step_ar output here (ar_context['ar_qpos'] in the reference)
        reward, _, info = self.im.step(
            cc_a, target_qpos, expert_ind=ind,
            ar_qpos=target_qpos, prev_target_qpos=self._prev_target)
        self._prev_target = np.asarray(target_qpos)
        self.cur_t += 1

        # termination (:612-630); body_diff vs the kinematic target comes
        # from PhysicsImitation; train mode adds the GT-pose guard
        thresh = (self.body_diff_fail if self.body_diff_fail is not None
                  else (8.0 if self.wild else BODY_DIFF_FAIL))
        fail = info["body_diff"] > thresh
        if self.mode == "train" and not self.wild:
            gt_wbpos = self._target_dict(
                np.asarray(self.ar_context["qpos"][ind], np.float64))["wbpos"]
            body_gt_diff = float(np.linalg.norm(
                (U.env_wbpos(self.env) - gt_wbpos).reshape(-1, 3), axis=1).sum())
            gt_thresh = (np.inf if self.body_diff_fail is not None
                         and np.isinf(self.body_diff_fail)
                         else BODY_GT_DIFF_FAIL)
            fail = fail or body_gt_diff > gt_thresh
            info["body_gt_diff"] = body_gt_diff
        end = (self.cur_t >= self.episode_len
               or self.cur_t + self.start_ind >= self.ar_context["len"])
        done = bool(fail or end)
        info.update(fail=bool(fail), end=bool(end),
                    percent=self.cur_t / self.ar_context["len"],
                    cc_obs=cc_obs)
        return self.ar_obs(), float(reward), done, info

    def ar_obs(self) -> np.ndarray:
        """The AR policy's observation at the current state (:259-340)."""
        cur = self._cur_state()
        t = min(self.cur_t, self.ar_context["len"] - 1)
        ctx = self.ar_context
        if "action_one_hot" not in ctx:
            ctx = dict(ctx)
            ctx["action_one_hot"] = np.zeros((ctx["len"], 1))
        head_idx = self.env.body_names.index("Head")
        return get_ar_obs_v1(cur, ctx, t, head_idx=head_idx)

    def ar_fail_safe(self):
        """Reset the sim onto the ARNet playback pose (:645-649)."""
        t = min(self.cur_t + 1, self.ar_context["len"] - 1)
        qpos = np.asarray(self.ar_context.get("ar_qpos",
                                              self.ar_context["qpos"])[t])
        qvel_src = self.ar_context.get("ar_qvel", self.ar_context.get("qvel"))
        qvel = None if qvel_src is None else np.asarray(
            qvel_src[min(t, len(qvel_src) - 1)])
        self.env.reset(qpos, qvel)
