"""Physics-grounded imitation stepping (port of egoego_release_tpu/rl/imitation.py;
the reference's HumanoidAREnv.step).

One control step of the reference loop (humanoid_ar_v1.py:554-650):

  kinematic action --step_ar--> target qpos --FK--> target pose
  control action --stable-PD + RFC + mj_step--> simulated pose
  reward = dynamic-supervision(sim, target, AR context)
  terminate when the simulated body diverges from the target (env_term_body)

`step_ar` itself is models/trajar.step_qpos; the target FK is
ops/mujoco_xml.qpos_fk; dynamics are rl/mujoco_env.MujocoHumanoidEnv.

MuJoCo steps on the host. The target FK and the kinematic reward
(``rl.rewards``, where JAX calls ``jnp``) run on the session's ``device``:
on the card each control step then pays a copy of the state in and of the
reward out. The env's control laws run on the CPU, beside MuJoCo's state
(``rl.mujoco_env`` says why).
"""

from __future__ import annotations

import numpy as np
import torch

from egoego_release_tpu_torch.ops.mujoco_xml import load_mujoco_skeleton, qpos_fk
from egoego_release_tpu_torch.rl import rewards as rewards_mod
from egoego_release_tpu_torch.rl import sim_rewards as sim_rewards_mod
from egoego_release_tpu_torch.rl import uhc_rewards as uhc_rewards_mod
from egoego_release_tpu_torch.rl.mujoco_env import MujocoHumanoidEnv


class KinematicReward:
    """The target side of a control step on ``device``: the target's FK
    (``fk``) and the relive dynamic-supervision reward (``__call__``; JAX
    ``rl/imitation.py:182-207``, where it calls ``jnp``). It reads the
    MJCF's body tree only, not MuJoCo."""

    def __init__(self, skeleton, reward_id: str | None, reward_weights: dict | None, ndof: int, dt: float,
                 device):
        self.skeleton, self.ndof, self.dt = skeleton, ndof, dt
        self.device = torch.device(device)
        self.reward_fn = None if reward_id is None else rewards_mod.REWARD_FUNCS[reward_id]
        self.reward_weights = reward_weights
        self.head_body = skeleton.body_names.index("Head")

    def f32(self, x) -> torch.Tensor:
        """A host array as one f32 row on the device."""
        return torch.as_tensor(np.asarray(x, np.float32)[None], device=self.device)

    def fk(self, target_qpos: np.ndarray):
        """Target body quats (1, J, 4) and positions (1, J, 3) on the
        device: the FK skeleton covers the HUMANOID joints only;
        object-bearing *_all qpos carries object dofs past 7 + ndof
        (reference qpos_lim)."""
        return qpos_fk(self.skeleton, self.f32(np.asarray(target_qpos)[: 7 + self.ndof]))

    def __call__(self, sim: dict, target_qpos: np.ndarray, ar_qpos: np.ndarray | None = None,
                 prev_target_qpos: np.ndarray | None = None):
        """sim: the simulated ``head_pose`` (7,), ``bquat`` and ``prev_bquat``
        (J, 4) world body quats, ``wbpos`` (J, 3). The target's FK and the
        context stay on the device; one copy brings back the reward, its
        terms and the target positions that the termination reads. ->
        (reward, terms, target body positions (J, 3)) on the host."""
        tgt_bquat, tgt_wbpos = self.fk(target_qpos)
        tgt_hpose = torch.cat([tgt_wbpos[:, self.head_body], tgt_bquat[:, self.head_body]], dim=-1)
        f32 = self.f32
        ctx_kwargs = dict(
            cur_hpose=f32(sim["head_pose"]), tgt_hpose=tgt_hpose, cur_bquat=f32(sim["bquat"]),
            prev_bquat=f32(sim["prev_bquat"]), cur_wbpos=f32(sim["wbpos"]), tgt_bquat=tgt_bquat,
            tgt_wbpos=tgt_wbpos, tgt_qpos=f32(target_qpos), dt=self.dt,
        )
        if ar_qpos is not None:
            ar_bquat = self.fk(ar_qpos)[0]
            prev_ar = self.fk(prev_target_qpos)[0] if prev_target_qpos is not None else ar_bquat
            ctx_kwargs.update(ar_qpos=f32(ar_qpos), ar_bquat=ar_bquat, ar_prev_bquat=prev_ar,
                              gt_bquat=ar_bquat, gt_prev_bquat=prev_ar)
        reward, components = self.reward_fn(rewards_mod.RewardContext(**ctx_kwargs), self.reward_weights)
        n = components.shape[-1]
        host = torch.cat([reward[:1], components[0], tgt_wbpos[0].reshape(-1)]).cpu().numpy()
        return float(host[0]), host[1:1 + n], host[1 + n:].reshape(-1, 3)


class PhysicsImitation:
    """Couples the physics env with kinematic targets + the reward suite."""

    def __init__(
        self,
        xml_path: str,
        reward_id: str = "dynamic_supervision_v4",
        reward_weights: dict | None = None,
        term_body_diff: float = 10.0,   # cc_cfg.env_term_body 'body' threshold
        *,
        device,
        **env_kwargs,
    ):
        self._ctor_args = dict(xml_path=xml_path, reward_id=reward_id,
                               reward_weights=reward_weights,
                               term_body_diff=term_body_diff, device=device,
                               **env_kwargs)
        self.device = torch.device(device)
        self.env = MujocoHumanoidEnv(xml_path, device="cpu", **env_kwargs)
        self.skeleton = load_mujoco_skeleton(xml_path, device=self.device)
        # relive dynamic-supervision rewards score against the KINEMATIC
        # TARGET; UHC world rewards (rl/uhc_rewards.py) score against a
        # precomputed EXPERT trajectory (set_expert + expert_ind per step),
        # matching copycat's reward_id: world_rfc_implicit
        self.uhc_reward = uhc_rewards_mod.UHC_REWARD_FUNCS.get(reward_id)
        # relive simulator-state families (quat/deep-mimic/local-world/
        # world-quat) score against the same set_expert attrs
        self.sim_reward = (
            None if self.uhc_reward
            else sim_rewards_mod.SIM_REWARD_FUNCS.get(reward_id)
        )
        self.target = KinematicReward(
            self.skeleton, None if (self.uhc_reward or self.sim_reward) else reward_id, reward_weights,
            self.env.ndof, self.env.dt, self.device)
        self.reward_weights = reward_weights
        self.term_body_diff = term_body_diff
        self._expert = None
        self._qaddr = None

    def clone(self) -> "PhysicsImitation":
        """Fresh env instance with the same configuration — one per rollout
        worker (MjData is not shareable across threads)."""
        return PhysicsImitation(**self._ctor_args)

    def reset(self, qpos0: np.ndarray, qvel0: np.ndarray | None = None):
        self.env.reset(qpos0, qvel0)
        return self.env.get_qpos()

    def set_expert(self, expert_qpos: np.ndarray):
        """Precompute the expert attrs the UHC world rewards read
        (copycat/utils/tools.get_expert subset)."""
        self._expert = uhc_rewards_mod.expert_physics_attrs(self.env, expert_qpos)
        self._qaddr = uhc_rewards_mod.body_qposaddr(self.env.model)
        return self._expert

    def _uhc_cur_state(self, prev_qpos: np.ndarray):
        qpos = self.env.get_qpos()
        return {
            "bquat": uhc_rewards_mod.body_quat_local(
                qpos, self._qaddr, self.env.body_names),
            "prev_bquat": uhc_rewards_mod.body_quat_local(
                prev_qpos, self._qaddr, self.env.body_names),
            "ee_wpos": uhc_rewards_mod.env_ee_wpos(self.env),
            "com": uhc_rewards_mod.env_com(self.env),
            # the explicit/local/v2/v3 variants additionally read:
            "qpos": qpos,
            "prev_qpos": prev_qpos,
            "ee_pos": uhc_rewards_mod.env_ee_local(self.env),
            "wbquat": uhc_rewards_mod.env_wbquat(self.env),
            "wbpos": uhc_rewards_mod.env_wbpos(self.env),
            "body_com": uhc_rewards_mod.env_body_com(self.env),
        }

    def _target_pose(self, target_qpos: np.ndarray):
        quat, pos = self.target.fk(target_qpos)
        return quat[0].cpu().numpy(), pos[0].cpu().numpy()

    def _body_diff(self, tgt_wbpos: np.ndarray) -> float:
        return float(np.linalg.norm(
            self.env.get_wbody_pos()[: len(tgt_wbpos)] - tgt_wbpos, axis=1).sum())

    def step(
        self,
        cc_action: np.ndarray,        # (ndof [+6],) control-policy output
        target_qpos: np.ndarray,      # (76,) kinematic target (step_ar output)
        ar_qpos: np.ndarray | None = None,   # raw ARNet qpos (v3 reward terms)
        prev_target_qpos: np.ndarray | None = None,
        expert_ind: int | None = None,       # expert frame (UHC/sim rewards)
        old_action: np.ndarray | None = None,   # fine_tune_* action proximity
        kin_bquat: np.ndarray | None = None,    # fine_tune_* kinematic quats
    ):
        """-> (reward, done, info).  The PD tracks target_qpos[7:] through
        frame_skip substeps; reward scores the simulated pose against the
        target (and optionally the AR context) with the configured
        dynamic-supervision variant, or against the set_expert trajectory
        at expert_ind with the configured UHC world reward."""
        prev_bquat = self.env.get_body_quat()
        prev_qpos = self.env.get_qpos()
        prev_head = self.env.get_head_pose()
        # PD tracks the ACTUATED joints only — on the object-bearing *_all
        # models target_qpos may carry object dofs past the humanoid's
        pd_target = np.asarray(target_qpos[7:7 + self.env.ndof], np.float64)
        self.env.do_simulation(cc_action, pd_target)

        if self.sim_reward is not None:
            assert self._expert is not None, "call set_expert() first"
            ind = expert_ind if expert_ind is not None else 0
            cur = self._uhc_cur_state(prev_qpos)
            cur["head_pose"] = self.env.get_head_pose()
            cur["prev_head_pose"] = prev_head
            kwargs = dict(ws=self.reward_weights, dt=self.env.dt)
            name = self._ctor_args["reward_id"]
            if name.startswith("fine_tune"):
                if name != "fine_tune_action_reward":  # the others score a
                    # kinematic-pose proximity term
                    kwargs["kin_bquat"] = (
                        kin_bquat if kin_bquat is not None
                        else self._expert["bquat"][ind][4:])
                if name != "fine_tune_reward":
                    kwargs["old_action"] = (
                        old_action if old_action is not None
                        else np.zeros_like(np.asarray(cc_action)))
            if name == "deep_mimic_reward_v2_vf":
                kwargs["vf_dim"] = self.env.vf_dim
            args = [cur, self._expert, ind, np.asarray(cc_action)]
            if "old_action" in kwargs:
                args.append(kwargs.pop("old_action"))
            reward, components = self.sim_reward(*args, **kwargs)
            body_diff = self._body_diff(self._target_pose(target_qpos)[1])
            return float(reward), body_diff > self.term_body_diff, {
                "body_diff": body_diff, "components": components,
            }

        if self.uhc_reward is not None:
            assert self._expert is not None, "call set_expert() first"
            ind = expert_ind if expert_ind is not None else 0
            reward, components = self.uhc_reward(
                self._uhc_cur_state(prev_qpos), self._expert, ind,
                np.asarray(cc_action), ws=self.reward_weights,
                vf_dim=self.env.vf_dim, dt=self.env.dt,
            )
            body_diff = self._body_diff(self._target_pose(target_qpos)[1])
            return float(reward), body_diff > self.term_body_diff, {
                "body_diff": body_diff, "components": components,
            }

        sim = {"head_pose": self.env.get_head_pose(), "bquat": self.env.get_body_quat(), "prev_bquat": prev_bquat,
               "wbpos": self.env.get_wbody_pos()}
        reward, components, tgt_wbpos = self.target(sim, target_qpos, ar_qpos, prev_target_qpos)
        # env_term_body='body': simulated body diverged from the target
        body_diff = self._body_diff(tgt_wbpos)
        return reward, body_diff > self.term_body_diff, {"body_diff": body_diff, "components": components}
