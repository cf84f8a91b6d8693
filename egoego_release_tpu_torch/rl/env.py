"""The kinematic humanoid environment, batched over envs on one device
(port of egoego_release_tpu/rl/env.py).

The kinematic core of the reference's ``HumanoidAREnv``
(kinpoly/relive/envs/humanoid_ar_v1.py): a qpos state advanced by the
policy's actions with TrajARNet's integration (``models.trajar.step_qpos``),
imitation rewards against expert motion and the head-tracking termination
(fail_safe, copycat/envs/humanoid_im.py:267). The state of every env is one
tensor on the device (JAX vmaps over the envs; the reference farms them out
to CPU workers, khrylib/rl/agents/agent.py:107-131), and the FK runs through
the port's ``ops.fk``. Nothing here reaches a kernel of the port's: a step
is a few hundred small PyTorch kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from egoego_release_tpu_torch.models.trajar import ACTION_DIM, QVEL_DIM, step_qpos
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops import heading as heading_mod
from egoego_release_tpu_torch.ops import rotations as rot
from egoego_release_tpu_torch.rl.rewards import REWARD_FUNCS, RewardContext


class EnvState(NamedTuple):
    qpos: torch.Tensor   # (B, 76)
    qvel: torch.Tensor   # (B, 75)
    t: torch.Tensor      # (B,) int64 step index
    done: torch.Tensor   # (B,) bool


class KinematicHumanoidEnv:
    """Expert imitation. An expert is a dict of time-major tensors on the
    env's device: qpos (T, B, 76), head_pose (T, B, 7), head_vels (T, B, 6)."""

    def __init__(self, rest_offsets, w_pose=0.5, w_vel=0.1, w_head=0.4, k_pose=2.0, k_vel=0.005, k_head=5.0,
                 head_fail_dist=0.5, dt=1.0 / 30.0, reward_id: str | None = None,
                 reward_weights: dict | None = None, device="cuda"):
        """``reward_id`` picks a kinpoly reward of ``rl.rewards`` (e.g.
        'dynamic_supervision_v3', the statear production reward); None keeps
        the 3-term w exp(-k err) reward. The expert stands in for the
        reference's kinematic target, AR context and GT (``RewardContext``)."""
        self.device = torch.device(device)
        self.rest_offsets = torch.as_tensor(np.asarray(rest_offsets, np.float32), device=self.device)
        self.w = (w_pose, w_vel, w_head)
        self.k = (k_pose, k_vel, k_head)
        self.head_fail_dist = head_fail_dist
        self.dt = dt
        self.reward_id = reward_id
        self.reward_weights = reward_weights
        self.obs_dim = 74 + QVEL_DIM + 3 + 4 + 6  # local qpos, qvel, head differences, target velocities
        self.action_dim = ACTION_DIM

    def reset(self, expert_qpos0: torch.Tensor) -> EnvState:
        """Start from the expert's first frame (B, 76)."""
        b = expert_qpos0.shape[0]
        dev = expert_qpos0.device
        return EnvState(qpos=expert_qpos0, qvel=expert_qpos0.new_zeros(b, QVEL_DIM),
                        t=torch.zeros(b, dtype=torch.int64, device=dev),
                        done=torch.zeros(b, dtype=torch.bool, device=dev))

    def _body_pose(self, qpos: torch.Tensor):
        """Full-body FK: (global quats (B, 22, 4), world positions (B, 22, 3))."""
        trans, aa24 = geometry.qpos_to_smpl(qpos)
        return fk_mod.fk_smpl(trans, aa24[:, :fk_mod.NUM_JOINTS], self.rest_offsets)

    def _head_pose(self, qpos: torch.Tensor):
        gq, gp = self._body_pose(qpos)
        return gp[:, fk_mod.HEAD_IDX], gq[:, fk_mod.HEAD_IDX]

    def prepare_expert(self, expert: dict) -> dict:
        """The expert's full-body FK, once per batch (``step`` would
        otherwise run it on the fixed expert at every step): adds bquat
        (T, B, 22, 4) and wbpos (T, B, 22, 3)."""
        if "bquat" in expert:
            return expert
        q = expert["qpos"]
        t, b = q.shape[:2]
        gq, gp = self._body_pose(q.reshape(t * b, q.shape[-1]))
        return dict(expert, bquat=gq.reshape(t, b, fk_mod.NUM_JOINTS, 4), wbpos=gp.reshape(t, b, fk_mod.NUM_JOINTS, 3))

    def obs(self, state: EnvState, expert: dict) -> torch.Tensor:
        """The observation at the current step (HumanoidAREnv get_obs in
        spirit): heading-local qpos, qvel, the head's tracking differences and
        the target head velocity."""
        envs = torch.arange(state.qpos.shape[0], device=state.qpos.device)
        hpos, hrot = self._head_pose(state.qpos)
        target_head = expert["head_pose"][state.t, envs]   # (B, 7)
        target_hvel = expert["head_vels"][state.t, envs]   # (B, 6)
        diff_hpos = geometry.transform_vec(target_head[:, :3] - hpos, hrot, "heading")
        diff_hrot = rot.quat_multiply(rot.quat_invert(target_head[:, 3:]), hrot)
        qpos_local = torch.cat([state.qpos[:, 2:3], heading_mod.de_heading(state.qpos[:, 3:7]), state.qpos[:, 7:]],
                               dim=-1)
        return torch.cat([qpos_local, state.qvel, diff_hpos, diff_hrot, target_hvel], dim=-1)

    def step(self, state: EnvState, action: torch.Tensor, expert: dict):
        """(state, action (B, 80)) -> (state', reward (B,), done (B,))."""
        next_qpos, next_qvel = step_qpos(state.qpos, action, self.dt)
        t_last = expert["qpos"].shape[0] - 1
        t_next = torch.clamp(state.t + 1, max=t_last)
        envs = torch.arange(state.qpos.shape[0], device=state.qpos.device)

        e_qpos = expert["qpos"][t_next, envs]
        hpos, hrot = self._head_pose(next_qpos)
        e_head = expert["head_pose"][t_next, envs]
        head_err = ((hpos - e_head[:, :3]) ** 2).sum(-1)

        if self.reward_id is not None:
            cur_bquat, cur_wbpos = self._body_pose(next_qpos)
            prev_bquat, _ = self._body_pose(state.qpos)
            if "bquat" in expert:  # from prepare_expert
                e_bquat, e_wbpos = expert["bquat"][t_next, envs], expert["wbpos"][t_next, envs]
                e_prev_bquat = expert["bquat"][state.t, envs]
            else:
                e_bquat, e_wbpos = self._body_pose(e_qpos)
                e_prev_bquat, _ = self._body_pose(expert["qpos"][state.t, envs])
            # without a simulator the policy plays ARNet (ar_* is its
            # integrated pose) and the expert is both the kinematic target
            # and the GT, so v3's rp, rq and act_p hold the policy to the
            # expert instead of degenerating to exp(0) = 1
            ctx = RewardContext(cur_hpose=torch.cat([hpos, hrot], dim=-1), tgt_hpose=e_head, cur_bquat=cur_bquat,
                                prev_bquat=prev_bquat, cur_wbpos=cur_wbpos, tgt_bquat=e_bquat, tgt_wbpos=e_wbpos,
                                tgt_qpos=e_qpos, ar_qpos=next_qpos, ar_bquat=cur_bquat, ar_prev_bquat=prev_bquat,
                                gt_bquat=e_bquat, gt_prev_bquat=e_prev_bquat, dt=self.dt)
            reward, _ = REWARD_FUNCS[self.reward_id](ctx, self.reward_weights)
        else:
            # the 3-term reward: w exp(-k err) (reward_function.py's shape)
            pose_err = ((next_qpos[:, 7:] - e_qpos[:, 7:]) ** 2).mean(-1)
            vel_err = (next_qvel ** 2).mean(-1)
            (w_p, w_v, w_h), (k_p, k_v, k_h) = self.w, self.k
            reward = w_p * torch.exp(-k_p * pose_err) + w_v * torch.exp(-k_v * vel_err) + w_h * torch.exp(-k_h * head_err)

        fail = torch.sqrt(head_err) > self.head_fail_dist  # fail_safe termination
        done = state.done | fail | (t_next >= t_last)
        reward = torch.where(state.done, torch.zeros_like(reward), reward)
        frozen = state.done[:, None]
        new_state = EnvState(qpos=torch.where(frozen, state.qpos, next_qpos),
                             qvel=torch.where(frozen, state.qvel, next_qvel),
                             t=torch.where(state.done, state.t, t_next), done=done)
        return new_state, reward, done
