"""Evaluation building blocks (port of egoego_release_tpu/eval/pipeline.py,
per-record paths): stage 1 (HeadNet + GravityNet) -> head pose ->
sliding-window diffusion -> FK -> floor -> metrics.

Randomness comes from a noise source (``ops.fused_step.TorchNoise`` or a
replay of another framework's draws) instead of a JAX key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, NormStats
from egoego_release_tpu_torch.eval import metrics as metrics_mod
from egoego_release_tpu_torch.models.gravitynet import (
    HeadNormalFormer,
    gravitynet_eval_transform,
    prep_gravitynet_input,
)
from egoego_release_tpu_torch.models.headnet import HeadFormer, headformer_forward_for_eval
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import floor as floor_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops import rotations as rot

HEAD_IDX = fk_mod.HEAD_IDX


@dataclass
class EgoEgoPipeline:
    """The stage-2 model with its normalization stats and skeleton, and the
    stage-1 models, all on ``diffusion.device``."""

    diffusion: CondGaussianDiffusion
    stats: NormStats
    rest_offsets: torch.Tensor
    headnet: HeadFormer | None = None
    gravitynet: HeadNormalFormer | None = None
    dist_scale: float = 10.0

    @property
    def device(self) -> torch.device:
        return self.diffusion.device

    def _as_tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def stage1_head_pose(self, record: dict) -> dict:
        """HeadNet + GravityNet -> world head pose (T, 7) for one record
        (of (T, 512), head_pose (T+1, 7) GT, aligned_slam_trans, ori_slam_trans
        (T+1, 3), ori_slam_rot_mat (T+1, 3, 3)): translation from GravityNet,
        orientation from HeadNet. Returns head_pose, pred_scale, pred_normal
        on the pipeline's device."""
        gt_head_pose = self._as_tensor(record["head_pose"])
        head_out = headformer_forward_for_eval(
            self.headnet, self._as_tensor(record["of"])[None], gt_head_pose[0:1, 3:],
            self._as_tensor(record["aligned_slam_trans"]), dist_scale=self.dist_scale)
        ori_trans = self._as_tensor(record["ori_slam_trans"])
        ori_trans = ori_trans - ori_trans[0:1]
        ori_mat = self._as_tensor(record["ori_slam_rot_mat"])
        feats, mask = prep_gravitynet_input(ori_mat[None], ori_trans[None], self.gravitynet.window)
        normal = self.gravitynet(feats, mask)[0]
        normal_out = gravitynet_eval_transform(normal, ori_mat, ori_trans, head_out["pred_scale"],
                                               gt_head_pose)
        t = min(normal_out["head_pose"].shape[0], head_out["head_pose"].shape[1])
        head_pose = torch.cat([normal_out["head_pose"][:t, :3], head_out["head_pose"][0, :t, 3:]], dim=-1)
        return {"head_pose": head_pose, "pred_scale": head_out["pred_scale"], "pred_normal": normal}

    def stage2_generate(self, head_pose, noise, sample_bs: int = 1):
        """Head pose (T, 7) -> (local_aa (S, T', 22, 3), root_pos (S, T', 3))
        for ``sample_bs`` samples of one sequence."""
        rep = self._as_tensor(head_pose)[None].expand(sample_bs, -1, -1)
        return self.stage2_generate_batched(rep, noise)

    def stage2_generate_batched(self, head_poses, noise):
        """(N, T, 7) distinct sequences sampled as one batch."""
        hp = self._as_tensor(head_poses)
        return self.diffusion.sample_sliding_window_w_canonical(
            hp[:, :, :3].contiguous(), hp[:, :, 3:].contiguous(), self.stats, self.rest_offsets,
            noise=noise)

    def fk(self, root_pos: torch.Tensor, local_aa: torch.Tensor):
        """(B, T, 3) + (B, T, 22, 3) -> (B, T, 22, 4), (B, T, 22, 3)."""
        b, t = root_pos.shape[:2]
        gq, gp = fk_mod.fk_smpl(root_pos.reshape(-1, 3), local_aa.reshape(-1, 22, 3),
                                self.rest_offsets)
        return gq.reshape(b, t, 22, 4), gp.reshape(b, t, 22, 3)


def _to_numpy(md: dict) -> dict:
    """Metric tensors -> numpy in two device-to-host copies: the stacked
    per-sequence values, and single_jpe."""
    keys = [k for k in md if k != "single_jpe"]
    out = dict(zip(keys, torch.stack([md[k] for k in keys]).cpu().numpy()))
    out["single_jpe"] = md["single_jpe"].cpu().numpy()
    return out


def evaluate_sequence(pipeline: EgoEgoPipeline, gt_head_pose, gt_global_jrot, gt_global_jpos,
                      noise, sample_bs: int = 1):
    """Stage-2 generation and metrics for one sequence, the best of
    ``sample_bs`` samples by MPJPE; floors by the host DBSCAN."""
    local_aa, root_pos = pipeline.stage2_generate(gt_head_pose, noise, sample_bs=sample_bs)
    pred_jrot, pred_jpos = pipeline.fk(root_pos, local_aa)
    gt_global_jrot = pipeline._as_tensor(gt_global_jrot)
    gt_global_jpos = pipeline._as_tensor(gt_global_jpos)
    t = min(pred_jpos.shape[1], gt_global_jpos.shape[0])

    xy = gt_global_jpos.new_tensor([1.0, 1.0, 0.0])
    gt_jpos_c = gt_global_jpos[:t] - gt_global_jpos[0:1, HEAD_IDX:HEAD_IDX + 1, :] * xy
    pred_jpos_c = pred_jpos[:, :t] - pred_jpos[:, 0:1, HEAD_IDX:HEAD_IDX + 1, :] * xy

    best = None
    for s in range(sample_bs):
        pred_floor, _, _ = geometry.determine_floor_height_and_contacts(
            pred_jpos_c[s].cpu().numpy(), fps=30)
        md = _to_numpy(metrics_mod.compute_metrics_for_smpl(
            gt_global_jrot[:t], gt_jpos_c, 0.0, pred_jrot[s, :t], pred_jpos_c[s],
            float(np.float32(pred_floor))))
        if best is None or md["mpjpe"] < best[0]["mpjpe"]:
            best = (md, s)
    md, s = best
    return md, {
        "local_aa": local_aa[s].cpu().numpy(),
        "root_pos": root_pos[s].cpu().numpy(),
        "pred_jpos": pred_jpos_c[s].cpu().numpy(),
        "pred_jrot": pred_jrot[s].cpu().numpy(),
    }


def evaluate_batch(pipeline: EgoEgoPipeline, head_poses, gt_global_jrot, gt_global_jpos,
                   noise, sample_bs: int = 1) -> list[dict]:
    """N sequences (x ``sample_bs`` candidates each, sample index fastest)
    sampled in one chain, then metrics per sequence with the device floor
    (ops/floor.py). Returns N metric dicts, each the best of its candidates
    by MPJPE."""
    hp = pipeline._as_tensor(head_poses)
    gq_all = pipeline._as_tensor(gt_global_jrot)
    gp_all = pipeline._as_tensor(gt_global_jpos)
    n = hp.shape[0]
    if sample_bs > 1:
        hp, gq_all, gp_all = (a.repeat_interleave(sample_bs, 0) for a in (hp, gq_all, gp_all))
    local_aa, root_pos = pipeline.stage2_generate_batched(hp, noise)
    pred_jrot, pred_jpos = pipeline.fk(root_pos, local_aa)
    t = min(pred_jpos.shape[1], gp_all.shape[1])
    xy = gp_all.new_tensor([1.0, 1.0, 0.0])
    pred_jpos_c = pred_jpos[:, :t] - pred_jpos[:, 0:1, HEAD_IDX:HEAD_IDX + 1, :] * xy
    gt_jpos_c = gp_all[:, :t] - gp_all[:, 0:1, HEAD_IDX:HEAD_IDX + 1, :] * xy
    floors = floor_mod.floor_heights(pred_jpos_c)
    md = _to_numpy(metrics_mod.compute_metrics_for_smpl(
        gq_all[:, :t], gt_jpos_c, 0.0, pred_jrot[:, :t], pred_jpos_c, floors))
    mds = [{k: v[i] for k, v in md.items()} for i in range(hp.shape[0])]
    if sample_bs > 1:
        mds = [min(mds[i * sample_bs:(i + 1) * sample_bs], key=lambda d: float(d["mpjpe"]))
               for i in range(n)]
    return mds


def gt_from_smpl_params(pipeline: EgoEgoPipeline, trans, root_orient, body_pose):
    """AMASS params (T, 3), (T, 3), (T, 63) -> GT FK (jrot (T,22,4), jpos
    (T,22,3)) snapped to the host-DBSCAN floor, and the GT head pose (T, 7)."""
    trans, root_orient, body_pose = (pipeline._as_tensor(a) for a in (trans, root_orient, body_pose))
    local_aa = torch.cat([root_orient[:, None, :], body_pose.reshape(-1, 21, 3)], dim=1)
    gq, gp = fk_mod.fk_smpl(trans, local_aa, pipeline.rest_offsets)
    floor, _, _ = geometry.determine_floor_height_and_contacts(gp.cpu().numpy(), fps=30)
    gp = gp.clone()
    gp[:, :, 2] = gp[:, :, 2] - float(np.float32(floor))
    head_pose = torch.cat([gp[:, HEAD_IDX, :], gq[:, HEAD_IDX, :]], dim=-1)
    return gq, gp, head_pose


def gt_from_smpl_params_batched(pipeline: EgoEgoPipeline, trans, root_orient, body_pose):
    """(N, T, ...) params -> (jrot (N,T,22,4), jpos (N,T,22,3), head_pose
    (N,T,7)) with the device floor clustering (ops/floor.py)."""
    trans, root_orient, body_pose = (pipeline._as_tensor(a) for a in (trans, root_orient, body_pose))
    n, t = trans.shape[:2]
    local_aa = torch.cat([root_orient[:, :, None, :], body_pose.reshape(n, t, 21, 3)], dim=2)
    gq, gp = fk_mod.fk_smpl(trans.reshape(n * t, 3), local_aa.reshape(n * t, 22, 3),
                            pipeline.rest_offsets)
    gq, gp = gq.reshape(n, t, 22, 4), gp.reshape(n, t, 22, 3)
    floors = floor_mod.floor_heights(gp)
    gp = gp - floors[:, None, None, None] * gp.new_tensor([0.0, 0.0, 1.0])
    head_pose = torch.cat([gp[:, :, HEAD_IDX], gq[:, :, HEAD_IDX]], dim=-1)
    return gq, gp, head_pose


def stage1_metrics(head_pose_pred, head_pose_gt):
    """Stage-1 metric triple (head pose distance, rotation distance,
    translation error in mm) after moving both initial xy positions to the
    origin; numpy (T, 7) inputs, trimmed to the shorter."""
    pred = np.array(head_pose_pred, dtype=np.float32)
    gt = np.array(head_pose_gt, dtype=np.float32)
    t = min(pred.shape[0], gt.shape[0])
    pred, gt = pred[:t], gt[:t]
    pred[:, :2] -= pred[0:1, :2]
    gt[:, :2] -= gt[0:1, :2]
    pred, gt = torch.from_numpy(pred), torch.from_numpy(gt)
    hd, hrd, hte = metrics_mod.compute_head_pose_metrics(
        pred[:, :3], rot.quat_to_matrix(pred[:, 3:]), gt[:, :3], rot.quat_to_matrix(gt[:, 3:]))
    return float(hd), float(hrd), float(hte)
