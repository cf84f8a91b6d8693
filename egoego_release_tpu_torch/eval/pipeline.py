"""Evaluation building blocks (port of egoego_release_tpu/eval/pipeline.py):
stage 1 (HeadNet + GravityNet) -> head pose -> sliding-window diffusion ->
FK -> floor -> metrics, per record and batched, and the multi-batch loop
``run_batches_pipelined``.

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
from egoego_release_tpu_torch.parallel.mesh import Mesh
from egoego_release_tpu_torch.utils import trace

HEAD_IDX = fk_mod.HEAD_IDX


def check_of_upload(of_bf16: bool, of_int8: bool) -> None:
    """The two OF upload modes exclude each other."""
    if of_bf16 and of_int8:
        raise ValueError("of_bf16 and of_int8 are mutually exclusive")


@dataclass
class EgoEgoPipeline:
    """The stage-2 model with its normalization stats and skeleton, and the
    stage-1 models, all on ``diffusion.device``.

    ``of_bf16`` / ``of_int8`` (off by default, the reference's numerics)
    apply to ``stage1_head_pose_batched``: the OF features go up in bf16,
    or in int8 with a per-(sequence, frame) absmax / 127 scale, and are cast
    back to f32 on the device. The deviation is a bf16 rounding of the
    features, or a quantization step of up to the row's absmax / 254."""

    diffusion: CondGaussianDiffusion
    stats: NormStats
    rest_offsets: torch.Tensor
    headnet: HeadFormer | None = None
    gravitynet: HeadNormalFormer | None = None
    dist_scale: float = 10.0
    of_bf16: bool = False
    of_int8: bool = False
    mesh: Mesh | None = None

    def __post_init__(self):
        check_of_upload(self.of_bf16, self.of_int8)

    def shard(self, mesh: Mesh) -> "EgoEgoPipeline":
        """Multi-GPU eval (JAX ``eval/pipeline.py:72-88``): the denoiser's
        layers split over tp (``CondGaussianDiffusion.shard``), stage 1
        replicated (every rank runs it on the same inputs), and the stage-2
        batch of ``stage2_generate*`` (so of ``run_batches_pipelined``) split
        over dp, padded to a multiple of dp; every rank gets every result."""
        self.diffusion.shard(mesh)
        self.mesh = mesh
        return self

    @property
    def device(self) -> torch.device:
        return self.diffusion.device

    def _as_tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _upload(self, a) -> torch.Tensor:
        """A host array on the device; to the card from pinned memory on the
        current stream, without blocking the host."""
        t = torch.as_tensor(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage1(self, of, init_quat, aligned, ori_trans, ori_mat, gt_head_pose) -> dict:
        """Stage 1 of N sequences on device tensors (JAX ``_stage1_impl``
        under ``jax.vmap``): of (N, T, 512), init_quat (N, 4), aligned SLAM
        trans (N, T', 3), ori_trans (N, T+1, 3), ori_mat (N, T+1, 3, 3), GT
        head pose (N, T+1, 7). Translation from GravityNet, orientation from
        HeadNet."""
        head_out = headformer_forward_for_eval(self.headnet, of, init_quat, aligned, dist_scale=self.dist_scale)
        ori_trans = ori_trans - ori_trans[:, 0:1]
        feats, mask = prep_gravitynet_input(ori_mat, ori_trans, self.gravitynet.window)
        normal = self.gravitynet(feats, mask)
        normal_out = gravitynet_eval_transform(normal, ori_mat, ori_trans, head_out["pred_scale"], gt_head_pose)
        t = min(normal_out["head_pose"].shape[1], head_out["head_pose"].shape[1])
        head_pose = torch.cat([normal_out["head_pose"][:, :t, :3], head_out["head_pose"][:, :t, 3:]], dim=-1)
        return {"head_pose": head_pose, "pred_scale": head_out["pred_scale"], "pred_normal": normal}

    @torch.no_grad()
    def stage1_head_pose(self, record: dict) -> dict:
        """HeadNet + GravityNet -> world head pose (T, 7) for one record
        (of (T, 512), head_pose (T+1, 7) GT, aligned_slam_trans, ori_slam_trans
        (T+1, 3), ori_slam_rot_mat (T+1, 3, 3)), with f32 uploads whatever
        ``of_bf16`` / ``of_int8`` say, as in JAX. Returns head_pose,
        pred_scale, pred_normal on the pipeline's device."""
        gt = self._as_tensor(record["head_pose"])
        out = self._stage1(self._as_tensor(record["of"])[None], gt[None, 0, 3:],
                           self._as_tensor(record["aligned_slam_trans"])[None],
                           self._as_tensor(record["ori_slam_trans"])[None],
                           self._as_tensor(record["ori_slam_rot_mat"])[None], gt[None])
        return {k: v[0] for k, v in out.items()}

    @torch.no_grad()
    def stage1_head_pose_batched(self, records: list[dict]) -> dict:
        """N same-length records through stage 1 as one batch (HeadNet sees
        all N x ceil(T / window) blocks at once; one host integration and
        one host Umeyama solve for the batch). The four pose-length inputs
        go up as one packed (N, T+1, 7 + 3 + 3 + 9) array, the OF features
        on their own (they may be a frame shorter), each from pinned memory
        on the current stream; ``of_bf16`` / ``of_int8`` set the OF upload.
        Returns head_pose (N, T, 7), pred_scale (N,), pred_normal (N, 3)."""
        packed = np.stack([np.concatenate([
            np.asarray(r["head_pose"], np.float32),
            np.asarray(r["aligned_slam_trans"], np.float32),
            np.asarray(r["ori_slam_trans"], np.float32),
            np.asarray(r["ori_slam_rot_mat"], np.float32).reshape(-1, 9),
        ], axis=-1) for r in records])
        of_np = np.stack([np.asarray(r["of"], np.float32) for r in records])
        if self.of_int8:
            scale = np.abs(of_np).max(axis=-1, keepdims=True) / 127.0
            scale = np.maximum(scale, np.float32(1e-12)).astype(np.float32)
            of_q = np.clip(np.rint(of_np / scale), -127, 127).astype(np.int8)
            of = self._upload(of_q).float() * self._upload(scale)
        elif self.of_bf16:
            of = self._upload(torch.from_numpy(of_np).to(torch.bfloat16)).float()
        else:
            of = self._upload(of_np)
        p = self._upload(packed)
        hp = p[..., :7]
        return self._stage1(of, hp[:, 0, 3:], p[..., 7:10], p[..., 10:13],
                            p[..., 13:22].reshape(p.shape[:2] + (3, 3)), hp)

    def stage2_generate(self, head_pose, noise, sample_bs: int = 1):
        """Head pose (T, 7) -> (local_aa (S, T', 22, 3), root_pos (S, T', 3))
        for ``sample_bs`` samples of one sequence."""
        rep = self._as_tensor(head_pose)[None].expand(sample_bs, -1, -1)
        return self.stage2_generate_batched(rep, noise)

    def stage2_generate_batched(self, head_poses, noise):
        """(N, T, 7) distinct sequences sampled as one batch (over the dp
        ranks of the mesh, when the pipeline has one)."""
        hp = self._as_tensor(head_poses)
        return self.diffusion.sample_sliding_window_w_canonical(
            hp[:, :, :3].contiguous(), hp[:, :, 3:].contiguous(), self.stats, self.rest_offsets,
            noise=noise, mesh=self.mesh)

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


def _tile_samples(head_poses, gt_jrot, gt_jpos, sample_bs: int):
    """(N, ...) -> (N S, ...), the sample index fastest (seq-major groups)."""
    return tuple(a.repeat_interleave(sample_bs, 0) for a in (head_poses, gt_jrot, gt_jpos))


def _eval_chain_dispatch(pipeline: EgoEgoPipeline, head_poses, gt_global_jrot, gt_global_jpos, noise):
    """The chain for (N, T, 7) conditions, FK and the initial-head-xy
    centring, queued without a host sync. Returns device tensors
    (pred_jrot, pred_jpos_c, gt_jrot_t, gt_jpos_c), trimmed to the shorter
    of prediction and GT."""
    local_aa, root_pos = pipeline.stage2_generate_batched(head_poses, noise)
    pred_jrot, pred_jpos = pipeline.fk(root_pos, local_aa)
    t = min(pred_jpos.shape[1], gt_global_jpos.shape[1])
    xy = gt_global_jpos.new_tensor([1.0, 1.0, 0.0])
    return (pred_jrot[:, :t], pred_jpos[:, :t] - pred_jpos[:, 0:1, HEAD_IDX:HEAD_IDX + 1, :] * xy,
            gt_global_jrot[:, :t], gt_global_jpos[:, :t] - gt_global_jpos[:, 0:1, HEAD_IDX:HEAD_IDX + 1, :] * xy)


def _eval_metrics_dispatch(chain_out, extra_cols=None):
    """The metric suite behind the chain, with each prediction's floor from
    the device clustering (ops/floor.py), flattened into one (rows, cols)
    tensor: the metrics in sorted key order, then ``extra_cols`` (N, E)
    passed through, each row repeated over its sequence's samples. Returns
    (flat, spec [(key, width)], E)."""
    pred_jrot, pred_jpos_c, gt_jrot_t, gt_jpos_c = chain_out
    floors = floor_mod.floor_heights(pred_jpos_c)
    md = metrics_mod.compute_metrics_for_smpl(gt_jrot_t, gt_jpos_c, 0.0, pred_jrot, pred_jpos_c, floors)
    spec, cols = [], []
    for k in sorted(md):
        v = md[k].reshape(md[k].shape[0], -1)
        spec.append((k, v.shape[1]))
        cols.append(v)
    if extra_cols is None:
        return torch.cat(cols, dim=1), spec, 0
    cols.append(extra_cols.repeat_interleave(pred_jrot.shape[0] // extra_cols.shape[0], 0))
    return torch.cat(cols, dim=1), spec, extra_cols.shape[-1]


def _unflatten_metrics(flat: np.ndarray, spec) -> list[dict]:
    out = []
    for s in range(flat.shape[0]):
        d, o = {}, 0
        for k, w in spec:
            d[k] = flat[s, o] if w == 1 else flat[s, o: o + w]
            o += w
        out.append(d)
    return out


def select_best_of(mds: list[dict], n_seqs: int, sample_bs: int) -> list[dict]:
    """The best of each sequence's ``sample_bs`` candidates by MPJPE; mds
    is seq-major ((seq 0, s 0..S-1), (seq 1, ...))."""
    assert len(mds) == n_seqs * sample_bs
    return [min(mds[i * sample_bs:(i + 1) * sample_bs], key=lambda d: float(d["mpjpe"])) for i in range(n_seqs)]


def evaluate_batch(pipeline: EgoEgoPipeline, head_poses, gt_global_jrot, gt_global_jpos,
                   noise, sample_bs: int = 1) -> list[dict]:
    """N sequences (x ``sample_bs`` candidates each, sample index fastest)
    sampled in one chain, then the metric suite with the device floor and
    one device-to-host copy. Returns N metric dicts, each the best of its
    candidates by MPJPE."""
    hp, gq, gp = (pipeline._as_tensor(a) for a in (head_poses, gt_global_jrot, gt_global_jpos))
    n = hp.shape[0]
    if sample_bs > 1:
        hp, gq, gp = _tile_samples(hp, gq, gp, sample_bs)
    flat, spec, _ = _eval_metrics_dispatch(_eval_chain_dispatch(pipeline, hp, gq, gp, noise))
    mds = _unflatten_metrics(flat.cpu().numpy(), spec)
    return select_best_of(mds, n, sample_bs) if sample_bs > 1 else mds


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


def _gt_prep(pipeline: EgoEgoPipeline, trans: torch.Tensor, local_aa: torch.Tensor):
    """(N, T, 3) root trans + (N, T, 22, 3) local axis-angle -> FK, the
    device floor (ops/floor.py) and the snap, and the head pose, with no
    host transfer."""
    n, t = trans.shape[:2]
    gq, gp = fk_mod.fk_smpl(trans.reshape(n * t, 3), local_aa.reshape(n * t, 22, 3), pipeline.rest_offsets)
    gq, gp = gq.reshape(n, t, 22, 4), gp.reshape(n, t, 22, 3)
    floors = floor_mod.floor_heights(gp)
    gp = gp - floors[:, None, None, None] * gp.new_tensor([0.0, 0.0, 1.0])
    head_pose = torch.cat([gp[:, :, HEAD_IDX], gq[:, :, HEAD_IDX]], dim=-1)
    return gq, gp, head_pose


def gt_from_smpl_params_batched(pipeline: EgoEgoPipeline, trans, root_orient, body_pose):
    """(N, T, ...) params -> (jrot (N,T,22,4), jpos (N,T,22,3), head_pose
    (N,T,7)) with the device floor clustering (ops/floor.py); one packed
    upload."""
    packed = pipeline._upload(np.concatenate([np.asarray(a, np.float32) for a in (trans, root_orient, body_pose)],
                                             axis=-1))
    n, t = packed.shape[:2]
    local_aa = torch.cat([packed[..., None, 3:6], packed[..., 6:].reshape(n, t, 21, 3)], dim=2)
    return _gt_prep(pipeline, packed[..., :3], local_aa)


def gt_from_qpos_batched(pipeline: EgoEgoPipeline, qpos):
    """Kinpoly qpos (N, T, 76) -> the same as ``gt_from_smpl_params_batched``
    through the qpos -> SMPL codec, on the device (JAX ``_gt_prep_qpos``)."""
    q = pipeline._upload(np.asarray(qpos, np.float32))
    n, t = q.shape[:2]
    trans, aa24 = geometry.qpos_to_smpl(q.reshape(n * t, -1))
    return _gt_prep(pipeline, trans.reshape(n, t, 3), aa24[:, :22].reshape(n, t, 22, 3))


def _prechain(pf: dict) -> dict:
    """A batch's chain conditioning on the device: in stage-1 mode the
    stage-1 head pose trimmed to min(GT length, GT head-pose length), its
    metric triple after moving both initial xy positions to the origin
    (trimmed to the shorter, as ``stage1_metrics``), then the head pose
    moved to start at the floor-snapped GT head; in GT-head mode the GT head
    pose itself and no triple."""
    if pf["s1"] is None:
        return {"hp": pf["head"], "gq": pf["gq"], "gp": pf["gp"], "s1m": None}
    ghp, head = pf["ghp"], pf["head"]
    t_hp = head.shape[1] if ghp is None else min(head.shape[1], ghp.shape[1])
    hp = pf["s1"]["head_pose"][:, :t_hp]
    gt_cmp = head if ghp is None else ghp
    t_cmp = min(hp.shape[1], gt_cmp.shape[1])
    pred, gt = hp[:, :t_cmp], gt_cmp[:, :t_cmp]
    pred = torch.cat([pred[..., :2] - pred[:, 0:1, :2], pred[..., 2:]], dim=-1)
    gt = torch.cat([gt[..., :2] - gt[:, 0:1, :2], gt[..., 2:]], dim=-1)
    s1m = torch.stack(metrics_mod.compute_head_pose_metrics(
        pred[..., :3], rot.quat_to_matrix(pred[..., 3:]), gt[..., :3], rot.quat_to_matrix(gt[..., 3:])), dim=-1)
    shift = head[:, 0:1, :3] - hp[:, 0:1, :3]
    hp = torch.cat([hp[..., :3] + shift, hp[..., 3:]], dim=-1)
    return {"hp": hp, "gq": pf["gq"], "gp": pf["gp"], "s1m": s1m}


@trace.entered
def run_batches_pipelined(pipeline: EgoEgoPipeline, batches: list[dict], noise, sample_bs: int = 1):
    """Evaluate several batches of sequences in JAX's dispatch order, with
    one blocking device-to-host copy a batch.

    Each batch dict: ``records`` (stage-1 eval records, or None to
    condition on the GT head pose) and the GT bodies as either SMPL params
    ``gt_trans`` (N,T,3), ``gt_root_orient`` (N,T,3), ``gt_body_pose``
    (N,T,63) or kinpoly ``gt_qpos`` (N,T,76), decoded on the device; an
    optional ``gt_head_pose`` (N,T',7) is what the stage-1 metrics compare
    against (eval_egoego compares against the record's head pose). ``noise``
    is one noise source per batch (a list), or a source whose ``split``
    gives them (``TorchNoise``). Returns per batch {"metrics": N metric
    dicts, "s1": (e, o, t) arrays of N, or None in GT-head mode}.

    Per batch k, in JAX's order: batch k's pre-chain work, batch k+1's
    uploads, GT prep and stage 1, chain k with its metric suite, then the
    collection of batch k-1, the one blocking device-to-host copy a batch
    (into pinned memory behind an event). Everything runs on the current
    stream: the chain's enqueue is host-bound, so the card has drained
    chain k-1 by the time batch k+1's host steps (the ``va2rot`` integration
    and the Umeyama solve) wait on it. The result is the same as
    ``gt_from_*_batched`` + ``stage1_head_pose_batched`` + ``evaluate_batch``
    per batch with the same noise sources. An entry of the span recorder
    (``utils/trace.py``), with the ``driver.*`` spans of each batch."""
    n_b = len(batches)
    if n_b == 0:
        return []
    noises = list(noise) if isinstance(noise, (list, tuple)) else noise.split(n_b)
    if len(noises) != n_b:
        raise ValueError(f"{len(noises)} noise sources for {n_b} batches")
    cuda = pipeline.device.type == "cuda"
    results: list = [None] * n_b

    def prefetch(k):
        batch = batches[k]
        with trace.span("driver.prefetch", k):
            if "gt_qpos" in batch:
                gq, gp, head = gt_from_qpos_batched(pipeline, batch["gt_qpos"])
            else:
                gq, gp, head = gt_from_smpl_params_batched(pipeline, batch["gt_trans"], batch["gt_root_orient"],
                                                           batch["gt_body_pose"])
            records = batch.get("records")
            ghp = batch.get("gt_head_pose")
            s1 = None
            if records is not None:
                with trace.span("driver.stage1"):
                    s1 = pipeline.stage1_head_pose_batched(records)
            return {"gq": gq, "gp": gp, "head": head, "s1": s1,
                    "ghp": None if ghp is None else pipeline._upload(np.asarray(ghp, np.float32))}

    def collect(k, n_seqs, host, done, spec, n_extra):
        with trace.span("driver.collect", k):
            if done is not None:
                with trace.span("driver.wait"):
                    done.synchronize()
            flat = host.numpy()
            mds = _unflatten_metrics(flat[:, :-n_extra] if n_extra else flat, spec)
            s1 = None
            if n_extra:
                s1_np = flat[::sample_bs, -n_extra:]
                s1 = tuple(s1_np[:, i].copy() for i in range(n_extra))
            results[k] = {"metrics": select_best_of(mds, n_seqs, sample_bs) if sample_bs > 1 else mds, "s1": s1}

    pending = None
    with torch.no_grad():
        pf = prefetch(0)
        for k in range(n_b):
            with trace.span("driver.prechain", k):
                prep = _prechain(pf)
            pf = prefetch(k + 1) if k + 1 < n_b else None
            hp, gq, gp = prep["hp"], prep["gq"], prep["gp"]
            n_seqs = hp.shape[0]
            if sample_bs > 1:
                hp, gq, gp = _tile_samples(hp, gq, gp, sample_bs)
            with trace.span("driver.chain", k):
                chain = _eval_chain_dispatch(pipeline, hp, gq, gp, noises[k])
            with trace.span("driver.metrics", k):
                flat, spec, n_extra = _eval_metrics_dispatch(chain, prep["s1m"])
            del chain  # the chain's outputs are the metric suite's alone: free them before the next chain
            with trace.span("driver.copy", k):
                if cuda:
                    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                    host.copy_(flat, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host, done = flat, None
            if pending is not None:
                collect(*pending)
            pending = (k, n_seqs, host, done, spec, n_extra)
        collect(*pending)
    return results


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
