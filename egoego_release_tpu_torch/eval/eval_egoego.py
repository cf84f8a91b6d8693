"""Full-pipeline eval on ARES / GIMO / Kinpoly-MoCap, on the card.

Port of egoego_release_tpu/eval/eval_egoego.py with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions of
the kernels). Per test sequence:

  stage 1 (HeadNet + GravityNet) -> stage-1 head metrics
  -> qpos GT -> FK -> floor snap -> head-pose floor alignment
  -> stage-2 conditional diffusion (best of --sample_bs by MPJPE)
  -> full metric suite -> JSON.

Scene splits, "step"-sequence exclusion and the SLAM-failure blacklist
follow the JAX CLI, and so do the numerics: f32 unless ``--fused_step``
(the bf16 step kernels) or ``--fused`` (the bf16 fused_decoder_layer
denoiser) is given. ``--batch_seqs N`` evaluates same-length sequences N
at a time through ``pipeline.run_batches_pipelined`` (device floor, one
chain per chunk); ``--of_bf16`` / ``--of_int8`` set that path's OF upload.
``--dp N --tp M`` runs on N x M ranks as ``eval_stage2 --dp/--tp`` does:
stage 1 replicated, stage 2 split. ``--mujoco_xml`` decodes the GT through
the humanoid XML's skeleton
(``ops.mujoco_xml.qpos_fk`` on the device) instead of the SMPL rest
offsets, and ``--save_html_vis`` writes a pred-vs-GT skeleton animation per
sequence; both take the per-sequence path, as in JAX.

    python -m egoego_release_tpu_torch.eval.eval_egoego \\
        --data_root_folder <root> --full_body_gt_path <mocap_annotations.p> \\
        --stats_path <stats.p> --rest_offsets <rest.npy> --out_dir results
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np

from egoego_release_tpu_torch.data.formats import load_motion_dict, load_pickle
from egoego_release_tpu_torch.data.headpose import (
    ARESHeadPoseDataset,
    GIMOHeadPoseDataset,
    RealWorldHeadPoseDataset,
)
from egoego_release_tpu_torch.eval.build import build_pipeline
from egoego_release_tpu_torch.eval.eval_stage2 import compute_dtype
from egoego_release_tpu_torch.eval.pipeline import (
    HEAD_IDX,
    evaluate_sequence,
    run_batches_pipelined,
    stage1_metrics,
)
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.ops.mujoco_xml import load_mujoco_skeleton, qpos_fk
from egoego_release_tpu_torch.parallel.mesh import spawn
from egoego_release_tpu_torch.utils.logging import profile_trace
from egoego_release_tpu_torch.vis.html_viewer import vis_skeleton_motion_html

ARES_TEST_SCENES = ("office_0", "hotel_0", "room_2", "frl_apartment_4", "apartment_0")
GIMO_TEST_SCENES = ("storeroom0217", "classroom0219", "lab0220", "kitchen0214")


def select_dataset(opt):
    if opt.test_on_ares:
        return ARESHeadPoseDataset(opt.data_root_folder, train=False, window=opt.window, for_eval=True)
    if opt.test_on_gimo:
        return GIMOHeadPoseDataset(opt.data_root_folder, train=False, window=opt.window, for_eval=True)
    return RealWorldHeadPoseDataset(opt.data_root_folder, train=False, window=opt.window, for_eval=True,
                                    eval_on_kinpoly_mocap=True)


def keep_sequence(opt, seq_name: str, bad_seqs: set) -> bool:
    if seq_name in bad_seqs or seq_name + ".npz" in bad_seqs:
        return False
    if opt.test_on_ares:
        return seq_name.split("-")[0] in ARES_TEST_SCENES
    if opt.test_on_gimo:
        return seq_name.split("-")[0] in GIMO_TEST_SCENES
    return "step" not in seq_name


def bucket_key(rec: dict, gt_rec: dict) -> tuple:
    """Every stacked array's length: SLAM results may be truncated and the GT
    head pose may be shorter than the qpos (the per-sequence path trims to
    the shorter; stacking cannot)."""
    return (np.asarray(rec["of"]).shape[0], np.asarray(rec["head_pose"]).shape[0],
            np.asarray(rec["aligned_slam_trans"]).shape[0], np.asarray(rec["ori_slam_trans"]).shape[0],
            np.asarray(gt_rec["qpos"]).shape[0], np.asarray(gt_rec["head_pose"]).shape[0])


def run_batched(opt, pipeline, eligible, noise):
    """--batch_seqs N > 1: same-length sequences in chunks of N through
    ``run_batches_pipelined`` (qpos GT decode, stage 1, chain and metrics
    on the device). Yields (seq_name, metric dict, (s1_e, s1_o, s1_t)); the
    stage-1 triple is exact zeros with --use_gt_head_pose, as the
    per-sequence path's self-comparison."""
    buckets: dict = {}
    for item in eligible:
        buckets.setdefault(bucket_key(item[1], item[2]), []).append(item)
    chunks = [items[s: s + opt.batch_seqs] for items in buckets.values()
              for s in range(0, len(items), opt.batch_seqs)]
    batches = [{
        "records": None if opt.use_gt_head_pose else [rec for _, rec, _ in chunk],
        "gt_qpos": np.stack([np.asarray(gt["qpos"], np.float32) for _, _, gt in chunk]),
        "gt_head_pose": np.stack([np.asarray(gt["head_pose"], np.float32) for _, _, gt in chunk]),
    } for chunk in chunks]
    t0 = time.perf_counter()
    with profile_trace(opt.profile_dir):
        res = run_batches_pipelined(pipeline, batches, noise, sample_bs=opt.sample_bs)
    dt = time.perf_counter() - t0
    n = sum(len(c) for c in chunks)
    print(f"batched eval: {n} seqs in {dt:.1f}s ({n / dt:.2f} seqs/sec on {pipeline.device})")
    for chunk, b in zip(chunks, res):
        for j, ((seq_name, _, _), md) in enumerate(zip(chunk, b["metrics"])):
            s1 = (0.0, 0.0, 0.0) if b["s1"] is None else tuple(float(v[j]) for v in b["s1"])
            yield seq_name, md, s1


def run_per_sequence(opt, pipeline, eligible, noise):
    """--batch_seqs 1: stage 1, GT and stage 2 one sequence at a time, with
    the host DBSCAN floor; the same yields as ``run_batched``. With
    ``--mujoco_xml`` the GT bodies come from ``qpos_fk`` through the XML's
    skeleton, reordered into SMPL joint order (JAX
    ``eval/eval_egoego.py:195-204``, whose reorder is the inverse one);
    with ``--save_html_vis`` each sequence's pred / GT / head animation is
    written, every layer centred on the GT's first head xy (JAX
    ``eval/eval_egoego.py:225-240``)."""
    skeleton = load_mujoco_skeleton(opt.mujoco_xml, device=pipeline.device) if opt.mujoco_xml else None
    # the body of each of the 22 SMPL joints (JAX indexes with the inverse
    # permutation, argsort(MUJOCO2SMPL_JOINT_IDX), which picks other bodies)
    smpl_order = geometry.MUJOCO2SMPL_JOINT_IDX[:fk_mod.NUM_JOINTS]
    for seq_name, rec, gt_rec in eligible:
        # ---- stage 1 ----
        if opt.use_gt_head_pose:
            head_pose = np.asarray(gt_rec["head_pose"], np.float32)
        else:
            head_pose = pipeline.stage1_head_pose(rec)["head_pose"].cpu().numpy()
        head_pose = head_pose[:gt_rec["head_pose"].shape[0]]
        s1 = stage1_metrics(head_pose, gt_rec["head_pose"])
        print(f"{seq_name}: stage1 E={s1[0]:.4f} O={s1[1]:.4f} T={s1[2]:.1f}mm")

        # ---- GT body: qpos codec + FK (or the XML's skeleton), snapped to the floor ----
        qpos = pipeline._as_tensor(gt_rec["qpos"])
        if skeleton is not None:
            mj_quat, mj_pos = qpos_fk(skeleton, qpos)
            gt_jrot, gt_jpos = mj_quat[:, smpl_order], mj_pos[:, smpl_order]
        else:
            gt_trans, gt_aa24 = geometry.qpos_to_smpl(qpos)
            gt_jrot, gt_jpos = fk_mod.fk_smpl(gt_trans, gt_aa24[:, :22], pipeline.rest_offsets)
        floor, _, _ = geometry.determine_floor_height_and_contacts(gt_jpos.cpu().numpy(), 30)
        gt_jpos = gt_jpos.clone()
        gt_jpos[:, :, 2] -= float(np.float32(floor))

        # align the predicted head pose to the floor-snapped GT start
        gt_head = gt_jpos[:, HEAD_IDX].cpu().numpy()
        head_pose = head_pose.copy()
        head_pose[:, :3] += gt_head[0] - head_pose[0, :3]
        if opt.use_gt_head_pose:
            head_pose = np.concatenate([gt_head, gt_jrot[:, HEAD_IDX].cpu().numpy()], -1)

        # ---- stage 2 + metrics ----
        md, best = evaluate_sequence(pipeline, head_pose, gt_jrot, gt_jpos, noise, sample_bs=opt.sample_bs)
        if opt.save_html_vis and (pipeline.mesh is None or pipeline.mesh.rank == 0):
            os.makedirs(opt.out_dir, exist_ok=True)
            t_vis = best["pred_jpos"].shape[0]
            origin_xy = gt_head[0:1] * [1.0, 1.0, 0.0]
            vis_skeleton_motion_html(best["pred_jpos"], os.path.join(opt.out_dir, seq_name + ".html"),
                                     gt_jpos=gt_jpos.cpu().numpy()[:t_vis] - origin_xy[:, None, :],
                                     head_traj=head_pose[:t_vis, :3] - origin_xy, title=seq_name)
        yield seq_name, md, s1


def result_path(opt) -> str:
    tag = "ares" if opt.test_on_ares else ("gimo" if opt.test_on_gimo else "kinpoly")
    return os.path.join(opt.out_dir, f"egoego_pipeline_res_on_{tag}.json")


def _run_rank(mesh, opt):
    run(opt, mesh=mesh)


def run(opt, mesh=None, devices=None) -> dict:
    """Evaluate and write the JSON summary; returns it. --dp/--tp above 1
    with no ``mesh``: as ``eval_stage2.run``."""
    if opt.dp * opt.tp > 1 and mesh is None:
        spawn(_run_rank, (opt,), opt.dp, opt.tp, devices or opt.device)
        with open(result_path(opt)) as f:
            return json.load(f)
    if opt.batch_seqs <= 1 and (opt.of_bf16 or opt.of_int8):
        warnings.warn("--of_bf16/--of_int8 apply to the batched stage 1 only (--batch_seqs > 1); "
                      "the per-sequence path uploads f32", stacklevel=2)
    pipeline = build_pipeline(
        stats_path=opt.stats_path, smplh_path=opt.smplh_path, rest_offsets_path=opt.rest_offsets,
        diffusion_ckpt=opt.diffusion_ckpt, headnet_ckpt=opt.headnet_ckpt,
        gravitynet_ckpt=opt.gravitynet_ckpt, window=opt.window, headnet_window=opt.headnet_window,
        timesteps=opt.timesteps, compute_dtype=compute_dtype(opt),
        fused_transformer=opt.fused and not opt.fused_step, sample_microbatch=opt.sample_microbatch,
        of_bf16=opt.of_bf16, of_int8=opt.of_int8, seed=opt.seed, device=opt.device if mesh is None else mesh.device)
    if mesh is not None:
        pipeline.shard(mesh)
    ds = select_dataset(opt)
    full_body_gt = load_motion_dict(opt.full_body_gt_path)
    bad_seqs: set = set()
    if opt.bad_seq_path and os.path.exists(opt.bad_seq_path):
        bad_seqs = set(load_pickle(opt.bad_seq_path)["bad_seq"])
    noise = TorchNoise(pipeline.device, seed=opt.seed)

    eligible = []
    for i in range(len(ds)):
        rec = ds[i]
        seq_name = rec["seq_name"]
        if not keep_sequence(opt, seq_name, bad_seqs):
            continue
        gt_key = seq_name + ".npz" if opt.test_on_ares else seq_name
        if gt_key not in full_body_gt:
            continue
        eligible.append((seq_name, rec, full_body_gt[gt_key]))
        if opt.max_seqs and len(eligible) >= opt.max_seqs:
            break

    agg: dict[str, list] = {}
    per_seq = {}
    batched = opt.batch_seqs > 1
    if batched and (opt.mujoco_xml or opt.save_html_vis):
        print("WARNING: --batch_seqs is incompatible with --mujoco_xml/--save_html_vis; falling back to the "
              "per-sequence path")
        batched = False
    evaluate = run_batched if batched else run_per_sequence
    for seq_name, md, (s1_e, s1_o, s1_t) in evaluate(opt, pipeline, eligible, noise):
        entry = {k: float(np.mean(v)) for k, v in md.items() if k != "single_jpe"}
        entry.update({"s1_e_head": s1_e, "s1_o_head": s1_o, "s1_t_head": s1_t})
        per_seq[seq_name] = entry
        for k, v in entry.items():
            agg.setdefault(k, []).append(v)
        print(f"  {seq_name}: mpjpe={entry['mpjpe']:.2f}mm head_dist={entry['head_dist']:.4f}")

    summary = {k: float(np.mean(v)) for k, v in agg.items()}
    result = {"mean": summary, "per_seq": per_seq, "num_seqs": len(per_seq)}
    if mesh is None or mesh.rank == 0:
        os.makedirs(opt.out_dir, exist_ok=True)
        with open(result_path(opt), "w") as f:
            json.dump(result, f, indent=2)
    print("mean:", json.dumps(summary, indent=2))
    return result


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_folder", required=True)
    p.add_argument("--full_body_gt_path", required=True,
                   help="kinpoly-format mocap_annotations.p with qpos experts")
    p.add_argument("--bad_seq_path", default=None)
    p.add_argument("--stats_path", required=True)
    p.add_argument("--diffusion_ckpt", default=None)
    p.add_argument("--headnet_ckpt", default=None)
    p.add_argument("--gravitynet_ckpt", default=None)
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--window", type=int, default=120)
    p.add_argument("--headnet_window", type=int, default=60,
                   help="HeadNet block length; 256 or more routes its attention to the fused kernel")
    p.add_argument("--timesteps", type=int, default=1000,
                   help="DDPM steps (1000 = reference; lower for smoke runs)")
    p.add_argument("--sample_bs", type=int, default=1)
    p.add_argument("--batch_seqs", type=int, default=1,
                   help="bucket same-length sequences and run N per pipelined diffusion chain (composes with "
                        "--sample_bs)")
    p.add_argument("--fused", action="store_true",
                   help="the denoiser layers through fused_decoder_layer in bf16 (default: the step kernels "
                        "in f32, the JAX CLI's numerics)")
    p.add_argument("--fused_step", action="store_true",
                   help="the step kernels in bf16 (bf16-level drift; default: f32); wins over --fused")
    p.add_argument("--sample_microbatch", type=int, default=0,
                   help="run the reverse chain in sequential chunks of N rows (0 = off)")
    p.add_argument("--of_bf16", action="store_true",
                   help="batched stage 1: upload the OF features in bf16, cast back to f32 on the device")
    p.add_argument("--of_int8", action="store_true",
                   help="batched stage 1: upload the OF features in int8 with per-frame absmax scales, "
                        "dequantized on the device (coarser than bf16 for small features)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ranks: each batch's chains split over them")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks: the denoiser's layers split over them")
    p.add_argument("--max_seqs", type=int, default=0)
    p.add_argument("--test_on_ares", action="store_true")
    p.add_argument("--test_on_gimo", action="store_true")
    p.add_argument("--use_gt_head_pose", action="store_true")
    p.add_argument("--save_html_vis", action="store_true",
                   help="write an interactive HTML pred-vs-GT skeleton animation per sequence")
    p.add_argument("--mujoco_xml", default=None, help="humanoid XML for exact kinpoly-skeleton GT decoding")
    p.add_argument("--out_dir", default="./results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the batched eval (run_batches_pipelined) there "
                        "(trace.json) and the program's spans by name (spans.json, utils/trace.py)")
    return p.parse_args(argv)


def main(argv=None):
    run(parse_opt(argv))


if __name__ == "__main__":
    main()
