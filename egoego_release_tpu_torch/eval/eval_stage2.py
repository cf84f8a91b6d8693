"""Stage-2 diffusion eval on the AMASS test split, on the card.

Port of egoego_release_tpu/eval/eval_stage2.py with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions of
the kernels). For each test sequence (Transitions_mocap + HumanEva, first
``window`` frames) it runs FK on the GT, snaps it to the floor, conditions
the diffusion model on the GT head pose, samples, and scores; it writes a
JSON summary. As in JAX, it computes in f32 unless ``--fused_step`` (the
bf16 step kernels) or ``--fused`` (the bf16 fused_decoder_layer denoiser)
is given. ``--dp N --tp M`` starts N x M ranks (one process each, rank r
on ``cuda:r``, or all on the CPU with ``--device cpu``): the denoiser's
layers split over tp, each batch's chains over dp (``EgoEgoPipeline.shard``);
rank 0 prints and writes the results.

    python -m egoego_release_tpu_torch.eval.eval_stage2 \\
        --test_data_path <test_amass_smplh_motion.p> --stats_path <stats.p> \\
        --checkpoint stage2_diffusion_4.pt --smplh_path smpl_models/smplh_amass
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from egoego_release_tpu_torch.data.formats import load_motion_dict
from egoego_release_tpu_torch.eval.build import build_pipeline
from egoego_release_tpu_torch.eval.pipeline import (
    evaluate_sequence,
    gt_from_smpl_params,
    run_batches_pipelined,
)
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.parallel.mesh import spawn
from egoego_release_tpu_torch.utils.logging import profile_trace

TEST_SUBSETS = ("Transitions_mocap", "HumanEva")


def result_path(opt) -> str:
    return os.path.join(opt.out_dir, "stage2_diffusion_model_res_on_amass_test.json")


def _run_rank(mesh, opt):
    run(opt, mesh=mesh)


def compute_dtype(opt) -> str:
    """The step kernels' compute type that the flags select: bf16 under
    --fused_step or --fused, else f32 (the JAX CLIs' flax default)."""
    return "bfloat16" if opt.fused or opt.fused_step else "float32"


def run(opt, mesh=None, devices=None) -> dict:
    """Evaluate and write the JSON summary; returns it. With --dp/--tp above
    1 and no ``mesh``, runs itself on dp x tp new ranks (rank r on
    ``devices[r]``; by default on --device: ``parallel.mesh.spawn``) and
    returns what rank 0 wrote."""
    if opt.dp * opt.tp > 1 and mesh is None:
        spawn(_run_rank, (opt,), opt.dp, opt.tp, devices or opt.device)
        with open(result_path(opt)) as f:
            return json.load(f)
    # The JAX CLI's numerics: f32 without flags; --fused_step the bf16 step
    # kernels, --fused the bf16 fused_decoder_layer denoiser, and
    # --fused_step wins over --fused.
    pipeline = build_pipeline(
        stats_path=opt.stats_path, smplh_path=opt.smplh_path,
        rest_offsets_path=opt.rest_offsets, diffusion_ckpt=opt.checkpoint,
        window=opt.window, sampler="ddim" if opt.ddim_steps else "ddpm",
        ddim_steps=opt.ddim_steps or 50, timesteps=opt.timesteps, seed=opt.seed,
        compute_dtype=compute_dtype(opt), fused_transformer=opt.fused and not opt.fused_step,
        sample_microbatch=opt.sample_microbatch, device=opt.device if mesh is None else mesh.device)
    if mesh is not None:
        pipeline.shard(mesh)
    data = load_motion_dict(opt.test_data_path)
    noise = TorchNoise(pipeline.device, seed=opt.seed)

    eligible = []
    for idx in data:
        rec = data[idx]
        seq_name = rec.get("seq_name", str(idx))
        if opt.filter_subsets and not any(s in seq_name for s in TEST_SUBSETS):
            continue
        if rec["trans"].shape[0] < opt.window:
            continue
        eligible.append((seq_name, rec))
        if opt.max_seqs and len(eligible) >= opt.max_seqs:
            break

    agg: dict[str, list] = {}
    per_seq = {}

    def record_result(seq_name, md):
        per_seq[seq_name] = {k: float(np.mean(v)) for k, v in md.items() if k != "single_jpe"}
        for k, v in per_seq[seq_name].items():
            agg.setdefault(k, []).append(v)
        print(f"[{len(per_seq)}] {seq_name}: mpjpe={per_seq[seq_name]['mpjpe']:.2f}mm "
              f"head_dist={per_seq[seq_name]['head_dist']:.4f}")

    t = opt.window
    if opt.batch_seqs <= 1:
        for seq_name, rec in eligible:
            gt_jrot, gt_jpos, gt_head_pose = gt_from_smpl_params(
                pipeline, rec["trans"][:t], rec["root_orient"][:t], rec["body_pose"][:t])
            md, _ = evaluate_sequence(pipeline, gt_head_pose, gt_jrot, gt_jpos, noise,
                                      sample_bs=opt.sample_bs)
            record_result(seq_name, md)
    else:
        # chunks of --batch_seqs through run_batches_pipelined, one noise
        # source per chunk: GT prep and metrics on the device, each chunk's
        # host work overlapping the previous chunk's chain
        chunks = [eligible[s: s + opt.batch_seqs] for s in range(0, len(eligible), opt.batch_seqs)]
        batches = [{f"gt_{key}": np.stack([rec[key][:t] for _, rec in chunk])
                    for key in ("trans", "root_orient", "body_pose")} for chunk in chunks]
        t0 = time.perf_counter()
        with profile_trace(opt.profile_dir):
            res = run_batches_pipelined(pipeline, batches, noise, sample_bs=opt.sample_bs)
        dt = time.perf_counter() - t0
        for chunk, b in zip(chunks, res):
            for (seq_name, _), md in zip(chunk, b["metrics"]):
                record_result(seq_name, md)
        if eligible:
            print(f"batched eval: {len(eligible)} seqs in {dt:.1f}s "
                  f"({len(eligible) / dt:.2f} seqs/sec on {pipeline.device})")

    summary = {k: float(np.mean(v)) for k, v in agg.items()}
    result = {"mean": summary, "per_seq": per_seq, "num_seqs": len(per_seq)}
    if mesh is None or mesh.rank == 0:
        os.makedirs(opt.out_dir, exist_ok=True)
        with open(result_path(opt), "w") as f:
            json.dump(result, f, indent=2)
    print("mean:", json.dumps(summary, indent=2))
    print("saved:", result_path(opt))
    return result


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--test_data_path", required=True,
                   help="AMASS test motion pickle (test_amass_smplh_motion.p)")
    p.add_argument("--stats_path", required=True,
                   help="min/max stats pickle (cano_min_max_mean_std_data_window_120.p)")
    p.add_argument("--checkpoint", default=None, help="stage2 torch .pt checkpoint")
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--window", type=int, default=120)
    p.add_argument("--timesteps", type=int, default=1000,
                   help="DDPM steps (1000 = reference; lower for smoke runs)")
    p.add_argument("--sample_bs", type=int, default=1)
    p.add_argument("--batch_seqs", type=int, default=16, help="sequences per diffusion batch")
    p.add_argument("--ddim_steps", type=int, default=0,
                   help="use the fast DDIM sampler with N steps (0 = parity DDPM-1000)")
    p.add_argument("--fused", action="store_true",
                   help="the denoiser layers through fused_decoder_layer in bf16 (default: the step kernels "
                        "in f32, the JAX CLI's numerics)")
    p.add_argument("--fused_step", action="store_true",
                   help="the step kernels in bf16 (bf16-level drift; default: f32); wins over --fused")
    p.add_argument("--sample_microbatch", type=int, default=0,
                   help="run the reverse chain in sequential chunks of N rows (0 = off)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ranks: each batch's chains split over them")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks: the denoiser's layers split over them")
    p.add_argument("--max_seqs", type=int, default=0)
    p.add_argument("--filter_subsets", action="store_true", default=True)
    p.add_argument("--no_filter_subsets", dest="filter_subsets", action="store_false")
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
