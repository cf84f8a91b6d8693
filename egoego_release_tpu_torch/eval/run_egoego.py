"""Demo pipeline on the bundled ARES fixture, on the card.

Port of egoego_release_tpu/eval/run_egoego.py with ``--device`` (default
``cuda``; ``--device cpu`` runs the plain versions of the kernels): load
the demo sequence, run stage 1 (HeadNet + GravityNet), condition the
stage-2 diffusion on the predicted head pose, FK-decode, snap to the floor
and write the per-frame predictions as an npz per sequence; with
``--export_objs`` (and ``--smplh_path``) the SMPL-H meshes of each frame
(LBS on the device) as .obj files, with ``--save_html_vis`` a standalone
HTML skeleton animation per sequence. Stage 2 runs the step kernels in f32,
as the JAX CLI runs the flax denoiser in f32 (neither has a flag for bf16).

    python -m egoego_release_tpu_torch.eval.run_egoego \\
        --data_root_folder test_data/ares \\
        --stats_path test_data/ares/cano_min_max_mean_std_data_window_120.p \\
        --rest_offsets rest.npy --out_dir demo_out
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from egoego_release_tpu_torch.data.headpose import ARESDemoDataset
from egoego_release_tpu_torch.eval.build import build_pipeline
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.utils.logging import profile_trace
from egoego_release_tpu_torch.vis.html_viewer import vis_skeleton_motion_html
from egoego_release_tpu_torch.vis.mesh_export import export_obj_sequence


def run(opt) -> list[str]:
    """Returns the paths of the npz files written."""
    pipeline = build_pipeline(
        stats_path=opt.stats_path, smplh_path=opt.smplh_path, rest_offsets_path=opt.rest_offsets,
        diffusion_ckpt=opt.diffusion_ckpt, headnet_ckpt=opt.headnet_ckpt,
        gravitynet_ckpt=opt.gravitynet_ckpt, window=opt.window, timesteps=opt.timesteps,
        seed=opt.seed, device=opt.device)
    ds = ARESDemoDataset(opt.data_root_folder)
    os.makedirs(opt.out_dir, exist_ok=True)
    noise = TorchNoise(pipeline.device, seed=opt.seed)
    written = []
    for i in range(len(ds)):
        rec = ds[i]
        print("sequence:", rec["seq_name"])
        s1 = pipeline.stage1_head_pose(rec)
        head_pose = s1["head_pose"].cpu().numpy()
        head_pose[:, 2] += opt.demo_floor_offset  # the demo floor offset of the bundled sequence

        with profile_trace(opt.profile_dir and os.path.join(opt.profile_dir, rec["seq_name"])):
            local_aa, root_pos = pipeline.stage2_generate(head_pose, noise, sample_bs=1)
        _, pred_jpos = pipeline.fk(root_pos, local_aa)
        pred_jpos = pred_jpos[0].cpu().numpy()
        floor, _, _ = geometry.determine_floor_height_and_contacts(pred_jpos, fps=30)
        root_out = root_pos[0].cpu().numpy()
        root_out[:, 2] -= floor

        out_path = os.path.join(opt.out_dir, rec["seq_name"] + ".npz")
        np.savez(out_path, local_aa=local_aa[0].cpu().numpy(), root_pos=root_out, head_pose=head_pose,
                 pred_scale=float(s1["pred_scale"]), pred_jpos=pred_jpos)
        print("saved:", out_path)
        written.append(out_path)

        if opt.export_objs and opt.smplh_path:
            export_obj_sequence(opt.smplh_path, local_aa[0].cpu().numpy(), root_out,
                                os.path.join(opt.out_dir, rec["seq_name"] + "_objs"), device=pipeline.device)
        if opt.save_html_vis:
            pred_snapped = pred_jpos.copy()
            pred_snapped[:, :, 2] -= floor
            html_path = vis_skeleton_motion_html(pred_snapped, os.path.join(opt.out_dir, rec["seq_name"] + ".html"),
                                                 head_traj=head_pose[:, :3], title=rec["seq_name"])
            print("saved:", html_path)
    return written


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_folder", required=True)
    p.add_argument("--stats_path", required=True)
    p.add_argument("--diffusion_ckpt", default=None)
    p.add_argument("--headnet_ckpt", default=None)
    p.add_argument("--gravitynet_ckpt", default=None)
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--window", type=int, default=120)
    p.add_argument("--timesteps", type=int, default=1000, help="DDPM steps (reduce only for smoke tests)")
    p.add_argument("--demo_floor_offset", type=float, default=-0.13)
    p.add_argument("--export_objs", action="store_true",
                   help="with --smplh_path: write the SMPL-H mesh of every frame as .obj under <seq>_objs/")
    p.add_argument("--save_html_vis", action="store_true",
                   help="write a standalone interactive HTML skeleton animation per sequence (vis/html_viewer.py)")
    p.add_argument("--out_dir", default="./demo_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of each sequence's stage-2 chain (<profile_dir>/<sequence>/"
                        "trace.json) and the program's spans by name (spans.json, utils/trace.py)")
    return p.parse_args(argv)


def main(argv=None):
    run(parse_opt(argv))


if __name__ == "__main__":
    main()
