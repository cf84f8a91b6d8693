"""Ahead-of-time export of the inference programs as ``torch.export``
artifacts (port of egoego_release_tpu/serving/export.py).

``torch.export`` records the program, with the weights, the normalization
stats and the rest offsets baked in as constants, so a serving host loads
one ``.pt2`` file and calls it without the model code, a checkpoint or a
re-trace. Every hand-written kernel stays a node of the program: the C
entries are custom ops (``torch.ops.egoego.*``, registered by
``ops.cuda_kernels``, which a loader imports), whose CUDA implementation
launches the kernel and whose CPU implementation is its plain version. The
reverse loop of each window is one ``while_loop`` node around one step, so
the program's size does not grow with the step count.

Randomness: a JAX artifact takes a threefry key. A ``torch.export``
program cannot take a ``torch.Generator``, so the chain draws with
``torch.randn`` from the default generator of its device, and
``call_artifact(prog, seed, *inputs)`` seeds it first; the live chain on
``ops.fused_step.DefaultNoise`` draws the same numbers for one seed.

Shapes are static: one artifact per (batch_size, n_frames), on the device
it was exported for (``--device``).

    python -m egoego_release_tpu_torch.serving.export chain --stats_path <stats.p> \\
        --rest_offsets <rest.npy> --batch_size 64 --n_frames 140 --out chain_b64_t140.pt2
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from egoego_release_tpu_torch.ops import cuda_kernels as ck  # noqa: F401 (registers torch.ops.egoego)
from egoego_release_tpu_torch.ops.fused_step import DefaultNoise
from egoego_release_tpu_torch.parallel.mesh import Mesh, sharded_rows


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


def _export(fn, *shapes, device):
    """torch.export of ``fn`` on zero inputs of ``shapes`` (f32) on ``device``."""
    inputs = tuple(torch.zeros(s, device=device) for s in shapes)
    with torch.no_grad():
        return torch.export.export(_Program(fn), inputs)


def _chain_fn(pipeline, noise):
    noise = DefaultNoise(pipeline.device) if noise is None else noise
    return lambda jpos, jquat: pipeline.diffusion.sample_sliding_window_w_canonical(
        jpos, jquat, pipeline.stats, pipeline.rest_offsets, noise=noise)


def export_chain(pipeline, batch_size: int, n_frames: int, noise=None):
    """The canonical sliding-window chain
    (``CondGaussianDiffusion.sample_sliding_window_w_canonical``) as one
    program: (head_jpos f32[B, T, 3], head_jquat f32[B, T, 4]) ->
    (local_aa f32[B, T', 22, 3], root_pos f32[B, T', 3]). ``noise``: the
    default generator (None), or a source with ``step_at`` whose draws are
    baked in as constants (a test replaying another framework's draws)."""
    return _export(_chain_fn(pipeline, noise), (batch_size, n_frames, 3), (batch_size, n_frames, 4),
                   device=pipeline.device)


def export_chain_sharded(pipeline, batch_size: int, n_frames: int, mesh: Mesh):
    """The dp-replicated serving artifact (the counterpart of JAX's
    dp-sharded export): the one-device chain at batch_size / dp, which
    every rank of ``mesh`` loads and ``call_sharded`` fans a batch over."""
    if batch_size % mesh.dp:
        raise ValueError(f"batch {batch_size} is not divisible by dp={mesh.dp}")
    return export_chain(pipeline, batch_size // mesh.dp, n_frames)


def call_sharded(prog, mesh: Mesh, seed: int, head_jpos: torch.Tensor, head_jquat: torch.Tensor):
    """Every rank runs the artifact of ``export_chain_sharded`` on its rows
    of the batch (padded to a multiple of dp), seeded with seed + its dp
    coordinate; the outputs are gathered over the dp group on every rank."""
    def run(jpos, jquat, noise):
        return call_artifact(prog, seed + mesh.dp_rank, jpos, jquat)
    return sharded_rows(run, mesh, None, head_jpos, head_jquat)


def export_stage1(pipeline, batch_size: int, n_frames: int, of_dim: int = 512):
    """Batched stage 1 (HeadNet blockwise eval, va2rot, the SLAM rescale,
    GravityNet and its floor-normal transform; ``EgoEgoPipeline._stage1``):
    (of [B, T-1, of_dim], init_quat [B, 4], aligned_slam_trans [B, T, 3],
    ori_trans [B, T, 3], ori_mat [B, T, 3, 3], gt_head_pose [B, T, 7]) ->
    (head_pose [B, T, 7], pred_scale [B], pred_normal [B, 3]), all f32."""
    def fn(*inputs):
        out = pipeline._stage1(*inputs)
        return out["head_pose"], out["pred_scale"], out["pred_normal"]
    b, t = batch_size, n_frames
    return _export(fn, (b, t - 1, of_dim), (b, 4), (b, t, 3), (b, t, 3), (b, t, 3, 3), (b, t, 7),
                   device=pipeline.device)


def export_fk(pipeline, batch_size: int, n_frames: int):
    """SMPL FK (root_pos [B, T, 3], local_aa [B, T, 22, 3]) -> (jrot
    [B, T, 22, 4], jpos [B, T, 22, 3]), the rest offsets baked in."""
    return _export(pipeline.fk, (batch_size, n_frames, 3), (batch_size, n_frames, 22, 3), device=pipeline.device)


def export_e2e(pipeline, batch_size: int, n_frames: int, of_dim: int = 512, floor_offset: float = 0.0,
               noise=None):
    """The whole system as one program: stage 1, the head pose shifted by
    the fixed ``floor_offset`` in z, the chain, FK. Takes stage 1's inputs
    (``export_stage1``, the last one the reference head pose) and returns
    (local_aa, root_pos, pred_jrot, pred_jpos, head_pose, pred_scale).
    ``noise`` as in ``export_chain``."""
    chain = _chain_fn(pipeline, noise)

    def fn(*inputs):
        s1 = pipeline._stage1(*inputs)
        hp = s1["head_pose"]
        hp = torch.cat([hp[..., :2], hp[..., 2:3] + floor_offset, hp[..., 3:]], -1)
        local_aa, root_pos = chain(hp[..., :3].contiguous(), hp[..., 3:].contiguous())
        pred_jrot, pred_jpos = pipeline.fk(root_pos, local_aa)
        return local_aa, root_pos, pred_jrot, pred_jpos, hp, s1["pred_scale"]
    b, t = batch_size, n_frames
    return _export(fn, (b, t - 1, of_dim), (b, 4), (b, t, 3), (b, t, 3), (b, t, 3, 3), (b, t, 7),
                   device=pipeline.device)


def save_artifact(prog, path: str) -> None:
    torch.export.save(prog, path)


def load_artifact(path: str):
    """The saved ``ExportedProgram``; call it with ``call_artifact`` (or
    ``.module()(*inputs)`` for the programs that draw nothing)."""
    return torch.export.load(path)


def call_artifact(prog, seed: int | None, *inputs):
    """Run a program: the default generators seeded with ``seed`` first
    (``torch.manual_seed``: the CPU's and every card's), unless it is None."""
    if seed is not None:
        torch.manual_seed(seed)
    with torch.no_grad():
        return prog.module()(*inputs)


def main(argv=None):
    from egoego_release_tpu_torch.eval.build import build_pipeline

    p = argparse.ArgumentParser(description="Export a serving artifact (.pt2) of the PyTorch port.")
    p.add_argument("which", choices=["chain", "stage1", "fk", "e2e"])
    p.add_argument("--stats_path", required=True)
    p.add_argument("--rest_offsets", required=True)
    p.add_argument("--diffusion_ckpt", default=None)
    p.add_argument("--headnet_ckpt", default=None)
    p.add_argument("--gravitynet_ckpt", default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--n_frames", type=int, default=140)
    p.add_argument("--window", type=int, default=120)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--ddim_steps", type=int, default=0)
    p.add_argument("--floor_offset", type=float, default=0.0, help="e2e only: fixed floor shift in z")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the device the program runs on")
    args = p.parse_args(argv)

    pipeline = build_pipeline(
        stats_path=args.stats_path, rest_offsets_path=args.rest_offsets, diffusion_ckpt=args.diffusion_ckpt,
        headnet_ckpt=args.headnet_ckpt, gravitynet_ckpt=args.gravitynet_ckpt, window=args.window,
        timesteps=args.timesteps, sampler="ddim" if args.ddim_steps else "ddpm", ddim_steps=args.ddim_steps or 50,
        device=args.device)
    b, t = args.batch_size, args.n_frames
    t0 = time.perf_counter()
    if args.which == "chain":
        prog = export_chain(pipeline, b, t)
    elif args.which == "stage1":
        prog = export_stage1(pipeline, b, t)
    elif args.which == "e2e":
        prog = export_e2e(pipeline, b, t, floor_offset=args.floor_offset)
    else:
        prog = export_fk(pipeline, b, t)
    t_export = time.perf_counter() - t0
    save_artifact(prog, args.out)
    print(f"exported {args.which} (b={b}, t={t}, device={pipeline.device}) in {t_export:.1f} s -> {args.out} "
          f"({os.path.getsize(args.out)} bytes)")
    return prog


if __name__ == "__main__":
    main()
