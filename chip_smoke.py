#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit; build the CUDA kernels from csrc/;
     their registers and spills, the mha kernel's HMMA count and the HGMMA
     count of each instantiation of the wgmma GEMM, of the 3xTF32 GEMM (TF32
     HGMMA alone: the f32 route) and of the wgmma attention (cuobjdump).
  2. kernels: each of the three denoise-step wrappers (stem_layer,
     decoder_layer, layer_epilogue) on card tensors against its plain
     PyTorch version on the same inputs, at the main path's shapes (64
     windows of 121 tokens, and the 31-token tail window) in f32 and bf16
     mode; each call must add one to its wrapper's count and launch the
     expected C entries. layer_epilogue is checked on x0 alone (a1 = 1, no
     inpaint) and on the update with the inpaint, which in bf16 also writes
     bf16(x_next) into the stem's packed A (xa). Timed beside the plain
     version and a PyTorch library yardstick; then each launch of a step
     alone (device time beside cuBLAS and the bound), the stem's and the
     update's GEMM and the attention also checked against their plain
     versions; the layer's attention (attention_wgmma) at 64 x 121, 64 x 31
     and 1 x 121 tokens beside the WMMA kernel it replaced there, SDPA bf16
     and the bound. The f32 mode (the CLIs' default numerics): each
     wrapper's device ms beside its library calls in f32 and both bounds
     (3xTF32 and the f32 CUDA cores), the f32 step's device ms and profile,
     and each f32 launch of a step at 64 x 121 and 64 x 31 (gemm_tf32x3,
     the attention on mha) beside the CUDA-core kernel it replaced at the
     same layout, torch.matmul f32 or SDPA f32, both bounds, and its error
     against its plain version; at 64 x 121 each GEMM launch must beat the
     CUDA-core kernel.
  3. main path A: ``eval_stage2.run --fused_step`` on synthetic AMASS-layout
     records (64 sequences x 120 frames, one batch of
     run_batches_pipelined), full release width, random weights from a seed, DDPM-1000 in
     bf16.
  4. main path B: ``stage2_generate_batched`` on 64 head trajectories of
     140 frames (a 120-frame window plus a ragged 30-frame window with the
     overlap inpaint), DDPM-1000, then one DDIM-50 pass; each kernel's
     launch count, and each C entry's, must equal windows x steps x its
     launches per step.
  5. f32: ``eval_stage2.run`` with no flag (the JAX CLI's f32 numerics),
     DDIM-50 on 4 sequences, timed: exact launch counts, gemm_tf32x3 and mha
     alone; then
     chain parity: the f32 kernels on the card against the plain versions
     on the CPU, same weights and noise, DDIM-50 on a small batch.
  6. kernels of the --fused and stage-1 routes: fused_attention (csrc/mha.cu,
     f32 in and out, 3xTF32 tensor cores) at the HeadNet's shapes (blocks x
     4 heads x T >= 256 x 256) and fused_decoder_layer (the layer chain of
     gemm.cu + attention.cu) at 64 windows of 121 and 31 tokens in f32 and
     bf16, each on card tensors against its plain version, counted once per
     call; timed beside the plain version, a PyTorch library yardstick and
     the bound. fused_attention and its yardstick (SDPA f32) are also timed
     on the device alone (torch.profiler), with the host cost per call, both
     bounds (3xTF32 and f32 CUDA cores) and max|SDPA - plain|; beside them
     the card's own mma.sync TF32 rate (a probe kernel built here).
  7. main path C: ``eval_stage2.run --fused`` (64 x 120 frames, DDPM-1000):
     exactly 4 x 1000 fused_decoder_layer launches and no step kernel.
  8. main path D: ``eval_egoego.run --headnet_window 256 --fused_step`` on 4 synthetic
     kinpoly-layout sequences of 300 frames (written here), full width,
     DDPM-1000: exactly 2 (HeadNet layers) x 4 fused_attention launches;
     then stage 1 alone per sequence, timed, at window 256 and at the
     release window 60 (no fused_attention launch).
  9. stage-1 parity: stage1_head_pose at window 256 on the card (the mha
     kernel) against the CPU (its plain version), same weights.
 10. main path E: ``eval_egoego.run --batch_seqs 4 --headnet_window 256
     --fused_step`` on 16 kinpoly-layout sequences (8 of 300 frames, 8 of
     240: two length buckets, four batches of 3 stage-2 windows) through
     ``run_batches_pipelined``, DDPM-1000: exact launch counts (one
     fused_attention call per HeadNet layer per batch); its s/seq beside
     phase 8's at batch 1; before it, each wrapper of the path at the
     path's own shapes against its plain version (fused_attention on the
     batched HeadNet's q, k, v: 8 and 4 blocks of 256, padded; the step
     wrappers at 4 windows of 120, 80 and 20 frames, f32 and bf16), counted
     once per call; the same path at DDPM-50 under the profiler for
     the card's idle time between consecutive chains; then on the card, in
     f32 with DDIM-50, run_batches_pipelined against the sequential
     composition (2 batches of 2), the batched stage 1 against the
     per-record one, and the bf16 and int8 OF uploads against f32.
 11. stage-2 training at the release widths (f32, micro-batch 32 x
     grad-accum 2) on a synthetic AMASS-layout pickle written here (65
     smooth sequences, ~500 windows, some padded): ``train_diffusion.run``
     for 300 steps on the device-resident bank (finite losses, nan_count
     0, the mean loss of the last 50 steps below the first 50's, the
     checkpoints), resumed for 20 more, 50 steps on the iterator +
     prefetch path; the step's ms (CUDA events), window-grads/s, busy
     share, host ms of both data paths, peak memory with remat off and on
     and the f32 bound; one step on the card against the CPU (the card's
     ReLU and l1 branches replayed on the CPU and in a float64
     reference: train_step_agreement, STEP_BOUNDS); then
     ``train_diffusion --sample`` (DDPM-1000, f32 step kernels) and
     ``eval_stage2 --checkpoint`` (DDIM-50) on the trained ``.pt``, with
     exact launch counts.
 12. the step kernels with bf16 inter-layer activations (``act_bf16``,
     ``DiffusionConfig.fused_step_act_bf16``): each wrapper against its
     plain version at 64 windows of 121 and 31 tokens in bf16 and f32
     compute, counted once per call; the LayerNorm launches with a bf16
     residual and a bf16 output alone, bit for bit against their f32 forms
     on equal inputs, and their device ms; each wrapper's and the step's
     device ms (and the step's wall ms and busy share) with and without the
     flag; the two-window DDPM-1000 chain with and without it, exact launch
     counts, each reverse chain within JAX's 0.08 of the other on the same
     inputs.
 13. stage-1 training at the release widths (f32, batch 32) on fixtures
     written here (ARES-layout records with per-frame OF feature npys, a
     pickle of smooth head tracks): ``train_stage1 headnet`` and
     ``train_stage1 gravitynet`` for 200 steps each (a falling mean loss,
     no NaN, a checkpoint per epoch, reloaded; every OF batch read by the
     native loader); each step's ms, busy share, peak memory and f32 bound,
     and va2rot's share of the HeadNet step; one step of each, card against
     CPU (train_step_agreement); then ``eval_egoego --headnet_ckpt
     --gravitynet_ckpt --headnet_window 256 --fused_step`` on the trained
     checkpoints with exact launch counts.
 14. the parallel-window sampler and the output flags, release widths:
     ``sample_sliding_window_parallel`` on 16 head trajectories of 470
     frames (64 stacked windows of 121 tokens, then a 16 x 31-token tail),
     DDPM-1000 bf16, exact launch counts (2 x 1000 steps), beside the
     chained sampler on the same input (5 x 1000 steps), both timed; then
     f32 DDIM-50 on 2 x 250 frames, card kernels against the CPU's plain
     versions within 1e-3. ``eval_egoego --mujoco_xml --save_html_vis
     --headnet_window 256 --fused_step`` on phase 8's sequences with a
     humanoid XML written from the rest offsets (exact counts; qpos_fk card
     vs CPU within 1e-5; every HTML file parsed back with its frame count).
     ``run_egoego --export_objs --save_html_vis`` on an ARES demo fixture
     with synthetic SMPL-H models at the real sizes (6890 vertices, 13776
     faces, 52 joints, 16 betas): one .obj per frame, exact f32 counts, LBS
     card vs CPU within 1e-4, the export timed.
 15. multi-GPU and serving on the one card: the tensor-parallel layer's
     own launches at its shapes (the PARTIAL GEMM of fc and w2 in bf16 and
     f32, residual_layernorm with an f32 or bf16 residual; 64 windows of
     121 and 31 tokens, tp 2 and 4) against their plain versions, timed
     beside their bounds and the library calls (the f32 PARTIAL also beside
     the CUDA-core kernel); each custom op through
     torch.ops against its ctypes wrapper, bit for bit; two gloo ranks on
     cuda:0 running ``eval_stage2`` through the library (dp 2
     --fused_step, tp 2 in f32 and with --fused_step; DDIM-50 on 16
     sequences) with each rank's exact launch counts (no LayerNorm
     epilogue under tp) and the chain against the unsharded card run; one
     training step at dp 2 and at tp 2 against the unsharded card step;
     ``serving.export chain`` at the CLI's defaults (64 x 140 frames,
     DDPM-1000) and ``export_e2e``, each saved, loaded and called on the
     card against the live run for one seed, with the kernels launched
     inside the loaded program counted, and timed.
 16. optical flow, the raw-flow HeadNet and GIMO (no kernel of the port's
     runs here; f32 convolutions: the ResNet's on cuDNN, PWC-Net's by
     im2col + cuBLAS, cuDNN's TF32 timed beside them): the ``of_feats`` CLI
     on 256 flows of 360 x 480 (frames/s; its first 64 features card vs CPU
     within 1e-4 of their max; a 64-frame batch's device ms beside its f32
     bound and with cuDNN TF32 on); ``train_stage1 headnet --raw_flow`` at
     the release widths, batch 32 x window 60, 2 epochs of 4 steps on ARES
     records whose flows come from a pool of 64 npys of 256 x 320 (finite
     losses, the frozen CNN bit for bit, the rest moved, a checkpoint per
     epoch reloaded; the step's ms, busy share, peak memory, bound and the
     host's loading and augment_flow; one step at 2 x 60 card vs CPU
     through train_step_agreement; one step at 4 x 60 with the CNN
     trained); ``pwcnet_forward`` on 4 pairs of 448 x 768 and its training
     pyramid card vs CPU within 5e-4 (device ms, the correlation's share,
     cuDNN in f32 and TF32); ``vposer_decode`` of 20,000 latents card vs CPU (1e-5 of each
     joint's vposer_error_scale) and ``gimo_pose.extract_all`` card vs CPU.
Then one JSON line of per-kernel results (with the training and phase-16
summaries), and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12     # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12     # H100 SXM dense TF32 FLOP/s (tensor cores; NVIDIA data sheet)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s
BATCH = 64             # windows per chain: the eval batch of the release runs
SEQS_D, FRAMES_D = 4, 300  # path D: kinpoly-layout sequences and their OF frames
FRAMES_E = (300,) * 8 + (240,) * 8  # path E: two length buckets of 8 sequences
BATCH_E = 4                # path E: --batch_seqs
GAP_TIMESTEPS = 50         # path E again under the profiler, DDPM-50, for the gaps between chains
HEADNET_WINDOW_D = 256     # the HeadNet block from which its attention takes the mha kernel
TOL_F32 = 1e-4         # f32 kernel vs plain: summation order only
TOL_BF16 = 2e-2        # bf16 kernel vs plain: a bf16 rounding may flip where sums differ in order
UPDATE = (0.9, 0.1, 0.05)  # a1, a2, a3 of the epilogue's update check: x0 dominates
WG_EPILOGUES = ("bias", "layer_norm", "stem", "step", "layer_norm res_bf16", "layer_norm bf16_out",
                "layer_norm bf16", "partial")  # csrc/gemm.cu WgEpilogue, in order
ATTN_KEY_TILES = (32, 64, 128)  # csrc/attention.cu attention_wgmma_kernel<NK>
ATTN_SHAPES = ((BATCH, 121), (BATCH, 31), (1, 121))  # (windows, tokens) of the layer's attention timed in phase 2


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, warmup=3, reps=15):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


PROFILER_TRIES = 3
EVENT_TIMED = []  # device_time_ms calls that the profiler left to CUDA events


def device_time_ms(fn, reps=20, chain=False):
    """Device time of one call of fn: the self device time of every kernel
    and memory operation that torch.profiler sees over reps calls, over
    reps; and the names of those kernels with their counts. On a run where
    the profiler sees no device time (CUPTI delivers none now and then), it
    tries again, and after PROFILER_TRIES such runs it times fn with CUDA
    events behind a held stream (held_events_ms)."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in dev)
        if us > 0:
            # the profiler may miss a launch at the start of its window: divide
            # by the count it saw of the function's most frequent kernel, one a
            # call; a chain launches some kernel several times a call, so it
            # divides by reps
            calls = reps if chain else max(e.count for e in dev)
            names = {}
            for e in dev:  # kernels whose names share their first 60 characters count together
                names[e.key[:60]] = names.get(e.key[:60], 0) + e.count
            return us / calls / 1e3, names
    ms = held_events_ms(fn, reps)
    EVENT_TIMED.append(ms)
    log(f"device_time_ms: torch.profiler saw no device time in {PROFILER_TRIES} runs; "
        f"timed with CUDA events behind a held stream: {ms:.4f} ms")
    return ms, {"(CUDA events; the profiler saw no kernel)": reps}


_SLEEP_CYCLES_PER_MS = []


def held_events_ms(fn, reps):
    """Device time of one call of fn by CUDA events: a sleep kernel holds the
    stream while reps calls are queued behind it, so the events around them
    time the card's work without the host's gaps. If the card reached the
    first call before the last was queued, the hold doubles and it runs
    again; it raises if that never holds."""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    if not _SLEEP_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        a, b = events()
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / a.elapsed_time(b))
    hold_ms = 5.0
    for _ in range(6):
        start, end = events()
        torch.cuda._sleep(int(hold_ms * _SLEEP_CYCLES_PER_MS[0]))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        hold_ms *= 2
    raise AssertionError(f"held_events_ms: the card ran ahead of the host even behind a {hold_ms / 2:.0f} ms hold")


# The card's rate for the instruction the mha kernel runs on: warps that
# run nothing but independent mma.sync.m16n8k8 TF32 products.
MMA_PROBE = r"""
#include <cstdint>
__global__ void mma_probe(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x * 2e-3f + i) & 0xffffe000u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                   "{%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_probe_run(float* out, int blocks, int threads, int iters) {
  mma_probe<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_sync_tf32_tflops(nvcc, build_dir):
    """TFLOP/s of mma.sync TF32 on the card: 2 blocks of 8 warps an SM, 8
    independent accumulators a warp, timed by CUDA events."""
    import ctypes
    import torch
    src, lib_path = os.path.join(build_dir, "mma_probe.cu"), os.path.join(build_dir, "libmma_probe.so")
    with open(src, "w") as f:
        f.write(MMA_PROBE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.mma_probe_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    blocks, threads, iters = 2 * torch.cuda.get_device_properties(0).multi_processor_count, 256, 4096
    out = torch.empty(blocks * threads, device="cuda")
    run = lambda: lib.mma_probe_run(out.data_ptr(), blocks, threads, iters)
    if run() != 0:
        raise AssertionError("mma probe: launch failed")
    ms = cuda_time_ms(run, warmup=1, reps=5)
    return blocks * (threads // 32) * iters * 8 * 2 * 16 * 8 * 8 / ms / 1e9


def smooth_quats(rng, n):
    """(n, 4) wxyz unit quaternions of a slowly turning head."""
    aa = np.cumsum(rng.randn(n, 3) * 0.02, 0)
    ang = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(ang, 1e-9)
    return np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis], -1).astype(np.float32)


def write_kinpoly_fixture(root, rng, lengths):
    """The layout the kinpoly-mocap eval reads (RealWorldHeadPoseDataset with
    eval_on_kinpoly_mocap): kinpoly-mocap/mocap_annotations.p, DROID-SLAM
    npys under kinpoly/droid_slam_res/{scene}/{take}.npy, one OF feature npy
    per frame; plus the qpos GT pickle. Plain pickles (no joblib). One
    sequence per entry of ``lengths``, of that many OF frames."""
    feat_dir = os.path.join(root, "feats")
    slam_dir = os.path.join(root, "kinpoly", "droid_slam_res", "subj")
    for d in (feat_dir, slam_dir, os.path.join(root, "kinpoly-mocap")):
        os.makedirs(d, exist_ok=True)
    recs, gt = {}, {}
    for si, frames in enumerate(lengths):
        name = f"subj-take{si + 1}"
        of_files = []
        for i in range(frames):
            f = os.path.join(feat_dir, f"raft_of_feats_{name}_{i}.npy")
            np.save(f, rng.randn(512).astype(np.float32))
            of_files.append(f)
        walk = np.cumsum(rng.uniform(-0.02, 0.02, (frames + 1, 3)), 0)
        head_qpos = np.concatenate([walk + [0, 0, 1.5], smooth_quats(rng, frames + 1)], -1).astype(np.float32)
        recs[si] = {"seq_name": name, "head_qpos": head_qpos, "of_files": of_files,
                    "head_vels": (rng.randn(frames + 1, 6) * 0.01).astype(np.float32)}
        slam = np.concatenate([0.3 * walk + rng.randn(frames + 1, 3) * 1e-3, smooth_quats(rng, frames + 1)], -1)
        np.save(os.path.join(slam_dir, f"take{si + 1}.npy"), slam.astype(np.float32))
        qpos = np.zeros((frames, 76), np.float32)
        qpos[:, :2] = walk[:frames, :2]
        qpos[:, 2] = 0.92
        qpos[:, 3:7] = [0.7071, 0.7071, 0, 0]
        qpos[:, 7:] = rng.uniform(-0.2, 0.2, 69)
        gt[name] = {"qpos": qpos, "head_pose": head_qpos[:frames]}
    with open(os.path.join(root, "kinpoly-mocap", "mocap_annotations.p"), "wb") as f:
        pickle.dump(recs, f)
    gt_path = os.path.join(root, "full_body_gt.p")
    with open(gt_path, "wb") as f:
        pickle.dump(gt, f)
    return gt_path


ARES_DEMO_ROOT = "/viscam/u/jiamanli/datasets/egomotion_syn_dataset/habitat_rendering_replica_all"


def write_ares_demo_fixture(root, rng, n_seqs, frames):
    """The layout ``run_egoego`` reads (``ARESDemoDataset``): demo_ares_data.p
    (plain pickle) whose of_files carry the reference's authors' cluster
    prefix, one OF feature npy per frame, and DROID-SLAM npys under
    droid_slam_res/frl_apartment_4/{take}.npy. ``n_seqs`` sequences of
    ``frames`` OF frames (frames + 1 head poses)."""
    feat_dir = os.path.join(root, "feats")
    slam_dir = os.path.join(root, "droid_slam_res", "frl_apartment_4")
    for d in (feat_dir, slam_dir):
        os.makedirs(d, exist_ok=True)
    recs = {}
    for si in range(n_seqs):
        take = f"demo_seq{si}"
        of_files = []
        for i in range(frames):
            np.save(os.path.join(feat_dir, f"raft_of_feats_{take}_{i}.npy"), rng.randn(512).astype(np.float32))
            of_files.append(os.path.join(ARES_DEMO_ROOT, "feats", f"raft_of_feats_{take}_{i}.npy"))
        walk = np.cumsum(rng.uniform(-0.02, 0.02, (frames + 1, 3)), 0)
        recs[si] = {"seq_name": f"frl_apartment_4-{take}", "of_files": of_files,
                    "head_qpos": np.concatenate([walk + [0, 0, 1.5], smooth_quats(rng, frames + 1)], -1)
                    .astype(np.float32),
                    "head_vels": (rng.randn(frames + 1, 6) * 0.01).astype(np.float32)}
        slam = np.concatenate([0.3 * walk + rng.randn(frames + 1, 3) * 1e-3, smooth_quats(rng, frames + 1)], -1)
        np.save(os.path.join(slam_dir, f"{take}.npy"), slam.astype(np.float32))
    with open(os.path.join(root, "demo_ares_data.p"), "wb") as f:
        pickle.dump(recs, f)
    return [r["seq_name"] for r in recs.values()]


def smplh_parents():
    """SMPL-H's 52-joint tree: SMPL's 22 body joints, then each hand's five
    fingers of three joints, the left hand's from joint 20, the right's
    from 21."""
    from egoego_release_tpu_torch.ops.fk import SMPL_PARENTS

    parents = list(SMPL_PARENTS)
    for wrist in (20, 21):
        for _ in range(5):
            base = len(parents)
            parents += [wrist, base, base + 1]
    return np.asarray(parents, np.int64)


def write_smplh_models(root, rng, n_verts=6890, n_faces=13776, n_betas=16, genders=("male", "female", "neutral")):
    """Synthetic SMPL-H model npzs at ``{root}/{gender}/model.npz`` in the
    reference's layout (v_template, shapedirs, posedirs, J_regressor,
    weights, kintree_table, f), 52 joints: each vertex belongs to one joint
    and lies near it (joints 0.1-0.3 m apart down the tree); J_regressor
    averages a joint's vertices; skinning weights favour the vertex's joint;
    faces join vertices of one joint. The real model is licensed."""
    parents = smplh_parents()
    n_joints = len(parents)
    for gender in genders:
        joints = np.zeros((n_joints, 3))
        for j in range(1, n_joints):
            joints[j] = joints[parents[j]] + rng.uniform(-0.3, 0.3, 3)
        owner = np.arange(n_verts) % n_joints
        v_template = joints[owner] + rng.randn(n_verts, 3) * 0.03
        j_reg = np.zeros((n_joints, n_verts))
        j_reg[owner, np.arange(n_verts)] = 1.0
        j_reg /= j_reg.sum(1, keepdims=True)
        weights = rng.rand(n_verts, n_joints) * 0.05
        weights[np.arange(n_verts), owner] += 1.0
        weights /= weights.sum(1, keepdims=True)
        tri_owner = rng.randint(0, n_joints, n_faces)
        faces = (tri_owner[:, None] + n_joints * rng.randint(0, n_verts // n_joints, (n_faces, 3))) % n_verts
        os.makedirs(os.path.join(root, gender), exist_ok=True)
        np.savez(os.path.join(root, gender, "model.npz"), v_template=v_template.astype(np.float32),
                 shapedirs=(rng.randn(n_verts, 3, n_betas) * 0.01).astype(np.float32),
                 posedirs=(rng.randn(n_verts, 3, (n_joints - 1) * 9) * 0.001).astype(np.float32),
                 J_regressor=j_reg.astype(np.float32), weights=weights.astype(np.float32),
                 kintree_table=np.stack([parents, np.arange(n_joints)]).astype(np.int64),
                 f=faces.astype(np.int32))
    return root


# kinpoly's humanoid (humanoid_smpl_neutral_mesh.xml): 24 bodies, depth first
MUJOCO_BODIES = ("Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe", "R_Hip", "R_Knee", "R_Ankle", "R_Toe",
                 "Torso", "Spine", "Chest", "Neck", "Head", "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist",
                 "L_Hand", "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand")
MUJOCO_PARENTS = (-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12, 11, 14, 15, 16, 17, 11, 19, 20, 21, 22)


def write_humanoid_xml(path, rest_pos):
    """A MuJoCo model XML of kinpoly's humanoid body tree (MUJOCO_BODIES,
    MUJOCO_PARENTS), each body at its world rest position ``rest_pos[b]``
    (24, 3), with three hinges in z, y, x order; the layout that
    ``ops.mujoco_xml.load_mujoco_skeleton`` reads."""
    import xml.etree.ElementTree as ET

    model = ET.Element("mujoco", model="humanoid")
    bodies = [ET.SubElement(model, "worldbody")]
    for b, (name, parent) in enumerate(zip(MUJOCO_BODIES, MUJOCO_PARENTS)):
        body = ET.SubElement(bodies[parent + 1] if parent >= 0 else bodies[0], "body", name=name,
                             pos=" ".join(f"{float(x):.6f}" for x in rest_pos[b]))
        if parent < 0:
            ET.SubElement(body, "freejoint", name="root")
        else:
            for axis, vec in (("z", "0 0 1"), ("y", "0 1 0"), ("x", "1 0 0")):
                ET.SubElement(body, "joint", name=f"{name}_{axis}", type="hinge", axis=vec,
                              pos=" ".join(f"{float(x):.6f}" for x in rest_pos[b]))
        bodies.append(body)
    ET.ElementTree(model).write(path)
    return path


def smpl_rest_to_mujoco(rest_offsets):
    """World rest positions (24, 3) of the humanoid's bodies from the SMPL
    skeleton's 22 rest offsets: each SMPL joint's position (the offsets
    summed down the tree) at its body (MUJOCO2SMPL_JOINT_IDX), the two
    hands 8 cm past the wrists."""
    from egoego_release_tpu_torch.ops.fk import SMPL_PARENTS
    from egoego_release_tpu_torch.ops.geometry import MUJOCO2SMPL_JOINT_IDX

    joints = np.zeros((24, 3), np.float64)
    for j in range(22):
        joints[j] = rest_offsets[j] + (joints[SMPL_PARENTS[j]] if j else 0.0)
    for hand, wrist in ((22, 20), (23, 21)):
        joints[hand] = joints[wrist] + (joints[wrist] - joints[SMPL_PARENTS[wrist]]) * 0.3
    pos = np.zeros((24, 3), np.float32)
    pos[MUJOCO2SMPL_JOINT_IDX] = joints
    return pos


def union_us(spans, lo, hi):
    """Microseconds of [lo, hi] covered by the (start, end) spans."""
    total, cur = 0.0, lo
    for a, b in spans:
        a, b = max(a, cur), min(b, hi)
        if b > a:
            total += b - a
            cur = b
    return total


def chain_boundaries(prof, n_chains, per_chain, per_step):
    """The card's timeline around each boundary between consecutive chains
    of a pipelined run, from the profiler's kernel spans: the interval from
    the last step kernel of chain k to the first of chain k+1, the idle time
    within it, and the busy share over the window from chain k's last 10
    steps to chain k+1's first 10. None when the profiler did not see every
    step kernel (it drops events now and then)."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    chain = [sp for sp in spans if "gemm_wgmma" in sp[2] or "attention_wgmma" in sp[2]]
    if len(chain) != n_chains * per_chain:
        return None, len(chain)
    every = [(a, b) for a, b, _ in spans]
    out = []
    for k in range(1, n_chains):
        last, first = chain[k * per_chain - 1], chain[k * per_chain]
        lo, hi = chain[k * per_chain - 10 * per_step][0], chain[k * per_chain + 10 * per_step - 1][1]
        gap = first[0] - last[1]
        out.append({"interval_ms": gap / 1e3, "idle_ms": (gap - union_us(every, last[1], first[0])) / 1e3,
                    "window_ms": (hi - lo) / 1e3, "busy_share": union_us(every, lo, hi) / (hi - lo)})
    return out, len(chain)


TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_ITER_STEPS = 300, 20, 50  # phase 11's three runs


def smooth_motion_pickle(path, rng, n_seqs):
    """An AMASS-layout motion pickle of smooth synthetic sequences: a root
    that walks a smooth curve at a steady height, a slowly turning yaw, and
    body joints swinging as sinusoids; lengths 150-700 frames, so the
    windows of each sequence's tail are padded."""
    data = {}
    for i in range(n_seqs):
        t = int(rng.randint(150, 700))
        s = np.arange(t)[:, None] / 30.0
        f, ph = rng.uniform(0.05, 0.3, (1, 3)), rng.uniform(0, 2 * np.pi, (1, 3))
        trans = np.sin(2 * np.pi * f * s + ph) * [1.0, 1.0, 0.02] + [0.0, 0.0, 0.9]
        yaw = rng.uniform(-np.pi, np.pi) + 0.3 * np.sin(2 * np.pi * rng.uniform(0.05, 0.2) * s[:, 0])
        root = np.stack([np.full(t, np.pi / 2) + 0.05 * np.sin(s[:, 0]), np.zeros(t), yaw], -1)
        fb, pb = rng.uniform(0.2, 1.0, (1, 63)), rng.uniform(0, 2 * np.pi, (1, 63))
        body = rng.uniform(0.05, 0.4, (1, 63)) * np.sin(2 * np.pi * fb * s + pb)
        data[i] = {"seq_name": f"synthetic-train{i}", "trans": trans.astype(np.float32),
                   "root_orient": root.astype(np.float32), "body_pose": body.astype(np.float32)}
    with open(path, "wb") as fh:
        pickle.dump(data, fh)


def train_step_flops(s2, windows):
    """f32 operations of one optimizer step over `windows` windows: the
    forward's products (stem, per layer QKV, scores, p v, fc, w1, w2, then
    linear_out and the noise-level MLP) times 3 for forward and backward."""
    t, t1, dm, d = s2.window, s2.window + 1, s2.d_model, 198
    hk, hv = s2.n_head * s2.d_k, s2.n_head * s2.d_v
    layer = 2 * t1 * dm * (2 * hk + hv) + 2 * t1 * t1 * (hk + hv) + 2 * t1 * hv * dm + 4 * t1 * dm * dm
    fwd = 2 * t * 2 * d * dm + s2.n_dec_layers * layer + 2 * t * dm * d + 2 * (64 * 256 + 256 * dm)
    return 3 * fwd * windows


# one optimizer step, card against CPU (train_step_agreement): the loss
# (relative); each gradient entry's distance from the float64 reference,
# of its tensor's max|.|, at most 1e-5 or twice the CPU's float32 distance
# in that tensor (grad64_excess, the ratio to that allowance); w_k.bias
# against the CPU (of the largest gradient); each parameter entry (of its
# tensor's max|.|); the inputs of the branches that the two sides took
# differently (of their call's max|.|); the free run's L2 distances over
# all gradients and in the worst tensor
STEP_BOUNDS = {"loss": 1e-5, "grad64_excess": 1.0, "wk_bias": 1e-6, "param": 1e-5, "adam": 1e-5,
               "flip_input": 1e-5, "grad_l2_all": 1e-4, "grad_l2": 1e-3}


def branch_mode(replay=None):
    """A torch function mode over a training step that records, in call
    order, the input of each torch.relu and Tensor.abs and the branch it
    takes (relu: input > 0; abs: the input's sign). Given the branches of
    another run (``replay``), each call takes those instead (x * s, whose
    gradient is s): two devices' steps then differ by rounding alone."""
    import torch

    class Branches(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.signs, self.inputs, self.kinds = [], [], []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is not torch.relu and func is not torch.Tensor.abs:
                return func(*args, **(kwargs or {}))
            x = args[0]
            s = (x > 0).to(x.dtype) if func is torch.relu else torch.sign(x)
            self.kinds.append(func.__name__)
            self.signs.append(s.detach().cpu())
            self.inputs.append(x.detach().cpu())
            if replay is None:
                return func(*args, **(kwargs or {}))
            return x * replay[len(self.signs) - 1].to(x.device, x.dtype)

    return Branches()


def float64_mode():
    """A torch function mode in which Tensor.float and a float32 dtype
    argument mean float64: the port's modules, which cast to float32 in
    places, then run a float64 forward and backward."""
    import torch

    class Float64(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.float:
                return args[0].double()
            f64 = lambda a: torch.float64 if a is torch.float32 else a
            return func(*map(f64, args), **{k: f64(v) for k, v in (kwargs or {}).items()})

    return Float64()


def float64_gradients(make_state, batch, seed, replay):
    """The loss and the gradients of a trainer step (the mean over its
    micro-batches, the padding mask with the noise token) computed in
    float64 on the CPU from ``make_state``'s weights, with the draws of
    ``TorchNoise("cpu", seed)`` and the branches ``replay``: the reference
    both float32 sides are held to."""
    import torch

    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import head_condition_mask
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise

    trainer, state = make_state(torch.device("cpu"))
    model = state.model.double()
    motion = torch.as_tensor(batch["motion"]).double()
    seq_len = torch.as_tensor(batch["seq_len"])
    window, micro = motion.shape[1], trainer.grad_accum
    mb = motion.shape[0] // micro
    pad = (torch.arange(window + 1)[None, :] < (seq_len + 1)[:, None]).double()[:, None, :]
    cond = head_condition_mask(mb, window).double()
    loss = 0.0
    with branch_mode(replay), float64_mode():
        for i, src in enumerate(TorchNoise("cpu", seed).split(micro)):
            sl = slice(i * mb, (i + 1) * mb)
            li = trainer.diffusion.p_losses(model, motion[sl], cond, pad[sl], noise=src, train=True) / micro
            li.backward()
            loss += float(li.detach())
    return loss, [p.grad.detach() for p in model.parameters()]


def trained_parameters(model):
    """(name, parameter) of the parameters a trainer updates: those that
    require a gradient (a frozen ResNet's are left out)."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def train_step_agreement(make_state, batch, seed, card, gradients64=None, adam=None):
    """One optimizer step from ``make_state(device)`` -> (trainer, state)
    (one weight set, dropout off) on ``batch`` with the draws of
    ``TorchNoise("cpu", seed)``, three times: on the card and on the CPU as
    each runs, and on the CPU again taking the card's branches; and its
    gradients in float64 on the CPU with the card's branches. A ReLU (or
    l1) input within rounding of 0 may take the other branch on the CPU,
    which moves whole gradient rows; with the card's branches the card's
    gradients must lie as close to the float64 ones as the CPU's float32
    gradients do, and its parameters agree entry by entry with the CPU's
    where the step does not hang on the gradient's rounding. Returns the
    measures named in STEP_BOUNDS and more. ``gradients64`` (the float64
    reference, by default the stage-2 trainer's float64_gradients) and
    ``adam(trainer)`` -> (lr, weight decay) of the first step (by default
    (trainer.lr, 0)) let it hold other trainers. Frozen parameters are left
    out (``trained_parameters``)."""
    import torch

    from egoego_release_tpu_torch.ops.fused_step import TorchNoise

    cpu = torch.device("cpu")
    runs = {}
    for side, where, replay in (("card", card, None), ("cpu", cpu, None), ("replay", cpu, "card")):
        trainer, state = make_state(where)
        p0 = {n: p.detach().cpu().double() for n, p in trained_parameters(state.model)}
        with branch_mode(runs[replay]["mode"].signs if replay else None) as mode:
            state, loss, *_ = trainer.train_step(state, batch, TorchNoise("cpu", seed))
        lr, wd = adam(trainer) if adam else (trainer.lr, 0.0)
        runs[side] = {"mode": mode, "state": state, "loss": float(loss), "p0": p0, "lr": lr, "wd": wd}
    c, h, r = runs["card"], runs["cpu"], runs["replay"]
    if [s.shape for s in c["mode"].signs] != [s.shape for s in r["mode"].signs]:
        raise AssertionError("card and CPU steps call relu / abs differently")
    m = {"loss": abs(c["loss"] - r["loss"]) / abs(r["loss"]), "loss_free": abs(c["loss"] - h["loss"]) / abs(h["loss"]),
         "branch_calls": len(c["mode"].signs), "flips": 0, "forced": 0, "flip_input": 0.0, "flip_calls": []}
    for i, s_c in enumerate(c["mode"].signs):
        free, forced = s_c != h["mode"].signs[i], s_c != r["mode"].signs[i]
        m["flips"] += int(free.sum())
        m["forced"] += int(forced.sum())
        if (free | forced).any():  # per micro-batch: each layer's relu in order, then the l1 loss's abs
            m["flip_calls"].append(f"{c['mode'].kinds[i]} call {i}")
        top = float(c["mode"].inputs[i].abs().max())
        for run, at in ((c, free | forced), (h, free), (r, forced)):
            if at.any():
                m["flip_input"] = max(m["flip_input"], float(run["mode"].inputs[i][at].abs().max()) / top)
    for run in runs.values():
        run["params"] = [p for _, p in trained_parameters(run["state"].model)]
        run["g"] = [p.grad.detach().cpu().double() for p in run["params"]]
    loss64, g64 = (gradients64 or float64_gradients)(make_state, batch, seed, c["mode"].signs)
    m.update(loss64=abs(c["loss"] - loss64) / abs(loss64), loss64_cpu=abs(r["loss"] - loss64) / abs(loss64),
             grad64=0.0, grad64_worst="", grad64_cpu=0.0, grad64_cpu_worst="", grad64_excess=0.0)
    g_top = max(float(g.abs().max()) for g in r["g"])
    upd = lambda lr, mo, v: lr * (mo / 0.1) / (torch.sqrt(v / 1e-3) + 1e-8)  # Adam's first step
    m.update(grad=0.0, grad_worst="", wk_bias=0.0, grad_free=0.0, grad_free_worst="", grad_l2=0.0,
             param=0.0, adam=0.0)
    num = den = covered = total = 0.0
    for k, (name, _) in enumerate(trained_parameters(c["state"].model)):
        g_c, g_h, g_r = c["g"][k], h["g"][k], r["g"][k]
        if name.endswith("self_attn.w_k.bias"):  # its gradient is rounding noise (the softmax cancels it)
            m["wk_bias"] = max(m["wk_bias"], float((g_c - g_r).abs().max()) / g_top)
        else:
            e = {}
            for key, a, b in (("grad", g_c, g_r), ("grad_free", g_c, g_h), ("grad64", g_c, g64[k]),
                              ("grad64_cpu", g_r, g64[k])):
                e[key] = float((a - b).abs().max()) / float(b.abs().max())
                if e[key] > m[key]:
                    m[key], m[key + "_worst"] = e[key], name
            m["grad64_excess"] = max(m["grad64_excess"], e["grad64"] / max(1e-5, 2 * e["grad64_cpu"]))
            m["grad_l2"] = max(m["grad_l2"], float((g_c - g_h).norm() / g_h.norm()))
            num, den = num + float((g_c - g_h).norm()) ** 2, den + float(g_h.norm()) ** 2
        p_c, p_r = (run["params"][k].detach().cpu().double() for run in (c, r))
        p_top = float(p_r.abs().max())
        # where |g| is well above Adam's eps and its rounding, the first step
        # lr g / (|g| + 1e-8) does not depend on the rounding: compare there
        big = (g_r.abs() >= 1e-3 * float(g_r.abs().max())) & (g_r.abs() >= 1e-6)
        covered, total = covered + int(big.sum()), total + big.numel()
        if big.any():
            m["param"] = max(m["param"], float((p_c - p_r)[big].abs().max()) / p_top)
        for run, p in ((c, p_c), (r, p_r)):  # each side's Adam(W) applied its own moments
            st = run["state"].optimizer.state[run["params"][k]]
            own = (run["p0"][name] * (1 - run["lr"] * run["wd"])
                   - upd(run["lr"], st["exp_avg"].cpu().double(), st["exp_avg_sq"].cpu().double()))
            m["adam"] = max(m["adam"], float((p - own).abs().max()) / p_top)
    m["grad_l2_all"], m["param_share"] = math.sqrt(num / den), covered / total
    return m


def train_phase(card, data_dir, eval_data_path, rest_path, check_counts, clear_counts):
    """Phase 11: stage-2 training at the release widths through
    train_diffusion.run, resumed, on the iterator path, card against CPU,
    then --sample and eval_stage2 on the trained checkpoint; the step's
    times, busy share and peak memory. Returns the summary."""
    import torch

    from egoego_release_tpu_torch.data.amass import AMASSWindowDataset
    from egoego_release_tpu_torch.data.prefetch import prefetch_to_device
    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion
    from egoego_release_tpu_torch.eval import eval_stage2
    from egoego_release_tpu_torch.models.transformer import set_dropout_rate
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise
    from egoego_release_tpu_torch.training import train_diffusion as td
    from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer
    from egoego_release_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    root = os.path.join(data_dir, "train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    train_path = os.path.join(root, "train_amass.p")
    smooth_motion_pickle(train_path, np.random.RandomState(13), 65)
    base = {"data": {"rest_offsets": rest_path, "stats_path": os.path.join(root, "stats.p")},
            "logging": {"save_dir": root, "exp_name": "release", "log_every": 50}}
    sets = [f"train.num_steps={TRAIN_STEPS}", "train.save_every=200", "train.seed=0"]
    cfg = load_config(base, overrides=sets)
    s2, n_batch = cfg.stage2, cfg.data.batch_size * cfg.train.grad_accum
    weights = os.path.join(root, "release", "weights")

    # 1. train_diffusion.run on the device-resident bank
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = td.run(cfg, train_path, device="cuda")
    torch.cuda.synchronize()
    dt_run = time.perf_counter() - t0
    logged = [json.loads(line) for line in open(os.path.join(root, "release", "metrics.jsonl"))]
    means = [r["loss_mean"] for r in logged]
    if state.step != TRAIN_STEPS or int(state.nan_count) != 0 or len(logged) != TRAIN_STEPS // 50:
        raise AssertionError(f"phase 11: step {state.step}, nan_count {int(state.nan_count)}, {len(logged)} log lines")
    if not (all(map(math.isfinite, means + [r["loss"] for r in logged])) and means[-1] < means[0]):
        raise AssertionError(f"phase 11: loss means per 50 steps {means}")
    ckpts = sorted(os.listdir(weights))
    if ckpts != ["model-200.pt", f"model-{TRAIN_STEPS}.pt"]:
        raise AssertionError(f"phase 11: checkpoints {ckpts}")
    log(f"phase 11: train_diffusion.run, release widths, micro-batch {cfg.data.batch_size} x grad-accum "
        f"{cfg.train.grad_accum}, {TRAIN_STEPS} steps on the device-resident bank in {dt_run:.2f} s (data build "
        f"included); mean loss of steps 1-50 {means[0]:.4f}, of steps {TRAIN_STEPS - 49}-{TRAIN_STEPS} "
        f"{means[-1]:.4f}; per 50 steps {[round(m, 4) for m in means]}; checkpoints {ckpts} [{card}]")

    # 2. resume from the newest checkpoint
    state = td.run(load_config(base, overrides=sets + [f"train.num_steps={TRAIN_RESUME_STEPS}"]), train_path,
                   device="cuda")
    if state.step != TRAIN_STEPS + TRAIN_RESUME_STEPS or int(state.nan_count) != 0:
        raise AssertionError(f"phase 11: resumed run ended at step {state.step}")
    ckpt = td.latest_checkpoint(weights)
    log(f"phase 11: resumed from model-{TRAIN_STEPS}.pt, {TRAIN_RESUME_STEPS} more steps: step {state.step}, "
        f"newest checkpoint {os.path.basename(ckpt)}")

    # 3. the iterator + prefetch path
    state_it = td.run(load_config(base, overrides=sets + [
        f"train.num_steps={TRAIN_ITER_STEPS}", "data.device_resident=false", "data.prefetch=2",
        "logging.exp_name=iterator", "logging.log_every=10"]), train_path, device="cuda")
    logged_it = [json.loads(line) for line in open(os.path.join(root, "iterator", "metrics.jsonl"))]
    if state_it.step != TRAIN_ITER_STEPS or not all(math.isfinite(r["loss_mean"]) for r in logged_it):
        raise AssertionError(f"phase 11: iterator run: step {state_it.step}, {logged_it}")
    log(f"phase 11: iterator + prefetch 2, {TRAIN_ITER_STEPS} steps: loss means per 10 steps "
        f"{[round(r['loss_mean'], 4) for r in logged_it]}")

    # the step: ms (CUDA events, after 20 warm-up steps), busy share, host ms
    # per step of both data paths, peak memory with remat off and on
    ds = AMASSWindowDataset(train_path, np.load(rest_path), window=cfg.data.window,
                            stats_path=cfg.data.stats_path)
    bank, seq_lens = (torch.as_tensor(a, device=dev) for a in ds.materialize_windows())
    n_padded = int((seq_lens < cfg.data.window).sum())

    def trainer_and_state(remat=False):
        tr = DiffusionTrainer(CondGaussianDiffusion(dataclasses.replace(td.diffusion_config(s2), remat=remat),
                                                       device=dev))
        return tr, tr.init_state(torch.Generator().manual_seed(1))

    trainer, st = trainer_and_state()
    noise = TorchNoise(dev, seed=7)
    box = [st]

    def step():
        box[0], _ = trainer._train_step_device(box[0], bank, seq_lens, noise, n_batch)

    for _ in range(20):
        step()
    times = []
    for _ in range(30):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    step_ms = statistics.median(times)

    def wall_ms(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    wall_dev = wall_ms(step, 20)
    dev_ms, kernels = device_time_ms(step, reps=20, chain=True)
    busy = dev_ms / wall_dev
    launches = sum(kernels.values()) / 20
    batches = prefetch_to_device(ds.batch_iterator(n_batch, seed=0), prefetch=2, device=dev)
    it_step = lambda: trainer.train_step(box[0], next(batches), noise)
    for _ in range(5):
        it_step()
    wall_it = wall_ms(it_step, 20)
    flops = train_step_flops(s2, n_batch)
    bound_ms = flops / PEAK_F32 * 1e3
    peak = {}
    for remat in (False, True):
        box.clear()
        trainer = st = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        trainer, st = trainer_and_state(remat)
        box.append(st)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated() / 2**20
    log(f"phase 11: optimizer step (release widths, {n_batch} windows of {cfg.data.window} frames, f32, "
        f"{len(ds)} windows in the bank, {n_padded} padded): {step_ms:.3f} ms (median of 30 CUDA-event timings "
        f"after 20 warm-up steps), {n_batch / step_ms * 1e3:.0f} window-grads/s; bound {bound_ms:.3f} ms "
        f"({flops / 1e9:.1f} GFLOP at {PEAK_F32 / 1e12:.0f} TFLOP/s f32) [{card}]")
    log(f"phase 11: device-busy share over 20 steps {busy:.3f} (device {dev_ms:.3f} ms of {wall_dev:.3f} ms "
        f"wall a step; {launches:.0f} device kernels and copies a step); host ms per step: device-resident "
        f"{wall_dev:.3f}, iterator + prefetch {wall_it:.3f} "
        f"({wall_it / wall_dev:.2f}x) [{card}]")
    log(f"phase 11: torch.cuda.max_memory_allocated over 3 steps: remat off {peak[False]:.1f} MiB, remat on "
        f"{peak[True]:.1f} MiB [{card}]")
    box.clear()
    trainer = st = None

    # 4. one step on the card against the CPU: same weights, batch and
    # draws (t, noise and condition noise from one CPU generator), dropout off
    batch = ds.materialize_windows()
    pick = np.random.RandomState(3).choice(len(ds), 16, replace=False)
    batch = {"motion": batch[0][pick], "seq_len": batch[1][pick]}

    def make_state(where):
        tr = DiffusionTrainer(CondGaussianDiffusion(td.diffusion_config(s2), device=where), lr=cfg.train.learning_rate)
        st = tr.init_state(torch.Generator().manual_seed(2))
        set_dropout_rate(st.model, 0.0)
        return tr, st

    errs = train_step_agreement(make_state, batch, 4, dev)
    log(f"phase 11: one step, card vs CPU, 16 windows, release widths (bounds in brackets): loss "
        f"{errs['loss']:.3e} relative [{STEP_BOUNDS['loss']}]; {errs['branch_calls']} relu / l1 calls, "
        f"{errs['flips']} entries where the CPU took the other branch, {errs['forced']} where the CPU replay "
        f"was made to take the card's ({', '.join(errs['flip_calls']) or 'none'}), their inputs within "
        f"{errs['flip_input']:.3e} of their call's max|x| "
        f"[{STEP_BOUNDS['flip_input']}]; with the card's branches, gradients against float64: card "
        f"{errs['grad64']:.3e} of each tensor's max in the worst entry ({errs['grad64_worst']}), CPU "
        f"{errs['grad64_cpu']:.3e} ({errs['grad64_cpu_worst']}), the card's largest ratio to max(1e-5, twice "
        f"the CPU's) {errs['grad64_excess']:.3f} [{STEP_BOUNDS['grad64_excess']}]; card vs CPU: gradients "
        f"{errs['grad']:.3e} ({errs['grad_worst']}), w_k.bias {errs['wk_bias']:.3e} of the largest gradient "
        f"[{STEP_BOUNDS['wk_bias']}], parameters {errs['param']:.3e} of max|p| in the worst entry where |g| >= "
        f"1e-3 of its tensor's max and >= 1e-6 ({errs['param_share']:.4f} of the entries) "
        f"[{STEP_BOUNDS['param']}], each side's Adam from its own moments {errs['adam']:.3e} "
        f"[{STEP_BOUNDS['adam']}]; as each side runs: loss {errs['loss_free']:.3e}, gradients "
        f"{errs['grad_l2_all']:.3e} relative L2 over all tensors [{STEP_BOUNDS['grad_l2_all']}], "
        f"{errs['grad_l2']:.3e} in the worst tensor [{STEP_BOUNDS['grad_l2']}], {errs['grad_free']:.3e} of its max "
        f"in the worst entry ({errs['grad_free_worst']})")
    bad = {k: errs[k] for k, bound in STEP_BOUNDS.items() if not errs[k] <= bound}
    if bad:
        raise AssertionError(f"phase 11: card and CPU steps disagree: {bad}")

    # 5. --sample on the trained checkpoint: DDPM-1000, f32 step kernels
    sample_sets = sets + [f"data.rest_offsets={rest_path}", f"logging.save_dir={root}", "logging.exp_name=release"]
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = td.main(["--sample", "--device", "cuda", "--set", *sample_sets])
    torch.cuda.synchronize()
    dt_sample = time.perf_counter() - t0
    check_counts(1, s2.timesteps, "phase 11 --sample (f32)", bf16=False)
    if tuple(out.shape) != (4, s2.window, 198) or not torch.isfinite(out).all():
        raise AssertionError(f"phase 11: --sample gave {tuple(out.shape)}")
    log(f"phase 11: train_diffusion --sample from {os.path.basename(ckpt)}: 4 windows, DDPM-{s2.timesteps} f32 in "
        f"{dt_sample:.2f} s [{card}]")

    # 6. eval_stage2 on the trained checkpoint
    clear_counts()
    res = eval_stage2.run(eval_stage2.parse_opt([
        "--test_data_path", eval_data_path, "--stats_path", cfg.data.stats_path, "--rest_offsets", rest_path,
        "--checkpoint", ckpt, "--ddim_steps", "50", "--batch_seqs", "4", "--max_seqs", "4",
        "--out_dir", os.path.join(root, "eval"), "--device", "cuda"]))
    check_counts(1, 50, "phase 11 eval_stage2 --checkpoint (f32 DDIM-50)", bf16=False)
    if res["num_seqs"] != 4 or not all(math.isfinite(v) for v in res["mean"].values()):
        raise AssertionError(f"phase 11: eval_stage2 on the trained checkpoint: {res['mean']}")
    log(f"phase 11: eval_stage2 --checkpoint {os.path.basename(ckpt)} --ddim_steps 50, 4 sequences: mpjpe "
        f"{res['mean']['mpjpe']:.1f} mm; phase 11 took {time.perf_counter() - t_phase:.1f} s")
    ck.launch_counts.clear()
    return {"step_ms": step_ms, "window_grads_per_s": n_batch / step_ms * 1e3, "bound_ms": bound_ms,
            "gflop": flops / 1e9, "device_busy_share": busy, "device_ms": dev_ms, "launches_per_step": launches,
            "host_ms_device_resident": wall_dev,
            "host_ms_iterator": wall_it, "peak_mib_remat_off": peak[False], "peak_mib_remat_on": peak[True],
            "loss_mean_first_50": means[0], "loss_mean_last_50": means[-1], "run_s": dt_run,
            "card_vs_cpu": errs, "sample_s": dt_sample, "windows": len(ds),
            "padded_windows": n_padded, "card": card}


STAGE1_SEQS, STAGE1_FRAMES, STAGE1_EPOCHS = 320, 62, 20  # phase 13: sequences, OF frames each, epochs
STAGE1_BATCH = 32  # the reference's stage-1 batch
ARES_ROOT = "/viscam/u/jiamanli/datasets/egomotion_syn_dataset"  # the OF paths' root in the reference's pickles


def quat_mul_np(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], -1)


def integrate_head(q0, va, dt=1.0 / 30.0):
    """numpy twin of models.headnet.va2rot for one sequence: q0 (4,) wxyz,
    va (T, 3) the angular velocities (rad/s) as va2rot reads them -> (T+1, 4)."""
    out = [q0]
    for v in va:
        q = out[-1]
        u, w = q[1:], q[0]
        angv = v + 2.0 * (w * np.cross(u, v) + np.cross(u, np.cross(u, v)))
        ang = np.linalg.norm(angv * dt)
        half = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * angv * dt / max(ang, 1e-12)])
        new = quat_mul_np(half, q)
        new = -new if new[0] < 0 else new
        out.append(new / np.linalg.norm(new))
    return np.stack(out).astype(np.float32)


def smooth_head_track(rng, frames):
    """(frames + 1, 7) head poses and (frames, 6) velocities of a walking
    head that turns smoothly: translation from sinusoids, angular velocity
    (rad/s) from sinusoids integrated as va2rot integrates it."""
    s = np.arange(frames + 1)[:, None] / 30.0
    f, ph = rng.uniform(0.1, 0.5, (1, 3)), rng.uniform(0, 2 * np.pi, (1, 3))
    trans = np.sin(2 * np.pi * f * s + ph) * [0.8, 0.8, 0.03] + [0.0, 0.0, 1.6]
    fa, pa = rng.uniform(0.1, 0.6, (1, 3)), rng.uniform(0, 2 * np.pi, (1, 3))
    va = (rng.uniform(0.2, 1.0, (1, 3)) * np.sin(2 * np.pi * fa * s[:-1] + pa)).astype(np.float32)
    quats = integrate_head(smooth_quats(rng, 1)[0], va)
    vel = np.concatenate([np.diff(trans, axis=0) * 30.0, va], -1).astype(np.float32)
    return np.concatenate([trans, quats], -1).astype(np.float32), vel


def write_ares_fixture(root, rng, n_seqs, frames, feat_dim=512, flow_pool=None):
    """The ARES training layout that ``ARESHeadPoseDataset(train=True)``
    reads: ares_egoego_processed/train_ares_smplh_motion.p (head_qpos
    (frames + 1, 7), head_vels (frames + 1, 6), of_files, seq_name; plain
    pickle), one OF feature npy of ``feat_dim`` floats per frame under
    ares/<scene>/<take>/raft_of_feats/ (the pickle holds the reference's
    authors' paths to raft_flows, which the dataset rewrites), DROID-SLAM
    npys ares/droid_slam_res/<scene>/<take>.npy. A frame's features are a
    fixed random projection of its velocities and step length, plus noise,
    so HeadNet has something to learn. With ``flow_pool`` = (n, h, w) no
    features: n raw-flow npys of h x w x 2 under ares/flow_pool/raft_flows/,
    and each frame's of_file one of them at random (paths repeat), for the
    raw-flow HeadNet."""
    proj = rng.randn(feat_dim, 7).astype(np.float32)
    os.makedirs(os.path.join(root, "ares_egoego_processed"), exist_ok=True)
    if flow_pool is not None:
        pool_dir = os.path.join(root, "ares", "flow_pool", "raft_flows")
        os.makedirs(pool_dir, exist_ok=True)
        for j in range(flow_pool[0]):
            np.save(os.path.join(pool_dir, f"{j:05d}.npy"), (2 * rng.randn(*flow_pool[1:], 2)).astype(np.float32))
    recs = {}
    for si in range(n_seqs):
        scene, take = f"scene{si % 4}", f"take{si}"
        head, vel = smooth_head_track(rng, frames)
        if flow_pool is None:
            step = np.linalg.norm(np.diff(head[:, :3], axis=0), axis=-1, keepdims=True) * 10.0
            feats = np.concatenate([vel, step], -1) @ proj.T + 0.1 * rng.randn(frames, feat_dim)
            feat_dir = os.path.join(root, "ares", scene, take, "raft_of_feats")
            os.makedirs(feat_dir, exist_ok=True)
            for i in range(frames):
                np.save(os.path.join(feat_dir, f"{i:05d}.npy"), feats[i].astype(np.float32))
            of_files = [f"{ARES_ROOT}/{scene}/{take}/raft_flows/{i:05d}.npy" for i in range(frames)]
        else:
            of_files = [f"{ARES_ROOT}/flow_pool/raft_flows/{j:05d}.npy" for j in rng.randint(flow_pool[0], size=frames)]
        recs[si] = {"seq_name": f"{scene}-{take}", "head_qpos": head,
                    "head_vels": np.concatenate([vel, vel[-1:]]), "of_files": of_files}
        slam_dir = os.path.join(root, "ares", "droid_slam_res", scene)
        os.makedirs(slam_dir, exist_ok=True)
        slam = np.concatenate([0.3 * head[:, :3] + rng.randn(frames + 1, 3) * 1e-3, head[:, 3:]], -1)
        np.save(os.path.join(slam_dir, f"{take}.npy"), slam.astype(np.float32))
    with open(os.path.join(root, "ares_egoego_processed", "train_ares_smplh_motion.p"), "wb") as fh:
        pickle.dump(recs, fh)


def write_head_motion(path, rng, n_seqs, lengths=(125, 300)):
    """GravityNet's training pickle: {"CMU-synthetic<i>": {"head_pose":
    (T, 7)}} of smooth head tracks, T uniform in ``lengths``."""
    data = {f"CMU-synthetic{i}": {"head_pose": smooth_head_track(rng, int(rng.randint(*lengths)) - 1)[0]}
            for i in range(n_seqs)}
    with open(path, "wb") as fh:
        pickle.dump(data, fh)


def stage1_gradients64(make_state, batch, seed, replay):
    """train_step_agreement's float64 reference for a stage-1 trainer: the
    loss and the clipped gradients of ``make_state``'s trained weights in
    float64 on the CPU, taking the branches ``replay`` (dropout off:
    ``seed`` unused)."""
    import torch

    trainer, state = make_state(torch.device("cpu"))
    model = state.model.double().train()
    b = {k: torch.as_tensor(v).long() if k == "seq_len" else torch.as_tensor(v).double() for k, v in batch.items()}
    with branch_mode(replay), float64_mode():
        loss, _ = trainer.loss_fn(model, b)
        loss.backward()
        grads = [p.grad for _, p in trained_parameters(model)]
        trainer.optimizer.clip_(grads)
    return float(loss.detach()), [g.detach() for g in grads]


def stage1_step_flops(kind, m, batch):
    """f32 operations of one stage-1 optimizer step: the forward's products
    (the stem, per layer QKV, scores, p v, fc and the FFN, the MLP heads)
    times 3 for forward and backward."""
    t, dm, hk, hv = m.window, m.d_model, m.n_head * m.d_k, m.n_head * m.d_v
    layer = 2 * t * dm * (2 * hk + hv) + 2 * t * t * (hk + hv) + 2 * t * hv * dm + 4 * t * dm * dm
    if kind == "headnet":  # two heads (1024, 512, 256) over every frame, from 512 OF features
        heads = 2 * t * 2 * (dm * 1024 + 1024 * 512 + 512 * 256) + 2 * t * 256 * 4
        fwd = 2 * t * 512 * dm + m.n_dec_layers * layer + heads
    else:  # one head (512, 256) on token 0, from 18 trajectory features
        fwd = 2 * t * 18 * dm + m.n_dec_layers * layer + 2 * (dm * 512 + 512 * 256 + 256 * 3)
    return 3 * fwd * batch


def stage1_phase(card, data_dir, stats_path, rest_path, per_step, c_per_step, clear_counts):
    """Phase 13: stage-1 training at the release widths (Stage1ModelConfig
    defaults, batch 32, HeadNet window 60, GravityNet window 120, f32) on
    synthetic fixtures written here: ``train_stage1 headnet`` (ARES layout,
    per-frame OF feature npys read by the native loader) and
    ``train_stage1 gravitynet`` (a pickle of smooth head tracks) for
    STAGE1_EPOCHS epochs each (a falling mean loss, no NaN, a checkpoint
    each epoch, the last reloaded); one step of each, card against CPU
    (train_step_agreement); ms per step, busy share, va2rot's share of the
    HeadNet step, peak memory and the f32 bound; then ``eval_egoego
    --headnet_ckpt --gravitynet_ckpt --headnet_window 256 --fused_step`` on
    the trained checkpoints with exact launch counts. Returns the summary."""
    import torch

    from egoego_release_tpu_torch.data import native_loader
    from egoego_release_tpu_torch.data.amass_headpose import AMASSHeadPoseDataset
    from egoego_release_tpu_torch.data.formats import load_motion_dict
    from egoego_release_tpu_torch.data.headpose import ARESHeadPoseDataset
    from egoego_release_tpu_torch.eval import eval_egoego
    from egoego_release_tpu_torch.models.denoiser import init_weights_
    from egoego_release_tpu_torch.models.gravitynet import HeadNormalFormer
    from egoego_release_tpu_torch.models.headnet import HeadFormer, va2rot
    from egoego_release_tpu_torch.models.transformer import set_dropout_rate
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise
    from egoego_release_tpu_torch.training import train_stage1 as ts
    from egoego_release_tpu_torch.training.trainer_stage1 import (
        Stage1Trainer, gravitynet_loss_fn, headnet_loss_fn, make_optimizer)
    from egoego_release_tpu_torch.utils.config import load_config
    from egoego_release_tpu_torch.utils.convert import load_denoiser_weights, load_stage1_ckpt

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    root = os.path.join(data_dir, "stage1")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ares_root, motion_path = os.path.join(root, "ares_root"), os.path.join(root, "head_motion.p")
    write_ares_fixture(ares_root, np.random.RandomState(17), STAGE1_SEQS, STAGE1_FRAMES)
    write_head_motion(motion_path, np.random.RandomState(19), STAGE1_SEQS)
    log(f"phase 13: fixtures: {STAGE1_SEQS} ARES-layout sequences of {STAGE1_FRAMES} OF frames "
        f"({STAGE1_SEQS * STAGE1_FRAMES} feature npys), {STAGE1_SEQS} head tracks of 125-299 frames, in "
        f"{time.perf_counter() - t_phase:.1f} s")
    sets = ["logging.log_every=10", "train.seed=0", f"data.batch_size={STAGE1_BATCH}", f"logging.save_dir={root}"]
    cfg = load_config(None, overrides=sets)
    kinds = {"headnet": (HeadFormer, cfg.headnet, headnet_loss_fn, cfg.train.lr_step_size,
                         ["headnet", "--dataset", "ares", "--data_root_folder", ares_root]),
             "gravitynet": (HeadNormalFormer, cfg.gravitynet, gravitynet_loss_fn, ts.GRAVITYNET_LR_STEP_EPOCHS,
                            ["gravitynet", "--motion_path", motion_path])}
    native_loader.counts.clear()
    out, ckpts = {}, {}
    for kind, (cls, m, loss_fn, lr_step, argv) in kinds.items():
        # 1. the CLI, release widths, on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ts.main(argv + ["--epochs", str(STAGE1_EPOCHS), "--device", "cuda", "--set", *sets,
                                f"logging.exp_name={kind}"])
        torch.cuda.synchronize()
        dt_run = time.perf_counter() - t0
        logged = [json.loads(line) for line in open(os.path.join(root, kind, "metrics.jsonl"))]
        losses = [r["loss"] for r in logged]
        tenth = max(1, len(losses) // 10)
        first, last = statistics.mean(losses[:tenth]), statistics.mean(losses[-tenth:])
        weights = os.path.join(root, kind, "weights")
        names = sorted(os.listdir(weights), key=lambda n: int(re.sub(r"\D", "", n)))
        if (state.epoch != STAGE1_EPOCHS or len(logged) != state.step // 10 or not all(map(math.isfinite, losses))
                or not last < first or names != [f"epoch-{i}.pt" for i in range(STAGE1_EPOCHS)]):
            raise AssertionError(f"phase 13 {kind}: epoch {state.epoch}, step {state.step}, {len(logged)} log lines, "
                                 f"mean loss first {first} last {last}, checkpoints {names}")
        ckpts[kind] = os.path.join(weights, names[-1])
        reloaded = load_denoiser_weights(cls(window=m.window), load_stage1_ckpt(ckpts[kind], kind, m.n_dec_layers))
        same = all(torch.equal(v, state.model.state_dict()[k].cpu()) for k, v in reloaded.state_dict().items())
        if not same:
            raise AssertionError(f"phase 13 {kind}: {names[-1]} does not reload the trained weights")
        log(f"phase 13: train_stage1 {kind}, release widths, batch {STAGE1_BATCH}, window {m.window}, "
            f"{STAGE1_EPOCHS} epochs = {state.step} steps in {dt_run:.2f} s (data and checkpoints included); mean "
            f"loss of the first {tenth} logged steps {first:.4f}, of the last {tenth} {last:.4f}; {len(names)} "
            f"checkpoints, {names[-1]} reloaded bit for bit [{card}]")
        r = out[kind] = {"run_s": dt_run, "steps": state.step, "loss_first": first, "loss_last": last}

        # 2. the step: ms, busy share, peak memory, the f32 bound
        if kind == "headnet":
            ds = ARESHeadPoseDataset(ares_root, train=True, window=m.window)
            items = [ds[i] for i in range(STAGE1_BATCH)]
            batch = {k: np.stack([it[k] for it in items]) for k in ("of", "head_pose", "head_vels", "seq_len")}
        else:
            batch = next(AMASSHeadPoseDataset(load_motion_dict(motion_path), train=True, window=m.window,
                                              seed=1).batch_iterator(STAGE1_BATCH))
        batch_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

        def trainer_state(where, dropout=True):
            tr = Stage1Trainer(loss_fn, make_optimizer(cfg.train.learning_rate, lr_step, cfg.train.lr_gamma, 10))
            model = cls(d_model=m.d_model, n_layers=m.n_dec_layers, n_head=m.n_head, d_k=m.d_k, d_v=m.d_v,
                        window=m.window)
            st = tr.init_state(init_weights_(model, torch.Generator().manual_seed(1)).to(where))
            if not dropout:
                set_dropout_rate(st.model, 0.0)
            return tr, st

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        tr, st = trainer_state(dev)
        noise = TorchNoise(dev, seed=7)
        step = lambda: tr.train_step(st, batch_dev, noise)
        for _ in range(10):
            step()
        times = []
        for _ in range(30):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        r["step_ms"] = statistics.median(times)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        r["wall_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        # 5 steps under the profiler: a HeadNet step launches ~12,000 kernels
        r["device_ms"], kernels = device_time_ms(step, reps=5, chain=True)
        r["device_busy_share"] = r["device_ms"] / r["wall_ms"]
        r["launches_per_step"] = sum(kernels.values()) / 5
        r["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20  # model, AdamW, the steps' activations
        r["gflop"] = stage1_step_flops(kind, m, STAGE1_BATCH) / 1e9
        r["bound_ms"] = r["gflop"] * 1e9 / PEAK_F32 * 1e3
        extra = ""
        if kind == "headnet":  # va2rot forward and backward at the step's shapes, alone
            va = torch.randn(STAGE1_BATCH, m.window, 3, device=dev, requires_grad=True)
            q0 = torch.as_tensor(batch["head_pose"][:, 0, 3:], device=dev)

            def integrate():
                va2rot(q0, va).sum().backward()

            def wall(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            integrate()
            pairs = [(wall(step), wall(integrate)) for _ in range(15)]  # in turns, on one host's load
            r["va2rot_ms"] = statistics.median(v for _, v in pairs)
            r["va2rot_share"] = statistics.median(v / s for s, v in pairs)
            r["va2rot_device_ms"], vk = device_time_ms(integrate, reps=5, chain=True)
            r["va2rot_launches"] = sum(vk.values()) / 5
            extra = (f"; va2rot forward + backward alone {r['va2rot_ms']:.3f} ms wall ({r['va2rot_launches']:.0f} "
                     f"launches, device {r['va2rot_device_ms']:.3f} ms), {r['va2rot_share']:.3f} of the step (median "
                     f"over 15 pairs timed in turns)")
        log(f"phase 13: {kind} optimizer step (batch {STAGE1_BATCH}, window {m.window}, f32, dropout on): "
            f"{r['step_ms']:.3f} ms (median of 30 CUDA-event timings after 10 warm-up steps), wall "
            f"{r['wall_ms']:.3f} ms "
            f"over 20; device {r['device_ms']:.3f} ms, busy share {r['device_busy_share']:.3f}, "
            f"{r['launches_per_step']:.0f} device kernels and copies a step; peak {r['peak_mib']:.1f} MiB; bound "
            f"{r['bound_ms']:.3f} ms ({r['gflop']:.2f} GFLOP at {PEAK_F32 / 1e12:.0f} TFLOP/s f32){extra} [{card}]")
        del tr, st, step

        # 3. one step, card against CPU, dropout off
        pick = {k: v[:8] for k, v in batch.items()}
        errs = train_step_agreement(lambda where: trainer_state(where, dropout=False), pick, 4, dev,
                                    gradients64=stage1_gradients64,
                                    adam=lambda tr: (tr.optimizer.learning_rate(0), tr.optimizer.weight_decay))
        log(f"phase 13: {kind} one step, card vs CPU, 8 sequences (bounds in brackets): loss {errs['loss']:.3e} "
            f"[{STEP_BOUNDS['loss']}]; {errs['branch_calls']} relu / abs calls, {errs['flips']} entries where the CPU "
            f"took the other branch, {errs['forced']} forced ({', '.join(errs['flip_calls']) or 'none'}), inputs "
            f"within {errs['flip_input']:.3e} of their call's max|x| [{STEP_BOUNDS['flip_input']}]; clipped gradients "
            f"against float64: card {errs['grad64']:.3e} ({errs['grad64_worst']}), CPU {errs['grad64_cpu']:.3e}, ratio "
            f"{errs['grad64_excess']:.3f} [{STEP_BOUNDS['grad64_excess']}]; card vs CPU gradients {errs['grad']:.3e}, "
            f"w_k.bias {errs['wk_bias']:.3e} [{STEP_BOUNDS['wk_bias']}], parameters {errs['param']:.3e} over "
            f"{errs['param_share']:.4f} of the entries [{STEP_BOUNDS['param']}], each side's AdamW from its own "
            f"moments "
            f"{errs['adam']:.3e} [{STEP_BOUNDS['adam']}]; as each side runs: gradients {errs['grad_l2_all']:.3e} "
            f"relative L2 [{STEP_BOUNDS['grad_l2_all']}], {errs['grad_l2']:.3e} in the worst tensor "
            f"[{STEP_BOUNDS['grad_l2']}] (held when no branch flipped)")
        # the free run's L2 distances are held only where both sides took the
        # same branches: a unit whose input lies within rounding of 0
        # (flip_input) moves its gradient row whole, and then the replayed
        # measures hold the step
        free = ("grad_l2_all", "grad_l2") if errs["flips"] else ()
        bad = {k: errs[k] for k, bound in STEP_BOUNDS.items() if not errs[k] <= bound and k not in free}
        if bad:
            raise AssertionError(f"phase 13 {kind}: card and CPU steps disagree: {bad}")
        r["card_vs_cpu"] = errs
    if native_loader.counts["numpy"] or not native_loader.counts["native"]:
        raise AssertionError(f"phase 13: OF batches read by {dict(native_loader.counts)}, want the native loader only")
    log(f"phase 13: OF feature batches read by the native loader: {dict(native_loader.counts)}")

    # 4. eval_egoego on the trained checkpoints, HeadNet blocks of 256
    kin_root = os.path.join(root, "kinpoly")
    seqs, frames = 2, FRAMES_D
    gt_path = write_kinpoly_fixture(kin_root, np.random.RandomState(23), [frames] * seqs)
    opt = eval_egoego.parse_opt([
        "--data_root_folder", kin_root, "--full_body_gt_path", gt_path, "--stats_path", stats_path,
        "--rest_offsets", rest_path, "--headnet_ckpt", ckpts["headnet"], "--gravitynet_ckpt", ckpts["gravitynet"],
        "--headnet_window", str(HEADNET_WINDOW_D), "--fused_step", "--out_dir", os.path.join(root, "out_egoego"),
        "--device", "cuda"])
    clear_counts()
    t0 = time.perf_counter()
    res = eval_egoego.run(opt)
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    timesteps, window, overlap = 1000, 120, 10
    windows = seqs * (1 + math.ceil((frames - window) / (window - overlap)))
    want = {"fused_attention": cfg.headnet.n_dec_layers * seqs,
            **{k: windows * timesteps * v for k, v in per_step.items()}}
    want_c = {"mha": want["fused_attention"], **{k: windows * timesteps * v for k, v in c_per_step().items()}}
    got, got_c = dict(ck.launch_counts), dict(ck.kernel_launches)
    log(f"phase 13: eval_egoego --headnet_ckpt {os.path.basename(ckpts['headnet'])} --gravitynet_ckpt "
        f"{os.path.basename(ckpts['gravitynet'])} --headnet_window {HEADNET_WINDOW_D} --fused_step, {seqs} seqs x "
        f"{frames} frames in {dt_eval:.2f} s: launches {got} (expected {want}); C entries {got_c} (expected {want_c})")
    if got != want or got_c != want_c:
        raise AssertionError(f"phase 13: eval_egoego launch counts {got}, {got_c} != {want}, {want_c}")
    entries = res["per_seq"].values()
    if res["num_seqs"] != seqs or not all(math.isfinite(v) for e in entries for v in e.values()):
        raise AssertionError(f"phase 13: bad eval result {res}")
    log(f"phase 13: eval_egoego on the trained stage 1: s1_t_head {res['mean']['s1_t_head']:.1f} mm, mpjpe "
        f"{res['mean']['mpjpe']:.1f} mm (stage 2 random); phase 13 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    ck.launch_counts.clear()
    out["eval_egoego_s"] = dt_eval
    out["card"] = card
    return out


PAR_SEQS, PAR_FRAMES = 16, 470  # phase 14a: 4 full windows a sequence (64 stacked) and a 30-frame tail
DEMO_FRAMES = 120                # phase 14c: OF frames of the ARES demo sequence (121 head poses)


def outputs_phase(card, data_dir, stats_path, rest_path, kin_root, kin_gt_path, per_step, c_per_step,
                  clear_counts):
    """Phase 14, at the release widths: (a) the parallel-window sampler on
    16 head trajectories of 470 frames (64 stacked windows of 121 tokens,
    then one 16 x 31-token ragged window), DDPM-1000 bf16, exact launch
    counts, beside the chained sampler on the same input; then in f32 with
    DDIM-50 the card's kernels against the CPU's plain versions on the
    same weights and noise. (b) ``eval_egoego --mujoco_xml --save_html_vis
    --headnet_window 256 --fused_step`` on phase 8's sequences, with an XML
    written from the rest offsets: exact counts, qpos_fk's GT card vs CPU,
    every HTML file parsed back. (c) ``run_egoego --export_objs
    --save_html_vis`` on an ARES demo fixture with synthetic SMPL-H models
    at the real sizes: one .obj per frame, exact counts (f32), LBS card vs
    CPU. Returns the summary."""
    import torch

    from egoego_release_tpu_torch.data.formats import load_pickle
    from egoego_release_tpu_torch.eval import eval_egoego, run_egoego
    from egoego_release_tpu_torch.eval import pipeline as pl
    from egoego_release_tpu_torch.eval.build import build_pipeline
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops import geometry, smpl
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise
    from egoego_release_tpu_torch.ops.mujoco_xml import load_mujoco_skeleton, qpos_fk

    dev, t_phase, out = torch.device("cuda"), time.perf_counter(), {"card": card}
    timesteps, window, overlap, n_layers = 1000, 120, 10, 4

    def counts(windows, steps, what, bf16=True, extra=None):
        want = {**(extra or {}), **{k: windows * steps * v for k, v in per_step.items()}}
        want_c = {**({"mha": extra["fused_attention"]} if extra else {}),
                  **{k: windows * steps * v for k, v in c_per_step(bf16).items()}}
        got, got_c = dict(ck.launch_counts), dict(ck.kernel_launches)
        log(f"phase 14: {what}: launches {got} (expected {want}); C entries {got_c} (expected {want_c})")
        if got != want or got_c != want_c:
            raise AssertionError(f"phase 14: {what}: launch counts {got}, {got_c} != {want}, {want_c}")
        return got

    # a. the parallel-window sampler against the chained one, DDPM-1000 bf16
    rng = np.random.RandomState(41)
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, device=dev, compute_dtype="bfloat16")
    motion = [(np.cumsum(rng.randn(PAR_SEQS, PAR_FRAMES, 3) * 0.01, 1) + [0.0, 0.0, 0.9]).astype(np.float32),
              (rng.randn(PAR_SEQS, PAR_FRAMES, 3) * 0.1).astype(np.float32),
              (rng.randn(PAR_SEQS, PAR_FRAMES, 63) * 0.1).astype(np.float32)]
    head = pl.gt_from_smpl_params_batched(pipe, *motion)[2]
    jpos, jquat = head[..., :3].contiguous(), head[..., 3:].contiguous()
    stack_rows = []
    sample_window = pipe.diffusion._sample_window
    pipe.diffusion._sample_window = lambda jp, *a: stack_rows.append(jp.shape[0]) or sample_window(jp, *a)
    runs = {}
    for mode in ("parallel", "chained"):
        sample = (pipe.diffusion.sample_sliding_window_parallel if mode == "parallel"
                  else pipe.diffusion.sample_sliding_window_w_canonical)
        clear_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aa, root = sample(jpos, jquat, pipe.stats, pipe.rest_offsets, noise=TorchNoise(dev, seed=42))
        torch.cuda.synchronize()
        runs[mode] = {"s": time.perf_counter() - t0}
        n_win = 2 if mode == "parallel" else 5  # stack + tail; or 5 chained windows
        runs[mode]["launches"] = counts(n_win, timesteps, f"{mode} sampler, DDPM-{timesteps} bf16, "
                                        f"{PAR_SEQS} x {PAR_FRAMES} frames")
        if aa.shape != (PAR_SEQS, PAR_FRAMES, 22, 3) or root.shape != (PAR_SEQS, PAR_FRAMES, 3):
            raise AssertionError(f"phase 14: {mode} shapes {tuple(aa.shape)}, {tuple(root.shape)}")
        if not (torch.isfinite(aa).all() and torch.isfinite(root).all()):
            raise AssertionError(f"phase 14: {mode} output not finite")
        runs[mode]["s_per_seq"] = runs[mode]["s"] / PAR_SEQS
    pipe.diffusion._sample_window = sample_window
    if stack_rows[:2] != [4 * PAR_SEQS, PAR_SEQS]:
        raise AssertionError(f"phase 14: the parallel sampler's calls had {stack_rows[:2]} rows")
    log(f"phase 14: parallel-window sampler, {PAR_SEQS} x {PAR_FRAMES} frames (64 stacked windows of "
        f"{window + 1} tokens, then {PAR_SEQS} x 31), DDPM-{timesteps} bf16: {runs['parallel']['s']:.2f} s "
        f"({runs['parallel']['s_per_seq']:.4f} s/seq); chained (5 windows): {runs['chained']['s']:.2f} s "
        f"({runs['chained']['s_per_seq']:.4f} s/seq); chained / parallel "
        f"{runs['chained']['s'] / runs['parallel']['s']:.2f} [{card}]")
    out["parallel"], out["chained"] = runs["parallel"], runs["chained"]

    outs = []
    for where in ("cuda", "cpu"):
        p = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, device=where, sampler="ddim",
                           compute_dtype="float32")
        outs.append([o.cpu() for o in p.diffusion.sample_sliding_window_parallel(
            jpos[:2, :250].to(where), jquat[:2, :250].to(where), p.stats, p.rest_offsets,
            noise=TorchNoise("cpu", seed=43))])
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    log(f"phase 14: parallel sampler DDIM-50 f32, 2 x 250 frames (4 stacked windows and a 30-frame tail): "
        f"max|card kernels - CPU plain| = {err:.3e} (bound 1e-3)")
    if not err < 1e-3:
        raise AssertionError(f"phase 14: the parallel sampler's card and CPU chains disagree by {err}")
    out["parallel"]["max_abs_err_card_vs_cpu_f32"] = err

    # b. eval_egoego --mujoco_xml --save_html_vis on phase 8's sequences
    xml = write_humanoid_xml(os.path.join(data_dir, "humanoid.xml"), smpl_rest_to_mujoco(np.load(rest_path)))
    gt = load_pickle(kin_gt_path)
    sks = {w: load_mujoco_skeleton(xml, device=w) for w in ("cuda", "cpu")}
    fk_err = 0.0
    for rec in gt.values():
        fk = [qpos_fk(sk, torch.as_tensor(rec["qpos"], device=w)) for w, sk in sks.items()]
        fk_err = max(fk_err, *(float((a.cpu() - b).abs().max()) for a, b in zip(*fk)))
    log(f"phase 14: qpos_fk of {len(gt)} GT qpos records, card vs CPU: {fk_err:.3e} (bound 1e-5)")
    if not fk_err < 1e-5:
        raise AssertionError(f"phase 14: qpos_fk card and CPU disagree by {fk_err}")
    html_dir = os.path.join(data_dir, "out_mujoco")
    shutil.rmtree(html_dir, ignore_errors=True)
    opt = eval_egoego.parse_opt([
        "--data_root_folder", kin_root, "--full_body_gt_path", kin_gt_path, "--stats_path", stats_path,
        "--rest_offsets", rest_path, "--mujoco_xml", xml, "--save_html_vis", "--headnet_window",
        str(HEADNET_WINDOW_D), "--fused_step", "--out_dir", html_dir, "--device", "cuda"])
    clear_counts()
    t0 = time.perf_counter()
    res = eval_egoego.run(opt)
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    windows = SEQS_D * (1 + math.ceil((FRAMES_D - window) / (window - overlap)))
    counts(windows, timesteps, f"eval_egoego --mujoco_xml --save_html_vis, {SEQS_D} x {FRAMES_D} frames",
           extra={"fused_attention": 2 * SEQS_D})
    entries = res["per_seq"].values()
    if res["num_seqs"] != SEQS_D or not all(math.isfinite(v) for e in entries for v in e.values()):
        raise AssertionError(f"phase 14: bad eval result {res}")
    frames = {}
    for name in res["per_seq"]:
        data = html_data(os.path.join(html_dir, name + ".html"))
        frames[name] = (data["numFrames"], [len(s["frames"]) for s in data["skeletons"]])
        if data["numFrames"] != FRAMES_D or frames[name][1] != [FRAMES_D, FRAMES_D]:
            raise AssertionError(f"phase 14: {name}.html has {frames[name]} frames, want {FRAMES_D}")
    log(f"phase 14: eval_egoego --mujoco_xml --save_html_vis in {dt_eval:.2f} s ({dt_eval / SEQS_D:.3f} s/seq): "
        f"mpjpe {res['mean']['mpjpe']:.1f} mm (random weights); HTML frames {frames} [{card}]")
    out["eval_egoego_mujoco"] = {"s": dt_eval, "mpjpe": res["mean"]["mpjpe"], "qpos_fk_card_vs_cpu": fk_err}

    # c. run_egoego --export_objs --save_html_vis, SMPL-H at the real sizes
    demo_root, smplh_dir = os.path.join(data_dir, "ares_demo"), os.path.join(data_dir, "smplh")
    names = write_ares_demo_fixture(demo_root, np.random.RandomState(44), 1, DEMO_FRAMES)
    write_smplh_models(smplh_dir, np.random.RandomState(45))
    demo_out = os.path.join(data_dir, "out_demo")
    shutil.rmtree(demo_out, ignore_errors=True)
    opt = run_egoego.parse_opt([
        "--data_root_folder", demo_root, "--stats_path", stats_path, "--rest_offsets", rest_path,
        "--smplh_path", smplh_dir, "--export_objs", "--save_html_vis", "--out_dir", demo_out, "--device", "cuda"])
    export_s = []
    export = run_egoego.export_obj_sequence

    def timed_export(*a, **k):
        t0 = time.perf_counter()
        paths = export(*a, **k)
        export_s.append(time.perf_counter() - t0)
        return paths

    run_egoego.export_obj_sequence = timed_export
    clear_counts()
    t0 = time.perf_counter()
    written = run_egoego.run(opt)
    dt_demo = time.perf_counter() - t0
    run_egoego.export_obj_sequence = export
    n_frames = DEMO_FRAMES + 1
    demo_windows = 1 + math.ceil((n_frames - window) / (window - overlap))
    counts(demo_windows, timesteps, f"run_egoego --export_objs --save_html_vis, {n_frames} frames, f32", bf16=False)
    objs = sorted(os.listdir(os.path.join(demo_out, names[0] + "_objs")))
    if objs != [f"{i:05d}.obj" for i in range(n_frames)] or len(written) != 1:
        raise AssertionError(f"phase 14: run_egoego wrote {len(objs)} .obj files and {written}")
    if html_data(os.path.join(demo_out, names[0] + ".html"))["numFrames"] != n_frames:
        raise AssertionError("phase 14: the demo's HTML has the wrong frame count")
    pred = np.load(written[0])
    full_aa = np.zeros((32, 52, 3), np.float32)
    full_aa[:, :22] = pred["local_aa"][:32]
    v_card, v_cpu = (smpl.lbs(smpl.load_smpl_npz(os.path.join(smplh_dir, "male", "model.npz"), device=w),
                              np.zeros((32, 16), np.float32), full_aa, pred["root_pos"][:32])[1].cpu()
                     for w in ("cuda", "cpu"))
    lbs_err = float((v_card - v_cpu).abs().max())
    v_obj = np.loadtxt(os.path.join(demo_out, names[0] + "_objs", "00000.obj"), usecols=(1, 2, 3),
                       max_rows=v_cpu.shape[1])
    obj_err = float(np.abs(v_obj - v_cpu[0].numpy()).max())
    log(f"phase 14: run_egoego --export_objs --save_html_vis, {n_frames} frames (SMPL-H 6890 vertices, 13776 "
        f"faces, 52 joints) in {dt_demo:.2f} s, of which the .obj export {export_s[0]:.2f} s; LBS of 32 frames "
        f"card vs CPU {lbs_err:.3e} (bound 1e-4); frame 0's .obj vs CPU LBS {obj_err:.3e} [{card}]")
    if not (lbs_err < 1e-4 and obj_err < 1e-4):
        raise AssertionError(f"phase 14: LBS card vs CPU {lbs_err}, .obj vs CPU {obj_err}")
    out["run_egoego_outputs"] = {"s": dt_demo, "export_s": export_s[0], "frames": n_frames,
                                 "lbs_card_vs_cpu": lbs_err, "obj_vs_cpu": obj_err}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 took {out['seconds']:.1f} s [{card}]")
    ck.launch_counts.clear()
    return out


TP_TOKENS = (121, 31)        # phase 15: tokens a window of the kernels' tp shapes (the release window, the tail)
PAR_SEQS, PAR_DDIM = 16, 50   # phase 15: sequences and DDIM steps of the sharded eval_stage2 runs
TRAIN_WINDOWS = 16            # phase 15: windows of the sharded training step (micro-batch 8 x grad-accum 2)
E2E_B, E2E_T = 4, 16          # phase 15: export_e2e's batch and frames
SERVE_B, SERVE_T = 64, 140    # phase 15: the export CLI's default batch and frames


def _par_eval_rank(mesh, argv, head_path, out_prefix):
    """One rank of phase 15's sharded eval_stage2 run: the CLI through the
    library on this rank's mesh, then the chain itself on phase 15's head
    poses; writes the rank's launch counts, and rank 0 the chain's output."""
    import torch

    from egoego_release_tpu_torch.eval import eval_stage2
    from egoego_release_tpu_torch.eval.build import build_pipeline
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise

    opt = eval_stage2.parse_opt(argv)
    for c in (ck.launch_counts, ck.kernel_launches, ck.gemm_modes):
        c.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eval_stage2.run(opt, mesh=mesh)
    torch.cuda.synchronize()
    counts = {"seconds": time.perf_counter() - t0, "launch": dict(ck.launch_counts),
              "c": dict(ck.kernel_launches), "modes": {str(k): v for k, v in ck.gemm_modes.items()},
              "mpjpe": res["mean"]["mpjpe"], "per_seq": res["per_seq"]}
    with open(f"{out_prefix}_rank{mesh.rank}.json", "w") as f:
        json.dump(counts, f)
    pipe = build_pipeline(stats_path=opt.stats_path, rest_offsets_path=opt.rest_offsets, window=opt.window,
                          sampler="ddim", ddim_steps=opt.ddim_steps, timesteps=opt.timesteps, seed=opt.seed,
                          compute_dtype=eval_stage2.compute_dtype(opt), device=mesh.device).shard(mesh)
    head = np.load(head_path)
    aa, root = pipe.stage2_generate_batched(head, TorchNoise(mesh.device, seed=5))
    x = reverse_chain(pipe, head, mesh.device)
    if mesh.rank == 0:
        np.savez(f"{out_prefix}_chain.npz", aa=aa.cpu().numpy(), root=root.cpu().numpy(), x=x.cpu().numpy())


def reverse_chain(pipe, head, dev):
    """Phase 15's reverse chain alone: DDIM on the canonicalized first
    window of the head poses (the whole batch on every rank)."""
    import torch

    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import head_condition_mask
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise

    d = pipe.diffusion
    hp = torch.as_tensor(head, device=dev)
    x_start, _ = d._canonicalize_window(hp[..., :3].contiguous(), hp[..., 3:].contiguous(), pipe.stats)
    return d.p_sample_loop_ddim(x_start, head_condition_mask(*x_start.shape[:2], device=dev),
                                num_steps=d.cfg.ddim_steps, noise=TorchNoise(dev, seed=6))


def _par_train_rank(mesh, batch_path, ckpt_dir, out_path):
    """One rank of phase 15's sharded training step at the release widths;
    the gathered checkpoint, and rank 0 the loss and the gathered
    gradients."""
    import torch

    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise
    from egoego_release_tpu_torch.parallel.mesh import gather_state_dict
    from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer, save_checkpoint

    batch = dict(np.load(batch_path))
    trainer = DiffusionTrainer(CondGaussianDiffusion(DiffusionConfig(), device=mesh.device), mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, loss = trainer.train_step(state, batch, TorchNoise(mesh.device, 3))
    path = save_checkpoint(ckpt_dir, state)
    grads = gather_state_dict({n: p.grad for n, p in state.model.named_parameters()}, mesh, state.model.full_shapes)
    if mesh.rank == 0:
        torch.save({"loss": float(loss), "ckpt": path, "grads": grads}, out_path)


def parallel_phase(card, data_dir, data_path, stats_path, rest_path, clear_counts):
    """Phase 15: multi-GPU and serving, on the one card.
    (a) The tensor-parallel layer's own launches at the tp shapes (64
    windows of 121 and 31 tokens, tp 2 and 4): the PARTIAL GEMM of fc and w2
    (bf16 on gemm_wgmma_kernel, f32 on the CUDA cores) and
    residual_layernorm (f32 or bf16 residual; f32 and bf16 outputs), each
    against its plain version, counted once, timed beside its bound and
    the library call; each custom op through torch.ops bit for bit against
    its ctypes wrapper. (b) Two gloo ranks on cuda:0 running eval_stage2
    through the library (16 sequences, DDIM-50): dp 2 --fused_step, tp 2 in
    f32 and --fused_step, each rank's exact launch counts (no LayerNorm
    epilogue under tp), and the chain on fixed head poses against the
    unsharded card run. (c) One training step at dp 2 x tp 1 and dp 1 x tp
    2 against the unsharded card step. (d) The chain exported by the
    export CLI at its defaults (64 x 140 frames, DDPM-1000, f32) and
    export_e2e (4 x 16 frames, DDIM-50, bf16), each saved, loaded and
    called on the card against the live run for one seed, with the kernels
    launched inside the loaded program counted; export, load and call
    seconds and bytes. Returns the summary."""
    import torch
    import torch.nn.functional as F

    from egoego_release_tpu_torch.eval import eval_stage2
    from egoego_release_tpu_torch.eval.build import build_pipeline
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops import rotations as rot
    from egoego_release_tpu_torch.ops.fused_step import DefaultNoise, TorchNoise
    from egoego_release_tpu_torch.parallel import mesh as pm
    from egoego_release_tpu_torch.serving import export as sx
    from egoego_release_tpu_torch.training.trainer_diffusion import load_checkpoint

    dev, t_phase, out = torch.device("cuda"), time.perf_counter(), {"card": card}
    g = torch.Generator(device=dev).manual_seed(15)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    dm = 512

    def once(fn, want_c, what):
        clear_counts()
        ck.gemm_modes.clear()
        r = fn()
        torch.cuda.synchronize()
        if dict(ck.kernel_launches) != want_c:
            raise AssertionError(f"phase 15: {what} launched {dict(ck.kernel_launches)}, want {want_c}")
        return r

    # -- a. the tp layer's launches against their plain versions ----------
    kern = {"partial": {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "rows": []},
            "residual_layernorm": {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "rows": []}}
    for t in TP_TOKENS:
        m = BATCH * t
        for tp in (2, 4):
            for name, k in (("fc", 4 * 256 // tp), ("w2", dm // tp)):
                for bf16 in (False, True):
                    wdt = torch.bfloat16 if bf16 else torch.float32
                    a, w = rn(m, k).to(wdt), (rn(dm, k) / k ** 0.5).to(wdt)
                    wk = w if bf16 else ck.split_tf32(w)  # the operand of the f32 route's 3xTF32 kernel
                    bias, o = rn(dm), torch.empty(m, dm, device=dev)
                    run = lambda: ck.gemm(ck.PARTIAL, a, wk, bias, o, M=m)
                    once(run, {"gemm_wgmma" if bf16 else "gemm_tf32x3": 1}, f"PARTIAL {name}")
                    if dict(ck.gemm_modes) != {ck.PARTIAL: 1}:
                        raise AssertionError(f"phase 15: PARTIAL counted as {dict(ck.gemm_modes)}")
                    want = ck.gemm_plain(ck.PARTIAL, a, wk, bias, torch.empty_like(o), M=m)
                    err = float((o - want).abs().max())
                    tol = TOL_BF16 if bf16 else TOL_F32
                    if not err <= tol:
                        raise AssertionError(f"phase 15: PARTIAL {name} {m}x{k} bf16={bf16}: {err} > {tol}")
                    ms = device_time_ms(run)[0]
                    lib_ms = device_time_ms(lambda: torch.matmul(a, w.t()))[0]
                    plain_ms = cuda_time_ms(lambda: ck.gemm_plain(ck.PARTIAL, a, wk, bias, o, M=m))
                    es = 2 if bf16 else 4
                    mbytes = (m * k * es + dm * k * es + m * dm * 4) / 1e6
                    gflop = 2 * m * k * dm / 1e9
                    # f32: three TF32 products per product; beside it the f32 CUDA cores' bound
                    bound_b = mbytes * 1e6 / HBM_BYTES_S * 1e3
                    bound_o = gflop * 1e9 * (1 / PEAK_BF16 if bf16 else 3 / PEAK_TF32) * 1e3
                    row = {"what": f"{name} tp{tp} {BATCH}x{t}", "bf16": bf16, "mkn": (m, k, dm), "device_ms": ms,
                           "library_device_ms": lib_ms, "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
                           "bound_by": "bytes" if bound_b >= bound_o else "operations", "max_abs_err": err,
                           "gflop": gflop, "mbytes": mbytes}
                    if not bf16:  # the CUDA-core kernel the f32 route ran before
                        o_old = torch.empty_like(o)
                        row["cores_device_ms"] = device_time_ms(lambda: ck.gemm_cuda_cores(ck.PARTIAL, a, w, bias,
                                                                                            o_old, M=m))[0]
                        row["bound_f32_core_ms"] = max(bound_b, gflop * 1e9 / PEAK_F32 * 1e3)
                    kern["partial"]["rows"].append(row)
                    key = "max_abs_err" if bf16 else "max_abs_err_f32"
                    kern["partial"][key] = max(kern["partial"][key], err)
                    f32_more = ("" if bf16 else f", the CUDA-core kernel {row['cores_device_ms']:.4f} ms, f32-core "
                                f"bound {row['bound_f32_core_ms']:.4f} ms")
                    log(f"phase 15: PARTIAL {row['what']} {'bf16' if bf16 else 'f32'} (M, K, N) = {(m, k, dm)}: "
                        f"max|kernel - plain| {err:.3e} (bound {tol}); device {ms:.4f} ms, torch.matmul "
                        f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}){f32_more} [{card}]")
        # residual_layernorm: fc's (f32 or bf16 residual, f32 out and its bf16 copy) and w2's with
        # bf16 activations (the bf16 output alone)
        for res_bf16, f32_out in ((False, True), (True, True), (False, False)):
            p, bias = rn(m, dm), rn(dm)
            res = rn(m, dm).to(torch.bfloat16 if res_bf16 else torch.float32)
            s_, b_, mask = 1 + 0.1 * rn(dm), 0.1 * rn(dm), (rn(m) > -2).float()
            o = torch.empty(m, dm, device=dev) if f32_out else None
            ob = torch.empty(m, dm, dtype=torch.bfloat16, device=dev)
            run = lambda: ck.residual_layernorm(p, bias, res, s_, b_, mask, o, ob)
            once(run, {"residual_layernorm": 1}, "residual_layernorm")
            want = ck.residual_layernorm_plain(p, bias, res, s_, b_, mask)
            err = float((o - want).abs().max()) if f32_out else 0.0
            ok, _ = bf16_flips(ob, want, TOL_F32)
            flips = int((ob != want.to(torch.bfloat16)).sum())  # roundings that fell the other way
            if not (err <= TOL_F32 and ok and (o is None or torch.equal(ob, o.to(torch.bfloat16)))):
                raise AssertionError(f"phase 15: residual_layernorm res_bf16={res_bf16}: {err}, bf16 ok {ok}")
            y = (p + bias) + res.float()
            ms = device_time_ms(run)[0]
            lib_ms = device_time_ms(lambda: F.layer_norm(y, (dm,), s_, b_, 1e-5))[0]
            plain_ms = cuda_time_ms(lambda: ck.residual_layernorm_plain(p, bias, res, s_, b_, mask))
            mbytes = (m * dm * (4 + (2 if res_bf16 else 4) + (4 if f32_out else 0) + 2) + m * 4 + 3 * dm * 4) / 1e6
            gflop = 10 * m * dm / 1e9
            bound_b, bound_o = mbytes * 1e6 / HBM_BYTES_S * 1e3, gflop * 1e9 / PEAK_F32 * 1e3
            row = {"what": f"{BATCH}x{t} res {'bf16' if res_bf16 else 'f32'}, out {'f32+bf16' if f32_out else 'bf16'}",
                   "device_ms": ms, "library_device_ms": lib_ms, "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
                   "bound_by": "bytes" if bound_b >= bound_o else "operations", "max_abs_err": err,
                   "bf16_flips": flips, "gflop": gflop, "mbytes": mbytes}
            kern["residual_layernorm"]["rows"].append(row)
            kern["residual_layernorm"]["max_abs_err_f32"] = max(kern["residual_layernorm"]["max_abs_err_f32"], err)
            kern["residual_layernorm"]["max_abs_err"] = max(
                kern["residual_layernorm"]["max_abs_err"], float((ob.float() - want).abs().max()))
            log(f"phase 15: residual_layernorm {row['what']}: max|f32 out - plain| {err:.3e} (bound {TOL_F32}), "
                f"bf16 out within it plus one bf16 ulp ({flips} of {ob.numel()} entries one rounding off bf16(plain)); "
                f"device {ms:.4f} ms, "
                f"F.layer_norm on the sum {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")

    # each custom op through torch.ops, bit for bit against its ctypes wrapper
    a, w, bias = rn(256, 512).to(torch.bfloat16), (rn(512, 512) / 22.6).to(torch.bfloat16), rn(512)
    res, s_, b_, mask = rn(256, 512), 1 + 0.1 * rn(512), 0.1 * rn(512), torch.ones(256, device=dev)
    qkv = rn(2 * 121, 4 * 768).to(torch.bfloat16)
    q, k_, v = (rn(2, 4, 256, 256) for _ in range(3))
    a32, w32, qkv32 = a.float(), ck.split_tf32(w.float()), qkv.float()
    pairs = {
        "gemm f32 LAYER_NORM": lambda o, ob, op: (
            torch.ops.egoego.gemm(a32, w32, bias, o, ck.LAYER_NORM, 256, None, res, s_, b_, mask, None, None, None,
                                  None, None, None, None, 0, None) if op else
            ck.gemm(ck.LAYER_NORM, a32, w32, bias, o, M=256, res=res, ln_s=s_, ln_b=b_, row_mask=mask)),
        "attention f32": lambda o, ob, op: (torch.ops.egoego.attention(qkv32, o32, 2, 121, 121, 4, 256, 256) if op else
                                            ck.attention(qkv32, o32, B=2, T=121, t_keys=121, n_head=4, d_k=256,
                                                         d_v=256)),
        "gemm LAYER_NORM": lambda o, ob, op: (torch.ops.egoego.gemm(a, w, bias, o, ck.LAYER_NORM, 256, None, res, s_, b_,
                                                                    mask, None, None, None, None, None, None, ob, 0,
                                                                    None) if op else
                                              ck.gemm(ck.LAYER_NORM, a, w, bias, o, M=256, res=res, ln_s=s_, ln_b=b_,
                                                      row_mask=mask, out_b=ob)),
        "gemm PARTIAL": lambda o, ob, op: (torch.ops.egoego.gemm(a, w, bias, o, ck.PARTIAL, 256, None, None, None, None,
                                                                 None, None, None, None, None, None, None, None, 0,
                                                                 None) if op else
                                           ck.gemm(ck.PARTIAL, a, w, bias, o, M=256)),
        "attention": lambda o, ob, op: (torch.ops.egoego.attention(qkv, ob2, 2, 121, 121, 4, 256, 256) if op else
                                        ck.attention(qkv, ob2, B=2, T=121, t_keys=121, n_head=4, d_k=256, d_v=256)),
        "mha": lambda o, ob, op: (torch.ops.egoego.mha(q, k_, v, o4, 256) if op else ck.mha(q, k_, v, o4, t_keys=256)),
        "residual_layernorm": lambda o, ob, op: (torch.ops.egoego.residual_layernorm(res, bias, res, s_, b_, mask, o, ob)
                                                 if op else ck.residual_layernorm(res, bias, res, s_, b_, mask, o, ob)),
    }
    op_same = {}
    for name, call in pairs.items():
        got = []
        for op in (False, True):
            o, ob = torch.zeros(256, 512, device=dev), torch.zeros(256, 512, dtype=torch.bfloat16, device=dev)
            ob2 = torch.zeros(2 * 121, 1024, dtype=torch.bfloat16, device=dev)
            o4 = torch.zeros(2, 4, 256, 256, device=dev)
            o32 = torch.zeros(2 * 121, 1024, device=dev)
            clear_counts()
            call(o, ob, op)
            torch.cuda.synchronize()
            got.append(([t.clone() for t in (o, ob, ob2, o4, o32)], dict(ck.kernel_launches)))
        same = all(torch.equal(x, y) for x, y in zip(got[0][0], got[1][0]))
        op_same[name] = same and got[0][1] == got[1][1]
        if not op_same[name]:
            raise AssertionError(f"phase 15: torch.ops.egoego {name} differs from its ctypes wrapper: {got[0][1]}, "
                                 f"{got[1][1]}")
    log(f"phase 15: custom ops through torch.ops, bit for bit and counted as their ctypes wrappers: {op_same}")
    out["kernels"] = kern

    # -- b. two gloo ranks on cuda:0: eval_stage2 through the library -----
    par_dir = os.path.join(data_dir, "parallel")
    os.makedirs(par_dir, exist_ok=True)
    rng = np.random.RandomState(15)
    head = np.concatenate([np.cumsum(rng.randn(PAR_SEQS, 120, 3) * 0.01, 1) + [0.0, 0.0, 1.6],
                           smooth_quats(rng, PAR_SEQS * 120).reshape(PAR_SEQS, 120, 4)], -1).astype(np.float32)
    head_path = os.path.join(par_dir, "head.npy")
    np.save(head_path, head)
    base = ["--test_data_path", data_path, "--stats_path", stats_path, "--rest_offsets", rest_path,
            "--ddim_steps", str(PAR_DDIM), "--batch_seqs", str(PAR_SEQS), "--max_seqs", str(PAR_SEQS),
            "--device", "cuda"]
    refs, runs = {}, {}
    for flags in ([], ["--fused_step"]):
        opt = eval_stage2.parse_opt(base + flags + ["--out_dir", os.path.join(par_dir, "ref")])
        pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, sampler="ddim",
                              ddim_steps=PAR_DDIM, compute_dtype=eval_stage2.compute_dtype(opt), device=dev)
        aa, root = pipe.stage2_generate_batched(head, TorchNoise(dev, seed=5))
        refs[tuple(flags)] = {"aa": aa.cpu().numpy(), "root": root.cpu().numpy(),
                              "x": reverse_chain(pipe, head, dev).cpu().numpy(), "eval": eval_stage2.run(opt)["per_seq"]}
    steps, n_layers = PAR_DDIM, 4
    for dp, tp, flags in ((2, 1, ["--fused_step"]), (1, 2, []), (1, 2, ["--fused_step"])):
        what = f"dp {dp} x tp {tp} {'bf16' if flags else 'f32'}"
        prefix = os.path.join(par_dir, f"eval_dp{dp}_tp{tp}_{'bf16' if flags else 'f32'}")
        argv = base + flags + ["--dp", str(dp), "--tp", str(tp), "--out_dir", prefix + "_out"]
        t0 = time.perf_counter()
        pm.spawn(_par_eval_rank, (argv, head_path, prefix), dp, tp, ["cuda:0"] * (dp * tp))
        wall = time.perf_counter() - t0
        bf16 = bool(flags)
        g_name, a_name = ("gemm_wgmma", "attention_wgmma") if bf16 else ("gemm_tf32x3", "mha")
        want_l = {"stem_layer": steps, "decoder_layer": steps * (n_layers - 2), "layer_epilogue": steps}
        want_c = {g_name: steps * (4 * n_layers + 2), a_name: steps * n_layers}
        want_m = {str(ck.BIAS): steps * n_layers, str(ck.BIAS_RELU): steps * n_layers, str(ck.STEM): steps,
                  str(ck.STEP): steps}
        if tp > 1:
            want_c["residual_layernorm"] = steps * 2 * n_layers
            want_m[str(ck.PARTIAL)] = steps * 2 * n_layers
        else:
            want_m[str(ck.LAYER_NORM)] = steps * 2 * n_layers
        ranks = []
        for r in range(dp * tp):
            with open(f"{prefix}_rank{r}.json") as f:
                ranks.append(json.load(f))
            got = (ranks[-1]["launch"], ranks[-1]["c"], ranks[-1]["modes"])
            log(f"phase 15: {what} rank {r}: launches {got[0]}, C entries {got[1]}, GEMM modes {got[2]}")
            if got != (want_l, want_c, want_m):
                raise AssertionError(f"phase 15: {what} rank {r}: counts {got} != {(want_l, want_c, want_m)}")
        chain = np.load(f"{prefix}_chain.npz")
        ref = refs[tuple(flags)]
        # axis-angle flips representation at angle ~ pi under any rounding: compare rotation matrices
        mats = lambda aa: rot.axis_angle_to_matrix(torch.from_numpy(aa)).numpy()
        err_aa = float(np.abs(mats(chain["aa"]) - mats(ref["aa"])).max())
        err_root = float(np.abs(chain["root"] - ref["root"]).max())
        err_x = float(np.abs(chain["x"] - ref["x"]).max())
        err_m = max(abs(ranks[0]["per_seq"][n][k] - v) for n, e in ref["eval"].items() for k, v in e.items())
        # dp: each row is the unsharded run's (the step kernels compute rows apart); tp in f32: JAX's
        # bound for its tp-sharded chain; tp in bf16: a bf16 rounding of h0 or h1 flips where tp sums
        # the product in another order, so the reverse chain is held to JAX's bf16 drift bound (0.08)
        bound, x_bound = (0.0, 0.0) if dp > 1 else (2e-3, 2e-3) if not bf16 else (None, 0.08)
        log(f"phase 15: eval_stage2 {what}, 2 gloo ranks on cuda:0, {PAR_SEQS} seqs DDIM-{PAR_DDIM}: {wall:.1f} s "
            f"wall (rank 0's run {ranks[0]['seconds']:.2f} s); against the unsharded card run: the reverse chain "
            f"alone {err_x:.3e} (bound {x_bound}); the decoded chain on {PAR_SEQS} head poses: rotation matrices "
            f"{err_aa:.3e}, root {err_root:.3e} (bound {bound if bound is not None else 'none: bf16 tp'}); the CLI's "
            f"metrics {err_m:.3e} [{card}]")
        if not (err_x <= x_bound and (bound is None or (err_aa <= bound and err_root <= bound))):
            raise AssertionError(f"phase 15: {what} disagrees with the unsharded run: {err_x}, {err_aa}, {err_root}")
        runs[what] = {"wall_s": wall, "rank0_s": ranks[0]["seconds"], "err_x": err_x, "err_aa": err_aa,
                      "err_root": err_root,
                      "err_metrics": err_m, "counts_rank0": ranks[0]["c"],
                      "partial_launches": ranks[0]["modes"].get(str(ck.PARTIAL), 0)}
    out["eval"] = runs

    # -- c. one training step, sharded against unsharded ------------------
    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
    from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer, save_checkpoint

    motion = np.clip(np.cumsum(rng.randn(TRAIN_WINDOWS, 120, 198) * 0.02, 1), -1, 1).astype(np.float32)
    batch = {"motion": motion, "seq_len": np.array([120] * (TRAIN_WINDOWS - 2) + [90, 60], np.int32)}
    batch_path = os.path.join(par_dir, "batch.npz")
    np.savez(batch_path, **batch)
    trainer = DiffusionTrainer(CondGaussianDiffusion(DiffusionConfig(), device=dev))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, loss = trainer.train_step(state, batch, TorchNoise(dev, 3))
    g_ref = {n: p.grad.detach().cpu().double() for n, p in state.model.named_parameters()}
    ref = load_checkpoint(save_checkpoint(os.path.join(par_dir, "train_ref"), state))
    out["train"] = {}
    for dp, tp in ((2, 1), (1, 2)):
        res_path = os.path.join(par_dir, f"train_dp{dp}_tp{tp}.pt")
        pm.spawn(_par_train_rank, (batch_path, os.path.join(par_dir, f"train_dp{dp}_tp{tp}"), res_path), dp, tp,
                 ["cuda:0"] * (dp * tp))
        got = torch.load(res_path)
        ck_s = load_checkpoint(got["ckpt"])
        err_loss = abs(got["loss"] - float(loss)) / abs(float(loss))
        # as train_step_agreement holds two free runs (no branch replayed across the ranks): the
        # gradients' relative L2 over all tensors and in the worst one; the parameters where |g| is
        # large (a ReLU input within rounding of 0 may take the other branch where tp sums in
        # another order, which moves a gradient row and flips Adam's first step there)
        num = den = err_l2 = err_p = 0.0
        for name, g_r in g_ref.items():
            g_s = got["grads"][name].double()
            if not name.endswith("self_attn.w_k.bias"):  # its gradient is rounding noise (the softmax cancels it)
                num, den = num + float((g_s - g_r).norm()) ** 2, den + float(g_r.norm()) ** 2
                err_l2 = max(err_l2, float((g_s - g_r).norm() / g_r.norm()))
            p_r, p_s = (c["model"]["denoise_fn." + name].double() for c in (ref, ck_s))
            big = (g_r.abs() >= 1e-3 * float(g_r.abs().max())) & (g_r.abs() >= 1e-6)
            if big.any() and not name.endswith("self_attn.w_k.bias"):
                err_p = max(err_p, float((p_s - p_r)[big].abs().max()) / float(p_r.abs().max()))
        err_l2_all = math.sqrt(num / den)
        log(f"phase 15: one training step at dp {dp} x tp {tp} (2 gloo ranks on cuda:0, release widths, "
            f"{TRAIN_WINDOWS} windows, dropout on) against the unsharded card step: loss {err_loss:.3e} relative "
            f"[{STEP_BOUNDS['loss']}]; gradients {err_l2_all:.3e} relative L2 over all tensors "
            f"[{STEP_BOUNDS['grad_l2_all']}], {err_l2:.3e} in the worst tensor [{STEP_BOUNDS['grad_l2']}]; "
            f"parameters {err_p:.3e} of max|p| where |g| >= 1e-3 max|g| (not bounded: a branch flip moves it)")
        if not (err_loss <= STEP_BOUNDS["loss"] and err_l2_all <= STEP_BOUNDS["grad_l2_all"]
                and err_l2 <= STEP_BOUNDS["grad_l2"]):
            raise AssertionError(f"phase 15: the dp {dp} x tp {tp} step disagrees: {err_loss}, {err_l2_all}, {err_l2}")
        out["train"][f"dp{dp}_tp{tp}"] = {"loss": err_loss, "grad_l2_all": err_l2_all, "grad_l2": err_l2,
                                          "param": err_p}

    # -- d. serving artifacts on the card ----------------------------------
    exports = {}

    def artifact(name, export, inputs, live, c_want):
        """export() -> (program, its path, seconds to build, export and save);
        load it, call it for seed 11 against live() for the same seed, count
        the launches inside it."""
        prog, path, t_export = export()
        t0 = time.perf_counter()
        loaded = sx.load_artifact(path)
        t_load = time.perf_counter() - t0
        clear_counts()
        t0 = time.perf_counter()
        got = sx.call_artifact(loaded, 11, *inputs)
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
        c_got = dict(ck.kernel_launches)
        torch.manual_seed(11)
        t0 = time.perf_counter()
        want = live(*inputs)
        torch.cuda.synchronize()
        t_live = time.perf_counter() - t0
        err = max(float((a_ - b_).abs().max()) for a_, b_ in zip(got, want))
        nodes = sum(1 for gm in loaded.graph_module.modules() for n in gm.graph.nodes
                    if n.op == "call_function" and "egoego" in str(n.target))
        r = {"export_s": t_export, "load_s": t_load, "call_s": t_call, "live_s": t_live, "bytes": os.path.getsize(path),
             "max_abs_err": err, "launches": c_got, "egoego_nodes": nodes}
        log(f"phase 15: {name}: exported and saved in {t_export:.1f} s, {r['bytes']} bytes, loaded in {t_load:.1f} s, "
            f"called in {t_call:.2f} s (the live run {t_live:.2f} s); against the live run for seed 11: {err:.3e} "
            f"(bound 2e-5); kernels launched "
            f"inside the loaded program {c_got} (expected {c_want}); torch.ops.egoego nodes {nodes} [{card}]")
        if not (err <= 2e-5 and c_got == c_want and nodes > 0):
            raise AssertionError(f"phase 15: {name} artifact: err {err}, launches {c_got} != {c_want}, {nodes} nodes")
        exports[name] = r

    def saved(name, make):
        t0 = time.perf_counter()
        path = os.path.join(par_dir, f"{name}.pt2")
        prog = make(path)
        if not os.path.exists(path):
            sx.save_artifact(prog, path)
        return prog, path, time.perf_counter() - t0

    # the chain at the export CLI's defaults (64 x 140 frames: two windows of DDPM-1000, f32), made by the
    # CLI itself, against the live chain of the pipeline the CLI builds (the same seed-0 weights)
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, device=dev)
    rng_s = np.random.RandomState(16)
    jpos = torch.as_tensor(np.cumsum(rng_s.randn(SERVE_B, SERVE_T, 3) * 0.01, 1) + [0.0, 0.0, 1.6],
                           dtype=torch.float32, device=dev)
    jquat = torch.as_tensor(smooth_quats(rng_s, SERVE_B * SERVE_T).reshape(SERVE_B, SERVE_T, 4), device=dev)
    per_step = lambda g_name, a_name: {g_name: 4 * 4 + 2, a_name: 4}
    artifact("chain_b64_t140", lambda: saved("chain_b64_t140", lambda path: sx.main([
        "chain", "--stats_path", stats_path, "--rest_offsets", rest_path, "--out", path, "--device", "cuda"])),
             (jpos, jquat), lambda jp, jq: pipe.diffusion.sample_sliding_window_w_canonical(
                 jp, jq, pipe.stats, pipe.rest_offsets, noise=DefaultNoise(dev)),
             {k: 2 * 1000 * v for k, v in per_step("gemm_tf32x3", "mha").items()})
    # the whole system, bf16 (--fused_step's numerics), DDIM-50, one window
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, sampler="ddim", ddim_steps=PAR_DDIM,
                          compute_dtype="bfloat16", device=dev)
    s1 = {"of": rn(E2E_B, E2E_T - 1, 512), "init_quat": F.normalize(rn(E2E_B, 4), dim=-1),
          "aligned": jpos[:E2E_B, :E2E_T].clone(), "ori_trans": jpos[:E2E_B, :E2E_T].clone(),
          "ori_mat": torch.eye(3, device=dev).expand(E2E_B, E2E_T, 3, 3).contiguous(),
          "gt": torch.cat([jpos[:E2E_B, :E2E_T], jquat[:E2E_B, :E2E_T]], -1)}

    def e2e_live(*inputs):
        r = pipe._stage1(*inputs)
        hp = r["head_pose"]
        aa, root = pipe.diffusion.sample_sliding_window_w_canonical(
            hp[..., :3].contiguous(), hp[..., 3:].contiguous(), pipe.stats, pipe.rest_offsets, noise=DefaultNoise(dev))
        return (aa, root, *pipe.fk(root, aa), hp, r["pred_scale"])
    artifact("e2e", lambda: saved("e2e", lambda path: sx.export_e2e(pipe, E2E_B, E2E_T)), tuple(s1.values()),
             e2e_live, {k: PAR_DDIM * v for k, v in per_step("gemm_wgmma", "attention_wgmma").items()})
    out["exports"] = exports
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 took {out['seconds']:.1f} s [{card}]")
    return out


def html_data(path):
    """The ``const DATA = {...};`` object of a vis/html_viewer page."""
    with open(path) as f:
        return json.loads(re.search(r"const DATA = (\{.*?\});\n", f.read(), re.S).group(1))


ACT_WRAPPERS = ("stem_layer", "decoder_layer", "layer_epilogue")


def bf16_flips(got, want, tol, max_share=1.0):
    """(ok, flips) for a bf16 output: each entry within tol plus one bf16
    ulp (2^-7 of its magnitude) of want, the ulp that rounding both sides
    to bf16 may add to a difference of tol, and at most ``max_share`` of
    the entries past tol (flips: the count past tol)."""
    diff = (got.float() - want.float()).abs()
    far = diff > tol
    ok = bool((diff <= tol + 2.0 ** -7 * want.float().abs()).all()) and float(far.float().mean()) <= max_share
    return ok, int(far.sum())


def act_bf16_phase(card, head, stats_path, rest_path, check_counts, clear_counts):
    """Phase 12: the step kernels with bf16 inter-layer activations
    (``act_bf16``, ``DiffusionConfig.fused_step_act_bf16``) at the release
    widths: each wrapper against its plain version at 64 windows of 121
    and 31 tokens, in bf16 and in f32 compute; the LayerNorm launches with
    a bf16 residual and a bf16 output alone against their f32 forms (bit
    for bit on equal inputs) and their device ms; the step's and each
    wrapper's device ms in both modes; the two-window DDPM-1000 chain
    (64 x 140 frames) with and without the flag, exact launch counts, and
    its drift against JAX's bound. Returns the summary."""
    import torch

    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion
    from egoego_release_tpu_torch.eval.build import build_pipeline
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops import fused_layer as fl
    from egoego_release_tpu_torch.ops import fused_step as fs

    dev = torch.device("cuda")
    bf = torch.bfloat16
    t_phase = time.perf_counter()
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, device=dev, compute_dtype="bfloat16")
    cfg, model = pipe.diffusion.cfg, pipe.diffusion.model
    prep = {b: fs.prepare_step_params(model, b) for b in (False, True)}
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    nh, dk, dv, dm, d = cfg.n_head, cfg.d_k, cfg.d_v, cfg.d_model, cfg.d_feats
    g = torch.Generator(device=dev).manual_seed(12)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = {name: {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "flips_f32": 0} for name in ACT_WRAPPERS}

    def c_launches(name, bf16):
        n_gemm = 4 if name == "decoder_layer" else 5
        return {"gemm_wgmma": n_gemm, "attention_wgmma": 1} if bf16 else {"gemm_tf32x3": n_gemm, "mha": 1}

    def bound(name, t, act_bf16):
        """max(operations / 989 TFLOP/s, bytes / 3.35 TB/s) of one call at
        BATCH windows of t frames, bf16 weights: each input read once, each
        output written once; the activations between layers in f32 (with
        their bf16 copy written beside them) or, with act_bf16, in bf16."""
        tok = BATCH * (t + 1)
        flops = (2 * tok * dm * nh * (2 * dk + dv) + 2 * BATCH * nh * (t + 1) ** 2 * (dk + dv)
                 + 2 * tok * nh * dv * dm + 4 * tok * dm * dm)
        nbytes = 2 * (dm * nh * (2 * dk + dv) + nh * dv * dm + 2 * dm * dm) + 4 * (nh * (2 * dk + dv) + 7 * dm)
        nbytes += 4 * tok  # mask
        act_in, act_out = (2, 2) if act_bf16 else (4 + 2, 4 + 2)  # f32 and its bf16 copy
        if name == "stem_layer":
            flops += 2 * BATCH * t * 2 * d * dm
            nbytes += 2 * BATCH * t * 400 + 4 * (t + 1) * dm + 2 * 2 * d * dm + 8 * dm + act_out * tok * dm
        elif name == "decoder_layer":
            nbytes += (act_in + act_out) * tok * dm
        else:
            flops += 2 * BATCH * t * dm * d
            nbytes += act_in * tok * dm + 4 * 4 * BATCH * t * d + 4 * BATCH * t + 2 * dm * d + 4 * d + 2 * BATCH * t * d
        return max(flops / PEAK_BF16, nbytes / HBM_BYTES_S) * 1e3, nbytes / 1e6

    step_prof = {}
    for t in (cfg.window, 30):
        x, xc, noise, ipv = (rn(BATCH, t, d) for _ in range(4))
        h = rn(BATCH, t + 1, dm)
        hb = h.to(bf)
        mask = torch.ones(BATCH, t + 1, device=dev)
        ipm = torch.zeros(BATCH, t, device=dev)
        ipm[:, :cfg.overlap_frames] = 1.0
        emb = fs.noise_level_embeddings(model, [999])[0]
        pos = prep[True]["pos_table"][1: t + 2].contiguous()
        # 1. each wrapper against its plain version, bf16 and f32 compute
        for bf16 in (False, True):
            p = prep[bf16]
            cases = {
                "stem_layer": (fs.stem_layer, fs.stem_layer_plain, (x, xc, emb, pos, mask, p), {"act_bf16": True}),
                "decoder_layer": (fl.decoder_layer, fl.decoder_layer_plain, (hb, mask, p["layers"][1]),
                                  {"act_bf16": True}),
                "layer_epilogue": (fs.layer_epilogue, fs.layer_epilogue_plain,
                                   (hb, mask, x, noise, UPDATE, ipv, ipm, p), {}),
            }
            for name, (wrapper, plain, args, extra) in cases.items():
                clear_counts()
                got = wrapper(*args, **kw, **extra)
                counts = (dict(ck.launch_counts), dict(ck.kernel_launches))
                if counts != ({name: 1}, c_launches(name, bf16)):
                    raise AssertionError(f"phase 12: {name} act_bf16 counted/launched {counts}")
                want = plain(*args, **kw, **extra)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype or got.dtype != (bf if extra else torch.float32):
                    raise AssertionError(f"phase 12: {name} gave {got.dtype} {tuple(got.shape)}, plain "
                                         f"{want.dtype} {tuple(want.shape)}")
                err = float((got.float() - want.float()).abs().max())
                flips = 0
                tol = TOL_BF16 if bf16 else TOL_F32
                if got.dtype == torch.float32:
                    ok, tol_s = err <= tol, f"{tol}"
                elif bf16:
                    (ok, flips), tol_s = bf16_flips(got, want, tol), f"{tol} + one bf16 ulp"
                else:
                    (ok, flips), tol_s = bf16_flips(got, want, tol, 0.01), f"{tol} + one bf16 ulp at <= 1% of entries"
                r = out[name]
                key = "max_abs_err" if bf16 else "max_abs_err_f32"
                r[key] = max(r[key], err)
                r["flips_f32"] += flips
                log(f"phase 12: {name} act_bf16 {BATCH} x {t + 1} tokens, {'bf16' if bf16 else 'f32'} compute: "
                    f"max|kernel - plain| = {err:.3e}, {flips} entries past {tol} (bound {tol_s})")
                if not (ok and math.isfinite(err)):
                    raise AssertionError(f"phase 12: {name} act_bf16 disagrees with its plain version: {err}")
        # 2. each wrapper's device ms in both modes (bf16 compute), as the
        # chain calls it. Phase 12 times the device with CUDA events behind a
        # held stream throughout: torch.profiler dropped launches of such a
        # chain in one run, and the modes differ by a few percent
        p = prep[True]
        xa = fs.pack_xa(x, xc, p["wst"].shape[1])
        modes = {
            False: {"stem_layer": lambda: fs.stem_layer(x, xc, emb, pos, mask, p, with_copy=True, xa=xa, **kw),
                    "decoder_layer": lambda: fl.decoder_layer(h, mask, p["layers"][1], hb=hb, with_copy=True, **kw),
                    "layer_epilogue": lambda: fs.layer_epilogue(h, mask, x, noise, UPDATE, ipv, ipm, p, hb=hb,
                                                                xa=xa, **kw)},
            True: {"stem_layer": lambda: fs.stem_layer(x, xc, emb, pos, mask, p, with_copy=True, xa=xa,
                                                       act_bf16=True, **kw),
                   "decoder_layer": lambda: fl.decoder_layer(hb, mask, p["layers"][1], with_copy=True, act_bf16=True,
                                                             **kw),
                   "layer_epilogue": lambda: fs.layer_epilogue(hb, mask, x, noise, UPDATE, ipv, ipm, p, xa=xa, **kw)},
        }
        for name in ACT_WRAPPERS:
            r = out[name].setdefault(f"{BATCH}x{t + 1}", {})
            for act in (False, True):
                tag = "act_bf16" if act else "act_f32"
                r[f"device_ms_{tag}"] = held_events_ms(modes[act][name], 20)
                r[f"ms_{tag}"] = cuda_time_ms(modes[act][name])
                r[f"bound_ms_{tag}"], r[f"mbytes_{tag}"] = bound(name, t, act)
            log(f"phase 12: {name} bf16 {BATCH} x {t + 1} tokens, device ms a call (held-stream events): f32 "
                f"activations "
                f"{r['device_ms_act_f32']:.4f} (per call {r['ms_act_f32']:.4f}), bf16 activations "
                f"{r['device_ms_act_bf16']:.4f} (per call {r['ms_act_bf16']:.4f}); bound {r['bound_ms_act_f32']:.4f} / "
                f"{r['bound_ms_act_bf16']:.4f} ms ({r['mbytes_act_f32']:.1f} / {r['mbytes_act_bf16']:.1f} MB) [{card}]")
        # the epilogue as it ran before this change: the last layer writes its
        # f32 output beside the bf16 copy that the update reads
        xa_old, x_old = fs.pack_xa(x, xc, p["wst"].shape[1]), torch.empty_like(x)

        def epilogue_f32_write():
            _, hl = fl.decoder_layer_cuda(h, mask, p["layers"][-1], hb=hb, with_copy=True, **kw)
            ck.gemm(ck.STEP, hl, p["lw"], p["lb"], x_old, M=BATCH * t, x=x, noise=noise, ipv=ipv, ipm=ipm,
                    t_data=t, scal=UPDATE, out_b=xa_old)

        epilogue_f32_write()
        x_new = modes[False]["layer_epilogue"]()
        r = out["layer_epilogue"][f"{BATCH}x{t + 1}"]
        r["same_without_f32_write"] = torch.equal(x_new, x_old) and torch.equal(xa, xa_old)
        r["device_ms_f32_write"] = held_events_ms(epilogue_f32_write, 20)
        log(f"phase 12: layer_epilogue bf16 {BATCH} x {t + 1} tokens, f32 activations, with the last layer's f32 "
            f"write (before this change) device {r['device_ms_f32_write']:.4f} ms, without it "
            f"{r['device_ms_act_f32']:.4f}; x_next and xa bit for bit: {r['same_without_f32_write']} [{card}]")
        if not r["same_without_f32_write"]:
            raise AssertionError("phase 12: layer_epilogue without the f32 write changed x_next or xa")
        # 3. the step in both modes: wall ms over 20 steps, busy share, device ms
        for act in (False, True):
            step = lambda: fs.fused_denoise_step(x, xc, emb, pos, mask, noise, UPDATE, None, None, p, xa=xa,
                                                 act_bf16=act, **kw)
            step()
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(20):
                    step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
            s = step_prof.setdefault(f"{BATCH}x{t + 1}", {})[("act_bf16" if act else "act_f32")] = {
                "step_ms": wall / 20 * 1e3,
                "device_busy_share": busy_us * 1e-6 / wall if busy_us > 0 else "not measured"}
            s["device_ms"] = held_events_ms(step, 20)
            log(f"phase 12: one reverse step bf16 {BATCH} x {t + 1} tokens, {'bf16' if act else 'f32'} activations: "
                f"{s['step_ms']:.3f} ms wall (20 steps), busy share {s['device_busy_share']}, device "
                f"{s['device_ms']:.4f} ms (held-stream events) [{card}]")

    # 4. the LayerNorm launches: a bf16 residual, a bf16 output alone
    lp = prep[True]["layers"][1]
    rows = BATCH * (cfg.window + 1)
    x = rn(rows, dm)
    xb = x.to(bf)
    x_r = xb.float()  # the bf16 residual's values, in f32
    ctx, h1 = rn(rows, nh * dv).to(bf), rn(rows, dm).to(bf)
    m = torch.ones(rows, device=dev)
    h0, h0_r = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, device=dev)
    h0b, h0b_r = (torch.empty(rows, dm, dtype=bf, device=dev) for _ in range(2))
    o = torch.empty(rows, dm, device=dev)
    ob, ob_alone = (torch.empty(rows, dm, dtype=bf, device=dev) for _ in range(2))
    ln1 = dict(ln_s=lp["ln1s"], ln_b=lp["ln1b"], row_mask=m)
    ln2 = dict(ln_s=lp["ln2s"], ln_b=lp["ln2b"], row_mask=m)
    launches = {
        "fc_ln f32 residual": lambda: ck.gemm(ck.LAYER_NORM, ctx, lp["wfc"], lp["bfc"], h0_r, M=rows, res=x_r,
                                              out_b=h0b_r, **ln1),
        "fc_ln bf16 residual": lambda: ck.gemm(ck.LAYER_NORM, ctx, lp["wfc"], lp["bfc"], h0, M=rows, res=xb,
                                               out_b=h0b, **ln1),
        "w2_ln f32 out + bf16 copy": lambda: ck.gemm(ck.LAYER_NORM, h1, lp["w2"], lp["b2"], o, M=rows, res=h0,
                                                     out_b=ob, **ln2),
        "w2_ln bf16 out alone": lambda: ck.gemm(ck.LAYER_NORM, h1, lp["w2"], lp["b2"], None, M=rows, res=h0,
                                                out_b=ob_alone, **ln2),
    }
    ln = {}
    for name, fn in launches.items():
        clear_counts()
        fn()
        if dict(ck.kernel_launches) != {"gemm_wgmma": 1}:
            raise AssertionError(f"phase 12: {name} launched {dict(ck.kernel_launches)}")
        ln[name] = held_events_ms(fn, 20)
    torch.cuda.synchronize()
    same = {"fc_ln": torch.equal(h0, h0_r) and torch.equal(h0b, h0b_r), "w2_ln": torch.equal(ob_alone, ob)}
    # the f32 kernel: the same equalities against its f32 forms
    lp32 = prep[False]["layers"][1]
    ctx32, h132 = ctx.float(), h1.float()
    h0f, h0f_r = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, device=dev)
    of, ofb = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, dtype=bf, device=dev)
    clear_counts()
    ck.gemm(ck.LAYER_NORM, ctx32, lp32["wfc_split"], lp32["bfc"], h0f, M=rows, res=xb, **ln1)
    ck.gemm(ck.LAYER_NORM, ctx32, lp32["wfc_split"], lp32["bfc"], h0f_r, M=rows, res=x_r, **ln1)
    ck.gemm(ck.LAYER_NORM, h132, lp32["w2_split"], lp32["b2"], of, M=rows, res=h0f, **ln2)
    ck.gemm(ck.LAYER_NORM, h132, lp32["w2_split"], lp32["b2"], None, M=rows, res=h0f, out_b=ofb, **ln2)
    torch.cuda.synchronize()
    if dict(ck.kernel_launches) != {"gemm_tf32x3": 4}:
        raise AssertionError(f"phase 12: the f32 LayerNorm launches launched {dict(ck.kernel_launches)}")
    same["fc_ln f32"] = torch.equal(h0f, h0f_r)
    same["w2_ln f32"] = torch.equal(ofb, of.to(bf))
    log(f"phase 12: LayerNorm launches {BATCH} x {cfg.window + 1} tokens, device ms (held-stream events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ln.items()) + f"; bit for bit on equal inputs: {same} [{card}]")
    if not all(same.values()):
        raise AssertionError(f"phase 12: a bf16 residual or bf16-only output changed a result: {same}")

    # 5. the two-window chain, DDPM-1000, with and without the flag. The
    # second window's inputs come from the first's decoded output (the
    # overlap inpaint, the canonical frame), so the two chains' second
    # windows sample from different inputs; JAX's bound holds each reverse
    # chain on the same inputs: window 0 of both chains, and window 1 of
    # the f32-activation chain sampled again in both modes
    diffs = {False: pipe.diffusion, True: CondGaussianDiffusion(
        dataclasses.replace(cfg, fused_step_act_bf16=True), device=dev, model=model)}
    loops, calls, outs, chain_s = {}, {}, {}, {}
    for act, diff in diffs.items():
        loops[act], calls[act] = diff._loop, []

        def record(*a, _loop=loops[act], _calls=calls[act], **k):
            _calls.append((a, _loop(*a, **k)))
            return _calls[-1][1]

        diff._loop = record
        pipe.diffusion = diff
        clear_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[act] = pipe.stage2_generate_batched(head, fs.TorchNoise(dev, seed=3))
        torch.cuda.synchronize()
        chain_s[act] = time.perf_counter() - t0
        check_counts(2, cfg.timesteps, f"phase 12 chain, {'bf16' if act else 'f32'} activations")
        diff._loop = loops[act]
    pipe.diffusion = diffs[False]
    drift_w = [float((calls[True][i][1] - calls[False][i][1]).abs().max()) for i in range(2)]
    tail = {act: loops[act](*calls[False][1][0], noise=fs.TorchNoise(dev, seed=9)) for act in (False, True)}
    drift = {"window 0": drift_w[0], "window 1 on the same inputs": float((tail[True] - tail[False]).abs().max())}
    drift_aa, drift_root = (float((a - b).abs().max()) for a, b in zip(outs[True], outs[False]))
    finite = all(bool(torch.isfinite(o).all()) for o in (*outs[True], tail[True]))
    log(f"phase 12: DDPM-{cfg.timesteps} chain {BATCH} x 140 frames (2 windows), bf16 compute: f32 activations "
        f"{chain_s[False]:.2f} s, bf16 activations {chain_s[True]:.2f} s; max|x bf16 act - x f32 act| of each reverse "
        f"chain on the same inputs {drift} (JAX's bound 0.08); along the two chains: window 1 {drift_w[1]:.4e}, "
        f"decoded local_aa {drift_aa:.4e} rad, root {drift_root:.4e} m; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    if not (finite and all(0 < v < 0.08 for v in drift.values())):
        raise AssertionError(f"phase 12: bf16-activation drift {drift} (finite: {finite})")
    return {"wrappers": out, "step": step_prof, "layer_norm_launch_device_ms": ln, "bit_for_bit": same,
            "chain_s": {"act_f32": chain_s[False], "act_bf16": chain_s[True]}, "drift": drift,
            "chain_drift_window_1": drift_w[1], "chain_drift_local_aa": drift_aa, "chain_drift_root": drift_root,
            "card": card}


def vposer_error_scale(d6, aa=None):
    """How far the VPoser decode may carry a rounding of its network's
    output d6 (..., 21, 6), per joint: max(1, max|d6| of the latent /
    min(|a1|, |a2 without its a1 part|)), since the Gram-Schmidt divides by
    those norms; for axis-angle output ``aa`` (..., 21, 3) also times max(1,
    its angle). Two f32 decodes of one latent (card and CPU, port and JAX)
    are held to 1e-5 times it: a joint whose columns are short or nearly
    parallel turns an f32 rounding of d6 into a large turn of its frame."""
    d6 = np.asarray(d6, np.float64)
    a = d6.reshape(d6.shape[:-1] + (3, 2))
    a1, a2 = a[..., 0], a[..., 1]
    n1 = np.linalg.norm(a1, axis=-1)
    b1 = a1 / np.maximum(n1, 1e-8)[..., None]
    n2 = np.linalg.norm(a2 - (b1 * a2).sum(-1, keepdims=True) * b1, axis=-1)
    scale = np.maximum(1.0, np.abs(d6).max(axis=(-2, -1))[..., None] / np.maximum(np.minimum(n1, n2), 1e-8))
    return scale if aa is None else scale * np.maximum(1.0, np.linalg.norm(np.asarray(aa, np.float64), axis=-1))


OF_FRAMES, OF_HW, OF_BATCH = 256, (360, 480), 64  # phase 16a: flow npys for of_feats, their size, its batch
RAW_SEQS, RAW_FRAMES, RAW_EPOCHS = 128, 62, 2  # phase 16b: 4 steps an epoch at batch 32, window 60
RAW_POOL = (64, 256, 320)  # phase 16b: distinct raw-flow npys (h x w x 2) the records point into
PWC_PAIRS, PWC_HW = 4, (448, 768)  # phase 16c: image pairs of the PWC-Net forward
GIMO_LATENTS = 20000  # phase 16d: VPoser latents decoded card vs CPU


def conv_macs(model, *inputs):
    """Multiply-adds of the Conv2d, ConvTranspose2d and Linear layers in one
    forward of ``model(*inputs)``, counted from their shapes by forward hooks."""
    import torch
    from torch import nn

    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, nn.ConvTranspose2d):  # each input pixel scatters to out x kh x kw
            total[0] += args[0].numel() * mod.weight[0].numel()
        elif isinstance(mod, nn.Conv2d):  # each output pixel gathers in / groups x kh x kw
            total[0] += out.numel() * mod.weight[0].numel()
        else:
            total[0] += out.numel() * mod.in_features

    layers = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, layers)]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def write_gimo_fixture(root, rng, seqs=(("sceneA", "seq1", 4), ("sceneA", "seq2", 3), ("sceneB", "seq0", 5))):
    """GIMO's segmented layout that ``preprocess.gimo_pose`` walks:
    <root>/<scene>/<seq>/smplx_local/<frame>.pkl, each frame a dict of torch
    tensors (latent (32,), trans, orient (3,), beta (10,)), as GIMO stores
    them; and a file beside the scenes that is not one. Returns {(scene,
    seq): latents (frames, 32)}."""
    import torch

    latents = {}
    for scene, seq, frames in seqs:
        d = os.path.join(root, scene, seq, "smplx_local")
        os.makedirs(d)
        for i in range(frames):
            rec = {k: torch.tensor(rng.randn(n), dtype=torch.float32)
                   for k, n in (("latent", 32), ("trans", 3), ("orient", 3), ("beta", 10))}
            with open(os.path.join(d, f"{i:04d}.pkl"), "wb") as f:
                pickle.dump(rec, f)
            latents.setdefault((scene, seq), []).append(rec["latent"].numpy())
    open(os.path.join(root, "README"), "w").close()
    return {k: np.stack(v) for k, v in latents.items()}


def optical_flow_phase(card, data_dir):
    """Phase 16: the optical-flow models, the raw-flow HeadNet and the GIMO
    decoder at release shapes, on fixtures written here from seeds. (a) the
    ``of_feats`` CLI on OF_FRAMES flows of 360 x 480: frames/s, its first
    64 features against the CPU port's on the same weights (1e-4 of their
    max), the device ms of one 64-frame batch beside its f32 bound and with
    cuDNN's TF32 on. (b) ``train_stage1 headnet --raw_flow`` at the release
    widths, batch 32 x window 60 (1,920 frames of 224 x 224 a step), frozen
    CNN, RAW_EPOCHS epochs of 4 steps: finite losses, the CNN bit for bit,
    the rest moved, a checkpoint per epoch that reloads; the step's wall
    and device ms, busy share, peak memory and bound, the host ms of loading
    and augment_flow; one step at 2 x 60 card vs CPU (train_step_agreement);
    one step with the CNN trained at 4 x 60. (c) ``pwcnet_forward`` on
    PWC_PAIRS pairs of 448 x 768 and its training pyramid, card vs CPU
    within 5e-4; its device ms, the correlation's share, and the forward
    with its convolutions on cuDNN in f32 and in TF32. (d)
    ``vposer_decode`` of GIMO_LATENTS latents card vs CPU (1e-5 of each
    joint's ``vposer_error_scale``) and ``gimo_pose.extract_all`` on a
    fixture, card vs CPU. Returns the summary."""
    import torch

    from egoego_release_tpu_torch.data.headpose import ARESHeadPoseDataset
    from egoego_release_tpu_torch.models import pwcnet as pw
    from egoego_release_tpu_torch.models.denoiser import init_weights_
    from egoego_release_tpu_torch.models.headnet import HeadFormerWithCNN
    from egoego_release_tpu_torch.models.resnet import f32_convolutions, flow_to_input
    from egoego_release_tpu_torch.models.transformer import set_dropout_rate
    from egoego_release_tpu_torch.models.vposer import VPoserDecoder, load_vposer_ckpt, vposer_decode
    from egoego_release_tpu_torch.ops.fused_step import TorchNoise
    from egoego_release_tpu_torch.preprocess import gimo_pose, of_feats
    from egoego_release_tpu_torch.training import train_stage1 as ts
    from egoego_release_tpu_torch.training.trainer_stage1 import (
        Stage1Trainer, freeze_subtrees, headnet_cnn_loss_fn, make_optimizer)
    from egoego_release_tpu_torch.utils.config import load_config
    from egoego_release_tpu_torch.utils.convert import load_stage1_ckpt

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    root = os.path.join(data_dir, "optical_flow")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cudnn = torch.backends.cudnn
    tf32_on = lambda: cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                                  allow_tf32=True)
    out = {"card": card}
    at = lambda: f"; {time.perf_counter() - t_phase:.0f} s into phase 16"

    # (a) the of_feats CLI
    rng = np.random.RandomState(31)
    of_root = os.path.join(root, "of_feats")
    for k in range(2):
        d = os.path.join(of_root, f"take{k}", "raft_flows")
        os.makedirs(d)
        for i in range(OF_FRAMES // 2):
            np.save(os.path.join(d, f"{i:05d}.npy"), (3 * rng.randn(*OF_HW, 2)).astype(np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = of_feats.main(["--flow_root", of_root, "--batch", str(OF_BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    dt_cli = time.perf_counter() - t0
    flow_dir = os.path.join(of_root, "take0", "raft_flows")
    files = sorted(os.listdir(flow_dir))[:OF_BATCH]
    t0 = time.perf_counter()
    flows = np.stack([of_feats.resize_flow(np.load(os.path.join(flow_dir, f)).astype(np.float32)) for f in files])
    host_ms = (time.perf_counter() - t0) * 1e3
    got = np.stack([np.load(os.path.join(flow_dir.replace("raft_flows", "raft_of_feats"), f)) for f in files])
    want = of_feats.build_encoder(None, device="cpu")(flows)
    err, bound = float(np.abs(got - want).max()), 1e-4 * float(np.abs(want).max())
    if n != OF_FRAMES or got.shape != (OF_BATCH, 512) or not err <= bound:
        raise AssertionError(f"phase 16a: of_feats wrote {n} files; first batch {got.shape}, card vs CPU {err} > "
                             f"{bound}")
    enc = of_feats.build_encoder(None, device="cuda")
    x = flow_to_input(torch.from_numpy(flows).to(dev))
    fwd = torch.no_grad()(lambda: enc.model(x))
    with f32_convolutions():
        f32_ms, _ = device_time_ms(fwd, reps=10, chain=True)
        y32 = fwd()
        macs = conv_macs(enc.model, x[:1]) * OF_BATCH
    with tf32_on():
        tf32_ms, _ = device_time_ms(fwd, reps=10, chain=True)
        tf32_err = float((fwd() - y32).abs().max() / y32.abs().max())
    nbytes = (x.numel() + sum(t.numel() for t in enc.model.state_dict().values()) + OF_BATCH * 512) * 4
    ops_s, bytes_s = 2 * macs / PEAK_F32, nbytes / HBM_BYTES_S
    a = out["of_feats"] = {
        "frames": n, "cli_s": dt_cli, "frames_per_s": n / dt_cli, "batch_device_ms": f32_ms,
        "batch_tf32_ms": tf32_ms, "tf32_rel_err": tf32_err, "host_load_resize_ms": host_ms, "card_vs_cpu": err,
        "bound_card_vs_cpu": bound, "gflop": 2 * macs / 1e9, "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s > bytes_s else "bytes"}
    log(f"phase 16a: of_feats --device cuda on {n} flows of {OF_HW[0]} x {OF_HW[1]} in {dt_cli:.2f} s "
        f"({a['frames_per_s']:.1f} frames/s, loading and writing included); first {OF_BATCH} features card vs CPU "
        f"{err:.3e} (bound {bound:.3e}); one {OF_BATCH}-frame batch (ResNet-18 at 224, stored statistics): device "
        f"{f32_ms:.3f} ms in f32, {tf32_ms:.3f} ms with cuDNN TF32 (features off by {tf32_err:.2e} of their max), "
        f"bound {a['bound_ms']:.3f} ms ({a['gflop']:.1f} GFLOP at {PEAK_F32 / 1e12:.0f} TFLOP/s f32); the host's load "
        f"and resize of {OF_BATCH} flows {host_ms:.1f} ms{at()} [{card}]")

    # (b) train_stage1 headnet --raw_flow, release widths
    raw_root = os.path.join(root, "ares_raw")
    t0 = time.perf_counter()
    write_ares_fixture(raw_root, np.random.RandomState(37), RAW_SEQS, RAW_FRAMES, flow_pool=RAW_POOL)
    dt_fixture = time.perf_counter() - t0
    sets = ["logging.log_every=1", "train.seed=0", f"data.batch_size={STAGE1_BATCH}", f"logging.save_dir={root}"]
    cfg = load_config(None, overrides=sets)
    m, steps_per_epoch = cfg.headnet, RAW_SEQS // STAGE1_BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ts.main(["headnet", "--dataset", "ares", "--data_root_folder", raw_root, "--raw_flow", "--epochs",
                     str(RAW_EPOCHS), "--device", "cuda", "--set", *sets, "logging.exp_name=raw_flow"])
    torch.cuda.synchronize()
    dt_run = time.perf_counter() - t0
    losses = [json.loads(line)["loss"] for line in open(os.path.join(root, "raw_flow", "metrics.jsonl"))]
    fresh = dict(ts.stage1_model(HeadFormerWithCNN, m, cfg.train.seed, "cpu").named_parameters())
    params = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    cnn_same = all(torch.equal(p, fresh[k]) for k, p in params.items() if k.startswith("cnn."))
    unmoved = [k for k, p in params.items() if not k.startswith("cnn.") and torch.equal(p, fresh[k])]
    weights = os.path.join(root, "raw_flow", "weights")
    names = sorted(os.listdir(weights))
    reloaded = load_stage1_ckpt(os.path.join(weights, names[-1]), "headnet_cnn", m.n_dec_layers, d_model=m.d_model,
                                n_head=m.n_head, d_k=m.d_k, d_v=m.d_v)
    same = all(torch.equal(reloaded[k], v.cpu()) for k, v in state.model.state_dict().items())
    if (state.step != RAW_EPOCHS * steps_per_epoch or len(losses) != state.step or not all(map(math.isfinite, losses))
            or not cnn_same or unmoved or names != [f"epoch-{i}.pt" for i in range(RAW_EPOCHS)] or not same):
        raise AssertionError(f"phase 16b: step {state.step}, losses {losses}, CNN unchanged {cnn_same}, unmoved "
                             f"{unmoved}, checkpoints {names}, reloaded {same}")
    b = out["raw_flow"] = {"fixture_s": dt_fixture, "run_s": dt_run, "steps": state.step, "losses": losses}
    log(f"phase 16b: train_stage1 headnet --raw_flow, release widths, batch {STAGE1_BATCH} x window {m.window} "
        f"(frozen ResNet-18 over {STAGE1_BATCH * m.window} frames of 224 x 224 a step), {RAW_EPOCHS} epochs = "
        f"{state.step} steps in {dt_run:.2f} s (loading, augment_flow and checkpoints included; fixture of "
        f"{RAW_SEQS} records into {RAW_POOL[0]} flows of {RAW_POOL[1]} x {RAW_POOL[2]} in {dt_fixture:.1f} s); losses "
        f"{[round(v, 4) for v in losses]}; the CNN bit for bit, every other tensor moved; {names} saved, "
        f"{names[-1]} reloaded bit for bit{at()} [{card}]")
    del state
    ds = ARESHeadPoseDataset(raw_root, train=True, window=m.window)
    ds.input_of_feats, ds.augment = False, True
    t0 = time.perf_counter()  # 8 records loaded and augmented, timed; the step's batch repeats them 4 times
    items = [ds[i % len(ds)] for i in range(8)]
    b["host_batch_ms"] = (time.perf_counter() - t0) * 1e3 / 8 * STAGE1_BATCH
    batch = {k: np.stack([it[k] for it in items] * (STAGE1_BATCH // 8)) for k in ("of", "head_pose", "head_vels",
                                                                                  "seq_len")}

    def raw_state(where, freeze=True, dropout=True):
        tr = Stage1Trainer(headnet_cnn_loss_fn, make_optimizer(cfg.train.learning_rate, cfg.train.lr_step_size,
                                                               cfg.train.lr_gamma, steps_per_epoch))
        model = ts.stage1_model(HeadFormerWithCNN, m, 1, where, freeze_cnn=freeze)
        st = tr.init_state(freeze_subtrees(model, ("cnn",) if freeze else ()))
        if not dropout:
            set_dropout_rate(st.model, 0.0)
        return tr, st

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr, st = raw_state(dev)
    batch_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    noise = TorchNoise(dev, seed=7)
    step = lambda: tr.train_step(st, batch_dev, noise)
    for _ in range(2):
        step()
    times = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        step()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    b["step_ms"] = statistics.median(times)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    b["wall_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    b["device_ms"], kernels = device_time_ms(step, reps=2, chain=True)
    b["device_busy_share"] = b["device_ms"] / b["wall_ms"]
    b["launches_per_step"] = sum(kernels.values()) / 2
    b["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    with f32_convolutions():
        cnn_macs = conv_macs(st.model.cnn, flow_to_input(batch_dev["of"][0, :1])) * STAGE1_BATCH * m.window
    b["gflop"] = (2 * cnn_macs + stage1_step_flops("headnet", m, STAGE1_BATCH)) / 1e9
    b["bound_ms"] = b["gflop"] * 1e9 / PEAK_F32 * 1e3
    b["cnn_bound_ms"] = 2 * cnn_macs / PEAK_F32 * 1e3
    log(f"phase 16b: raw-flow optimizer step (batch {STAGE1_BATCH} x {m.window}, f32, dropout on, CNN frozen): "
        f"{b['step_ms']:.2f} ms (median of 5 CUDA-event timings after 2 warm-up steps), wall {b['wall_ms']:.2f} "
        f"ms over 3; device {b['device_ms']:.2f} ms, busy share {b['device_busy_share']:.3f}, "
        f"{b['launches_per_step']:.0f} device kernels and copies a step; peak {b['peak_mib']:.0f} MiB; bound "
        f"{b['bound_ms']:.2f} ms ({b['gflop']:.0f} GFLOP at {PEAK_F32 / 1e12:.0f} TFLOP/s f32; the CNN's forward "
        f"{b['cnn_bound_ms']:.2f}); the host's loading and augment_flow of one batch ({STAGE1_BATCH * m.window} "
        f"flows; 8 records timed) {b['host_batch_ms']:.0f} ms{at()} [{card}]")
    del tr, st, step, batch_dev

    pick = {k: v[:2] for k, v in batch.items()}
    errs = train_step_agreement(lambda where: raw_state(where, dropout=False), pick, 4, dev,
                                gradients64=stage1_gradients64,
                                adam=lambda tr: (tr.optimizer.learning_rate(0), tr.optimizer.weight_decay))
    log(f"phase 16b: raw-flow step, card vs CPU, 2 x {m.window} frames, CNN frozen (bounds in brackets): loss "
        f"{errs['loss']:.3e} [{STEP_BOUNDS['loss']}]; {errs['branch_calls']} relu / abs calls, {errs['flips']} entries "
        f"where the CPU took the other branch, {errs['forced']} forced, inputs within {errs['flip_input']:.3e} "
        f"[{STEP_BOUNDS['flip_input']}]; clipped gradients against float64: card {errs['grad64']:.3e} "
        f"({errs['grad64_worst']}), CPU {errs['grad64_cpu']:.3e}, ratio {errs['grad64_excess']:.3f} "
        f"[{STEP_BOUNDS['grad64_excess']}]; w_k.bias {errs['wk_bias']:.3e} [{STEP_BOUNDS['wk_bias']}], parameters "
        f"{errs['param']:.3e} [{STEP_BOUNDS['param']}], AdamW {errs['adam']:.3e} [{STEP_BOUNDS['adam']}]; as each "
        f"side runs: gradients {errs['grad_l2_all']:.3e} [{STEP_BOUNDS['grad_l2_all']}], worst tensor "
        f"{errs['grad_l2']:.3e} [{STEP_BOUNDS['grad_l2']}] (held when no branch flipped){at()}")
    free = ("grad_l2_all", "grad_l2") if errs["flips"] else ()
    bad = {k: errs[k] for k, lim in STEP_BOUNDS.items() if not errs[k] <= lim and k not in free}
    if bad:
        raise AssertionError(f"phase 16b: card and CPU raw-flow steps disagree: {bad}")
    b["card_vs_cpu"] = {k: v for k, v in errs.items() if k != "flip_calls"}

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr, st = raw_state(dev, freeze=False)
    before = {k: p.detach().clone() for k, p in st.model.named_parameters()}
    t0 = time.perf_counter()
    tr.train_step(st, {k: v[:4] for k, v in batch.items()}, TorchNoise(dev, seed=8))
    torch.cuda.synchronize()
    b["trained_cnn_step_s"] = time.perf_counter() - t0
    b["trained_cnn_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    unmoved = [k for k, p in st.model.named_parameters() if torch.equal(p, before[k])]
    if unmoved:
        raise AssertionError(f"phase 16b: a step with the CNN trained left {unmoved} unchanged")
    log(f"phase 16b: one step with the CNN trained (freeze_cnn=False), 4 x {m.window} frames: every parameter moved; "
        f"{b['trained_cnn_step_s']:.2f} s (first call), peak {b['trained_cnn_peak_mib']:.0f} MiB{at()} [{card}]")
    del tr, st, before

    # (c) PWC-Net
    net_cpu = pw.init_pwcnet_(pw.PWCDCNet(), torch.Generator().manual_seed(41)).eval()
    net = pw.PWCDCNet().to(dev).eval()
    net.load_state_dict(net_cpu.state_dict())
    rng = np.random.RandomState(43)
    im1, im2 = (torch.from_numpy(rng.rand(PWC_PAIRS, 3, *PWC_HW).astype(np.float32)) for _ in range(2))
    d1, d2 = im1.to(dev), im2.to(dev)
    with torch.no_grad():
        flow2 = pw.pwcnet_forward(net, d1, d2).cpu()
        pyramid = [f.cpu() for f in pw.pwcnet_forward(net, d1, d2, training=True)]
        t0 = time.perf_counter()
        want = pw.pwcnet_forward(net_cpu, im1, im2, training=True)
        cpu_s = time.perf_counter() - t0
    err_flow = float((flow2 - want[0]).abs().max())
    err_pyr = max(float((g - w).abs().max()) for g, w in zip(pyramid, want))
    if flow2.shape != (PWC_PAIRS, 2, PWC_HW[0] // 4, PWC_HW[1] // 4) or not (err_flow <= 5e-4 and err_pyr <= 5e-4):
        raise AssertionError(f"phase 16c: PWC-Net card vs CPU: flow2 {tuple(flow2.shape)} {err_flow}, pyramid "
                             f"{err_pyr}")
    fwd = torch.no_grad()(lambda: pw.pwcnet_forward(net, d1, d2))
    calls, corr = [], pw.correlation
    pw.correlation = lambda x1, x2, md=4: calls.append((x1, x2)) or corr(x1, x2, md)
    try:
        fwd()
    finally:
        pw.correlation = corr
    fwd_ms, _ = device_time_ms(fwd, reps=5, chain=True)
    corr_ms, _ = device_time_ms(torch.no_grad()(lambda: [corr(x1, x2) for x1, x2 in calls]), reps=5, chain=True)
    # yardsticks: the same forward with its convolutions on cuDNN in f32 and in
    # TF32, timed by CUDA events (tracing cuDNN's slow f32 route costs minutes)
    own, cudnn_ms = pw.f32_convolutions, {}
    for name, tf32 in (("f32", False), ("tf32", True)):
        pw.f32_convolutions = lambda cudnn=True, tf32=tf32: torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False, allow_tf32=tf32)
        try:
            cudnn_ms[name] = (cuda_time_ms(fwd, warmup=1, reps=2), float((fwd().cpu() - want[0]).abs().max()))
        finally:
            pw.f32_convolutions = own
    macs = conv_macs(net, torch.cat([d1, d2], 1)) + sum(81 * x1.numel() for x1, _ in calls)
    c = out["pwcnet"] = {
        "pairs": PWC_PAIRS, "hw": PWC_HW, "max_abs_err_flow2": err_flow, "max_abs_err_pyramid": err_pyr,
        "max_abs_flow2": float(want[0].abs().max()), "device_ms": fwd_ms, "cudnn_f32_ms": cudnn_ms["f32"][0],
        "cudnn_tf32_ms": cudnn_ms["tf32"][0], "cudnn_tf32_err": cudnn_ms["tf32"][1], "correlation_ms": corr_ms,
        "correlation_share": corr_ms / fwd_ms, "gflop": 2 * macs / 1e9, "bound_ms": 2 * macs / PEAK_F32 * 1e3,
        "cpu_s": cpu_s}
    log(f"phase 16c: pwcnet_forward, {PWC_PAIRS} pairs of {PWC_HW[0]} x {PWC_HW[1]}: flow2 {tuple(flow2.shape)} "
        f"card vs CPU {err_flow:.3e}, the training pyramid {err_pyr:.3e} (bound 5e-4; max|flow2| "
        f"{c['max_abs_flow2']:.3f}); device {fwd_ms:.3f} ms (f32 convolutions by im2col + cuBLAS), of which the "
        f"{len(calls)} correlations {corr_ms:.3f} ms ({c['correlation_share']:.3f}); the convolutions on cuDNN "
        f"instead: f32 "
        f"{cudnn_ms['f32'][0]:.1f} ms (error {cudnn_ms['f32'][1]:.2e}), TF32 {cudnn_ms['tf32'][0]:.1f} ms (error "
        f"{cudnn_ms['tf32'][1]:.2e}; CUDA events, 2 calls); bound {c['bound_ms']:.3f} ms ({c['gflop']:.1f} GFLOP at "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s f32); the CPU's pyramid {cpu_s:.1f} s{at()} [{card}]")
    del net, d1, d2, calls

    # (d) the GIMO decoder and its extraction
    gimo = os.path.join(root, "gimo")
    os.makedirs(gimo)
    ckpt = os.path.join(gimo, "vposer_snapshot.pt")
    torch.save(init_weights_(VPoserDecoder(), torch.Generator().manual_seed(47)).state_dict(), ckpt)
    dec, dec_cpu = load_vposer_ckpt(ckpt, dev), load_vposer_ckpt(ckpt, "cpu")
    lat = torch.from_numpy(np.random.RandomState(53).randn(GIMO_LATENTS, 32).astype(np.float32))
    with torch.no_grad():
        d6, d6_cpu = dec.rot6d(lat.to(dev)).cpu().numpy(), dec_cpu.rot6d(lat).numpy()
    ratios = {}
    for kind in ("matrot", "aa"):
        got, want = vposer_decode(dec, lat.to(dev), kind).cpu().numpy(), vposer_decode(dec_cpu, lat, kind).numpy()
        scale = vposer_error_scale(d6_cpu, want if kind == "aa" else None)
        e = np.abs(got - want).reshape(scale.shape + (-1,)).max(-1)
        ratios[kind] = (float(e.max()), float((e / scale).max()), float(np.median(scale)))
    err6 = float(np.abs(d6 - d6_cpu).max() / np.abs(d6_cpu).max())
    lat_dev = lat.to(dev)
    decode_ms, _ = device_time_ms(lambda: vposer_decode(dec, lat_dev, "aa"), reps=10, chain=True)
    fixture = write_gimo_fixture(os.path.join(gimo, "root"), np.random.RandomState(59),
                                 (("scene0", "seq0", 30), ("scene1", "seq0", 25)))
    n_card = gimo_pose.extract_all(os.path.join(gimo, "root"), os.path.join(gimo, "card"), ckpt, device="cuda")
    n_cpu = gimo_pose.extract_all(os.path.join(gimo, "root"), os.path.join(gimo, "cpu"), ckpt, device="cpu")
    err_npz = 0.0
    for (scene, seq), latents in fixture.items():
        g, w = (np.load(os.path.join(gimo, side, scene, seq + ".npz")) for side in ("card", "cpu"))
        with torch.no_grad():
            scale = vposer_error_scale(dec_cpu.rot6d(torch.from_numpy(latents)).numpy(), w["poses"])
        err_npz = max(err_npz, float((np.abs(g["poses"] - w["poses"]).max(-1) / scale).max()))
        if not all(np.array_equal(g[k], w[k]) for k in ("root_trans", "root_orient", "beta")):
            raise AssertionError(f"phase 16d: gimo_pose {scene}/{seq}: card and CPU npzs differ beyond poses")
    if not (ratios["matrot"][1] <= 1e-5 and ratios["aa"][1] <= 1e-5 and err6 <= 1e-5 and err_npz <= 1e-5
            and n_card == n_cpu == len(fixture)):
        raise AssertionError(f"phase 16d: VPoser card vs CPU {ratios}, 6D {err6}, npz {err_npz}, {n_card} / {n_cpu}")
    out["gimo"] = {"latents": GIMO_LATENTS, "max_abs_err_matrot": ratios["matrot"][0],
                   "scaled_err_matrot": ratios["matrot"][1], "max_abs_err_aa": ratios["aa"][0],
                   "scaled_err_aa": ratios["aa"][1], "median_scale_aa": ratios["aa"][2], "rel_err_6d": err6,
                   "decode_device_ms": decode_ms, "extract_scaled_err": err_npz, "sequences": n_card}
    log(f"phase 16d: vposer_decode of {GIMO_LATENTS} latents, card vs CPU: matrot {ratios['matrot'][0]:.3e}, aa "
        f"{ratios['aa'][0]:.3e} abs, {ratios['matrot'][1]:.3e} / {ratios['aa'][1]:.3e} of each joint's "
        f"vposer_error_scale (bound 1e-5; the median joint's aa scale {ratios['aa'][2]:.2f}), the network's 6D "
        f"output {err6:.3e} of its max; decode device {decode_ms:.3f} ms; gimo_pose.extract_all on {n_card} sequences, "
        f"card vs CPU {err_npz:.3e} of the scale, the rest bit for bit{at()} [{card}]")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16 took {out['phase_s']:.1f} s [{card}]")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
        CondGaussianDiffusion, DiffusionConfig)
    from egoego_release_tpu_torch.eval import eval_egoego, eval_stage2
    from egoego_release_tpu_torch.eval.build import build_pipeline
    from egoego_release_tpu_torch.eval import pipeline as pl
    from egoego_release_tpu_torch.models import transformer as tf_mod
    from egoego_release_tpu_torch.models.headnet import va2rot
    from egoego_release_tpu_torch.ops import attention as attn
    from egoego_release_tpu_torch.ops import cuda_kernels as ck
    from egoego_release_tpu_torch.ops import fused_layer as fl
    from egoego_release_tpu_torch.ops import fused_step as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 1 -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    built = ck.build(force=True)
    log(f"phase 1: built {', '.join(ck.SOURCES)} in {built['seconds']:.1f} s")
    for name, rep in built["ptxas"].items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            elif "wgmma" in line or "setmaxnreg" in line:
                log(f"  {name}: {line.strip()}")
    # the mha kernel's products run on the tensor cores: count its HMMA
    # (and FFMA, the softmax's arithmetic) instructions in the built library
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(ck.BUILD_DIR / "libegoego_mha.so")],
                          capture_output=True, text=True, check=True).stdout
    hmma, ffma = re.findall(r"\bHMMA\.[\w.]+", sass), re.findall(r"\bFFMA\b", sass)
    log(f"phase 1: mha SASS: {len(hmma)} HMMA ({', '.join(sorted(set(hmma)))}), {len(ffma)} FFMA")
    if not hmma or any("TF32" not in x for x in hmma):
        raise AssertionError("mha: no TF32 tensor-core instruction in the built kernel")
    # every bf16 product runs on wgmma (SASS: HGMMA), one instantiation of
    # gemm_wgmma_kernel<BM, BN, STAGES, epilogue> per epilogue, and the library holds no HMMA
    sass = subprocess.run([cuobjdump, "-sass", str(ck.BUILD_DIR / "libegoego_gemm.so")],
                          capture_output=True, text=True, check=True).stdout
    hmma = re.findall(r"\bHMMA\.[\w.]+", sass)
    wg_kernels = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.match(r"\S*gemm_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d)E", fn)
        if m:
            hg = re.findall(r"\bHGMMA\.[\w.]+", fn)
            wg_kernels[WG_EPILOGUES[int(m.group(4))]] = (f"{m.group(1)}x{m.group(2)}, {m.group(3)} stages", hg)
    for epi, (tile, hg) in sorted(wg_kernels.items()):
        log(f"phase 1: gemm_wgmma_kernel {epi} ({tile}): {len(hg)} HGMMA ({', '.join(sorted(set(hg)))})")
    log(f"phase 1: gemm SASS: {len(hmma)} HMMA")
    if sorted(wg_kernels) != sorted(WG_EPILOGUES) or not all(hg for _, hg in wg_kernels.values()) or hmma:
        raise AssertionError(f"gemm: want HGMMA in each of {WG_EPILOGUES} and no HMMA, got "
                             f"{ {k: len(v[1]) for k, v in wg_kernels.items()} } and {len(hmma)} HMMA")
    # every f32 product runs on 3xTF32 wgmma: one instantiation of
    # gemm_tf32x3_kernel<BM, BN, STAGES, epilogue> per epilogue and layout,
    # each with TF32 HGMMA (and only TF32)
    tf32_kernels = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.match(r"\S*gemm_tf32x3_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d)E", fn)
        if m:
            hg = re.findall(r"\bHGMMA\.[\w.]+", fn)
            tf32_kernels[WG_EPILOGUES[int(m.group(4))]] = (f"{m.group(1)}x{m.group(2)}, {m.group(3)} stages", hg)
    for epi, (tile, hg) in sorted(tf32_kernels.items()):
        log(f"phase 1: gemm_tf32x3_kernel {epi} ({tile}): {len(hg)} HGMMA ({', '.join(sorted(set(hg)))})")
    if (sorted(tf32_kernels) != sorted(WG_EPILOGUES)
            or not all(hg and all(".TF32" in x for x in hg) for _, hg in tf32_kernels.values())):
        raise AssertionError(f"gemm: want TF32 HGMMA (alone) in each of {WG_EPILOGUES} of gemm_tf32x3_kernel, got "
                             f"{ {k: sorted(set(v[1])) for k, v in tf32_kernels.items()} }")
    if any("spill" in line and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line)
           for line in built["ptxas"].get("gemm", "").splitlines()):
        raise AssertionError("gemm: a kernel spills registers")
    # the layer's attention in bf16: attention_wgmma_kernel<key tile> (HGMMA
    # for q k^T and p v), one instantiation per key tile, none spilling
    sass = subprocess.run([cuobjdump, "-sass", str(ck.BUILD_DIR / "libegoego_attention.so")],
                          capture_output=True, text=True, check=True).stdout
    attn_wg = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.match(r"\S*attention_wgmma_kernelILi(\d+)E", fn)
        if m:
            attn_wg[int(m.group(1))] = re.findall(r"\bHGMMA\.[\w.]+", fn)
    for nk, hg in sorted(attn_wg.items()):
        log(f"phase 1: attention_wgmma_kernel<{nk} keys>: {len(hg)} HGMMA ({', '.join(sorted(set(hg)))})")
    if sorted(attn_wg) != list(ATTN_KEY_TILES) or not all(attn_wg.values()):
        raise AssertionError(f"attention: want HGMMA in attention_wgmma_kernel<{ATTN_KEY_TILES}>, got "
                             f"{ {k: len(v) for k, v in attn_wg.items()} }")
    fn = ""
    for line in built["ptxas"].get("attention", "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        fn = m.group(1) if m else fn
        if ("spill" in line and "attention_wgmma_kernel" in fn
                and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line)):
            raise AssertionError(f"attention: {fn} spills registers: {line.strip()}")

    # -- phase 2: kernels against their plain versions ---------------------
    cfg = DiffusionConfig(compute_dtype="bfloat16")
    diff_bf16 = CondGaussianDiffusion(cfg, device=dev, seed=0)
    model = diff_bf16.model
    prep = {True: fs.prepare_step_params(model, True), False: fs.prepare_step_params(model, False)}
    g = torch.Generator(device=dev).manual_seed(1)
    nh, dk, dv, dm, d = cfg.n_head, cfg.d_k, cfg.d_v, cfg.d_model, cfg.d_feats
    kw = dict(n_head=nh, d_k=dk, d_v=dv)

    def inputs(t, b=BATCH):
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        mask = torch.ones(b, t + 1, device=dev)
        ipm = torch.zeros(b, t, device=dev)
        ipm[:, :cfg.overlap_frames] = 1.0
        return {
            "x": rn(b, t, d), "xc": rn(b, t, d), "noise": rn(b, t, d),
            "h": rn(b, t + 1, dm), "mask": mask,
            "emb": fs.noise_level_embeddings(model, [999])[0],
            "pos": prep[True]["pos_table"][1: t + 2].contiguous(),
            "ipv": rn(b, t, d), "ipm": ipm,
        }

    # kernel launches of one call of each wrapper: 4 GEMMs and one attention
    # per layer, plus the stem's or the update's GEMM; every GEMM on the
    # wgmma kernel in bf16, on the 3xTF32 kernel ("gemm_tf32x3") in f32; the
    # attention on the wgmma kernel in bf16 (head width 256, <= 128 tokens),
    # on the 3xTF32 mha kernel in f32
    def c_launches(name, bf16=True):
        n_gemm = 4 if name in ("decoder_layer", "fused_decoder_layer") else 5
        return {"gemm_wgmma": n_gemm, "attention_wgmma": 1} if bf16 else {"gemm_tf32x3": n_gemm, "mha": 1}

    def calls(inp, bf16):
        """[(name, check, wrapper, plain, args, kwargs of the wrapper alone)];
        the last case of each name is the one timed. In bf16 the stem reads
        the packed xa, and the update writes x_next's part of another."""
        p = prep[bf16]
        xa = lambda: fs.pack_xa(inp["x"], inp["xc"], p["wst"].shape[1], p["wst"].dtype)
        return [
            ("stem_layer", "", fs.stem_layer, fs.stem_layer_plain,
             (inp["x"], inp["xc"], inp["emb"], inp["pos"], inp["mask"], p), {"xa": xa()}),
            ("decoder_layer", "", fl.decoder_layer, fl.decoder_layer_plain, (inp["h"], inp["mask"], p["layers"][1]),
             {}),
            ("layer_epilogue", " x0", fs.layer_epilogue, fs.layer_epilogue_plain,
             (inp["h"], inp["mask"], inp["x"], inp["noise"], (1.0, 0.0, 0.0), None, None, p), {}),
            ("layer_epilogue", " update+inpaint", fs.layer_epilogue, fs.layer_epilogue_plain,
             (inp["h"], inp["mask"], inp["x"], inp["noise"], UPDATE, inp["ipv"], inp["ipm"], p), {"xa": xa()}),
        ]

    def check(name, what, wrapper, plain, args, extra, bf16, t, phase="phase 2"):
        """The wrapper on card tensors against its plain version; the call
        must count once and launch its C entries. An update given xa must
        write x_next in xa's dtype into its x part, bit for bit, and nothing
        else."""
        ck.launch_counts.clear()
        ck.kernel_launches.clear()
        xa0 = extra["xa"].clone() if extra.get("xa") is not None else None
        out_k = wrapper(*args, **kw, **extra)
        counts = (dict(ck.launch_counts), dict(ck.kernel_launches))
        if counts != ({name: 1}, c_launches(name, bf16)):
            raise AssertionError(f"{name}: the wrapper counted/launched {counts}, want {name}: 1, "
                                 f"{c_launches(name, bf16)}")
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        if name == "layer_epilogue" and xa0 is not None and not (
                torch.equal(extra["xa"][..., :d], out_k.to(xa0.dtype))
                and torch.equal(extra["xa"][..., d:], xa0[..., d:])):
            raise AssertionError(f"{name}{what}: xa's x part is not x_next in xa's dtype, or its x_cond part changed")
        if what == " x0" and float((out_p.abs() < 1).float().mean()) < 0.5:
            raise AssertionError("layer_epilogue x0 check: x0 is mostly clipped, the check has no teeth")
        err = float((out_k - out_p).abs().max())
        tol = TOL_BF16 if bf16 else TOL_F32
        log(f"{phase}: {name}{what} {args[0].shape[0]} x {t + 1} tokens {'bf16' if bf16 else 'f32'}: "
            f"max|kernel - plain| = {err:.3e} (bound {tol})")
        if out_k.shape != out_p.shape or not math.isfinite(err) or err > tol:
            raise AssertionError(f"{name}{what} disagrees with its plain version: {err} > {tol}")
        return err

    def library_layer(h, mask, lp):
        """One DecoderLayer from PyTorch library calls in the weights' dtype
        (SDPA, matmul, layer_norm; f32 with TF32 off): the yardstick, never
        called by the port."""
        b, t, _ = h.shape
        x = h.reshape(b * t, dm)
        cdt = lp["wqkv"].dtype
        qkv = (torch.matmul(x.to(cdt), lp["wqkv"].t()).float() + lp["bqkv"]).to(cdt)
        q, k, v = (qkv[:, i * nh * dk:(i + 1) * nh * dk].reshape(b, t, nh, dk).transpose(1, 2)
                   for i in range(3))
        ctx = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b * t, nh * dv)
        m = mask.reshape(b * t, 1)
        h0 = F.layer_norm(torch.matmul(ctx, lp["wfc"].t()).float() + lp["bfc"] + x, (dm,),
                          lp["ln1s"], lp["ln1b"]) * m
        h1 = torch.relu(torch.matmul(h0.to(cdt), lp["w1"].t()).float() + lp["b1"])
        h2 = torch.matmul(h1.to(cdt), lp["w2"].t()).float() + lp["b2"]
        return (F.layer_norm(h2 + h0, (dm,), lp["ln2s"], lp["ln2b"]) * m).reshape(b, t, dm)

    def library(name, inp, bf16=True):
        p = prep[bf16]
        cdt = p["wst"].dtype
        if name == "decoder_layer":
            return lambda: library_layer(inp["h"], inp["mask"], p["layers"][1])
        if name == "stem_layer":
            def run():
                src = torch.cat([inp["x"], inp["xc"]], -1).to(cdt)
                stem = torch.matmul(src, p["wst"][:, :2 * d].t()).float() + p["bst"]
                h = torch.cat([inp["emb"].expand(BATCH, 1, dm), stem], 1) + inp["pos"]
                return library_layer(h, inp["mask"], p["layers"][0])
            return run

        def run():
            t = inp["x"].shape[1]
            h = library_layer(inp["h"], inp["mask"], p["layers"][-1])
            x0 = torch.clamp(torch.matmul(h[:, 1:t + 1].to(cdt), p["lw"][:d].t()).float() + p["lb"], -1, 1)
            a1, a2, a3 = UPDATE
            xn = a1 * x0 + a2 * inp["x"] + a3 * inp["noise"]
            return xn + inp["ipm"][..., None] * (inp["ipv"] - xn)
        return run

    def cost(name, t, es=2):
        """FLOPs and the bytes each input is read once and each output
        written once, for one call at BATCH windows of t frames, weights and
        the packed xa of es bytes an element (bf16; 4 in f32 compute)."""
        tok = BATCH * (t + 1)
        flops = (2 * tok * dm * nh * (2 * dk + dv) + 2 * BATCH * nh * (t + 1) ** 2 * (dk + dv)
                 + 2 * tok * nh * dv * dm + 4 * tok * dm * dm)
        wbytes = es * (dm * nh * (2 * dk + dv) + nh * dv * dm + 2 * dm * dm) + 4 * (nh * (2 * dk + dv) + 7 * dm)
        act = 4 * tok * dm
        nbytes = wbytes + 4 * tok  # weights + mask
        if name == "stem_layer":  # reads the packed xa (400 wide)
            flops += 2 * BATCH * t * 2 * d * dm
            nbytes += es * BATCH * t * 400 + 4 * dm + 4 * (t + 1) * dm + es * 2 * d * dm + 4 * dm + act
        elif name == "decoder_layer":
            nbytes += 2 * act
        else:  # and writes x_next into xa
            flops += 2 * BATCH * t * dm * d
            nbytes += act + 4 * 4 * BATCH * t * d + 4 * BATCH * t + es * dm * d + 4 * d + es * BATCH * t * d
        return flops, nbytes

    def launch_parts(inp):
        """The launches of one step, each alone on the operands the chain
        gives it: {name: (launch, (M, K, N) of its product or None, the
        tensors it reads, the tensors it writes)}. The five launches of a
        layer, then the stem's and the update's GEMM; the attention (on the
        QKV launch's output, whatever it holds) and the stem's and the
        update's GEMM also carry a check against their plain versions (2e-2
        of max|launch - plain|, and the GEMMs' bf16 copies bit for bit: inf
        otherwise)."""
        p = prep[True]
        lp = p["layers"][1]
        b, t1, _ = inp["h"].shape
        rows, t = b * t1, t1 - 1
        bf = torch.bfloat16
        x, m = inp["h"].reshape(rows, dm), inp["mask"].reshape(rows)
        xb = x.to(bf)  # the bf16 copy that the previous layer's last epilogue writes
        n_qkv = lp["wqkv"].shape[0]
        qkv = torch.empty(rows, n_qkv, dtype=bf, device=dev)
        ctx = torch.empty(rows, nh * dv, dtype=bf, device=dev)
        h0, h0b = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, dtype=bf, device=dev)
        h1 = torch.empty(rows, dm, dtype=bf, device=dev)
        out, outb = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, dtype=bf, device=dev)
        stem, stemb = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, dtype=bf, device=dev)
        step = torch.empty(b * t, d, device=dev)
        xa, xa_step = (fs.pack_xa(inp["x"], inp["xc"], p["wst"].shape[1]) for _ in range(2))
        hb = inp["h"].to(bf)  # the last layer's bf16 copy
        ln1 = [x, lp["ln1s"], lp["ln1b"], m]
        ln2 = [h0, lp["ln2s"], lp["ln2b"], m]
        # {name: (launch, (M, K, N) or None, reads, writes[, max|launch - plain| after a launch])}
        return {
            "qkv": (lambda: ck.gemm(ck.BIAS, xb, lp["wqkv"], lp["bqkv"], qkv, M=rows),
                    (rows, dm, n_qkv), [xb, lp["wqkv"], lp["bqkv"]], [qkv]),
            "attention": (lambda: ck.attention(qkv, ctx, B=b, T=t1, t_keys=t1, **kw), None, [qkv], [ctx],
                          lambda: float((ctx.float() - fl.attention_plain(
                              qkv, B=b, T=t1, t_keys=t1, **kw, bf16=True)).abs().max())),
            "fc_ln": (lambda: ck.gemm(ck.LAYER_NORM, ctx, lp["wfc"], lp["bfc"], h0, M=rows, res=x,
                                      ln_s=lp["ln1s"], ln_b=lp["ln1b"], row_mask=m, out_b=h0b),
                      (rows, nh * dv, dm), [ctx, lp["wfc"], lp["bfc"], *ln1], [h0, h0b]),
            "w1_relu": (lambda: ck.gemm(ck.BIAS_RELU, h0b, lp["w1"], lp["b1"], h1, M=rows),
                        (rows, dm, dm), [h0b, lp["w1"], lp["b1"]], [h1]),
            "w2_ln": (lambda: ck.gemm(ck.LAYER_NORM, h1, lp["w2"], lp["b2"], out, M=rows, res=h0,
                                      ln_s=lp["ln2s"], ln_b=lp["ln2b"], row_mask=m, out_b=outb),
                      (rows, dm, dm), [h1, lp["w2"], lp["b2"], *ln2], [out, outb]),
            "stem": (lambda: ck.gemm(ck.STEM, xa.reshape(b * t, -1), p["wst"], p["bst"], stem, M=rows,
                                     pos=inp["pos"], emb=inp["emb"], t_data=t, out_b=stemb),
                     (b * t, 2 * d, dm), [xa, p["wst"], p["bst"], inp["pos"], inp["emb"]], [stem, stemb],
                     lambda: max(float((stem.reshape(b, t1, dm) - fs.stem_tokens_plain(
                         inp["x"], inp["xc"], inp["emb"], inp["pos"], p)).abs().max()),
                         0.0 if torch.equal(stemb, stem.to(bf)) else math.inf)),
            "step": (lambda: ck.gemm(ck.STEP, hb, p["lw"], p["lb"], step, M=b * t, x=inp["x"], noise=inp["noise"],
                                     ipv=inp["ipv"], ipm=inp["ipm"], t_data=t, scal=UPDATE, out_b=xa_step),
                     (b * t, dm, d), [hb[:, 1:], p["lw"][:d], p["lb"], inp["x"], inp["noise"], inp["ipv"], inp["ipm"]],
                     [step, xa_step[..., :d]],
                     lambda: max(float((step.reshape(b, t, d) - fs.step_update_plain(
                         hb.float(), inp["x"], inp["noise"], UPDATE, inp["ipv"], inp["ipm"], p)).abs().max()),
                         0.0 if torch.equal(xa_step[..., :d], step.reshape(b, t, d).to(bf)) else math.inf)),
        }

    def launch_table(inp):
        """Per launch of one step: its device time (torch.profiler) and per-
        call time (CUDA events around one Python call; the difference is the
        wrapper's host cost), beside cuBLAS (torch.matmul bf16 at the same
        M, K, N; SDPA bf16 for the attention) on the device, both rates, and
        the bound: max(operations / 989 TFLOP/s, bytes / 3.35 TB/s), each
        input read once and each output written once."""
        b, t1, _ = inp["h"].shape
        table = {}
        for name, (fn, mkn, reads, writes, *err) in launch_parts(inp).items():
            if mkn is None:
                flops = 2 * b * nh * t1 * t1 * (dk + dv)
                q, k, v = (torch.randn(b, nh, t1, dk, generator=g, device=dev, dtype=torch.bfloat16)
                           for _ in range(3))
                lib = lambda: F.scaled_dot_product_attention(q, k, v)
            else:
                flops = 2 * mkn[0] * mkn[1] * mkn[2]
                a_l = torch.randn(mkn[0], mkn[1], generator=g, device=dev).to(torch.bfloat16)
                w_l = torch.randn(mkn[1], mkn[2], generator=g, device=dev).to(torch.bfloat16)
                lib = lambda: torch.matmul(a_l, w_l)
            nbytes = sum(x.numel() * x.element_size() for x in reads + writes)
            r = {"mkn": mkn, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                 "bound_ops_ms": flops / PEAK_BF16 * 1e3, "bound_bytes_ms": nbytes / HBM_BYTES_S * 1e3}
            r["bound_ms"] = max(r["bound_ops_ms"], r["bound_bytes_ms"])
            r["ms"] = cuda_time_ms(fn)
            r["device_ms"], names = device_time_ms(fn)
            r["host_ms"] = r["ms"] - r["device_ms"]
            r["library_device_ms"], _ = device_time_ms(lib)
            r["tflops"] = flops / r["device_ms"] / 1e9
            r["library_tflops"] = flops / r["library_device_ms"] / 1e9
            r["kernels"] = names
            if err:
                fn()
                r["max_abs_err"] = err[0]()
                if not r["max_abs_err"] <= TOL_BF16:
                    raise AssertionError(f"launch {name} {BATCH}x{t1}: max|launch - plain| = {r['max_abs_err']} "
                                         f"(inf: its bf16 copy is not the rounding of its f32 output)")
                log(f"phase 2: launch {name} {BATCH}x{t1}: max|launch - plain| = {r['max_abs_err']:.3e} "
                    f"(bound {TOL_BF16}){'' if name == 'attention' else ', bf16 copy bit for bit'}")
            table[name] = r
            log(f"phase 2: launch {name} {BATCH}x{t1} tokens (M, K, N) = {mkn}: device {r['device_ms']:.4f} ms "
                f"({r['tflops']:.1f} TFLOP/s), per call {r['ms']:.4f} ms (host {r['host_ms']:.4f}); "
                f"{'SDPA' if mkn is None else 'torch.matmul'} bf16 device {r['library_device_ms']:.4f} ms "
                f"({r['library_tflops']:.1f} TFLOP/s); bound {r['bound_ms']:.4f} ms (ops {r['bound_ops_ms']:.4f}, "
                f"bytes {r['bound_bytes_ms']:.4f}; {r['gflop']:.2f} GFLOP, {r['mbytes']:.1f} MB); {names} [{card}]")
        return table

    def attention_table():
        """The layer's attention launch alone at ATTN_SHAPES (bf16, head
        width 256, t_keys = T, on a QKV launch's output): the wgmma kernel
        and the WMMA kernel it replaced there, each against attention_plain,
        and SDPA bf16 on the same q, k, v views; device ms (torch.profiler),
        per-call ms and the bound, max(operations / 989 TFLOP/s, bytes /
        3.35 TB/s) with qkv read once and ctx written once."""
        lp = prep[True]["layers"][1]
        table = {}
        for b, t1 in ATTN_SHAPES:
            h = torch.randn(b, t1, dm, generator=g, device=dev)
            qkv = torch.empty(b * t1, lp["wqkv"].shape[0], dtype=torch.bfloat16, device=dev)
            ck.gemm(ck.BIAS, h.reshape(b * t1, dm).to(torch.bfloat16), lp["wqkv"], lp["bqkv"], qkv, M=b * t1)
            want = fl.attention_plain(qkv, B=b, T=t1, t_keys=t1, **kw, bf16=True)
            q, k, v = (qkv[:, i * nh * dk:(i + 1) * nh * dk].reshape(b, t1, nh, dk).transpose(1, 2) for i in range(3))
            flops = 2 * b * nh * t1 * t1 * (dk + dv)
            nbytes = qkv.numel() * 2 + b * t1 * nh * dv * 2
            r = {"gflop": flops / 1e9, "mbytes": nbytes / 1e6, "bound_ops_ms": flops / PEAK_BF16 * 1e3,
                 "bound_bytes_ms": nbytes / HBM_BYTES_S * 1e3}
            r["bound_ms"] = max(r["bound_ops_ms"], r["bound_bytes_ms"])
            r["bound_by"] = "operations" if r["bound_ops_ms"] >= r["bound_bytes_ms"] else "bytes"
            for kernel in ("attention_wgmma", "attention_wmma"):
                ctx = torch.empty(b * t1, nh * dv, dtype=torch.bfloat16, device=dev)
                if kernel == "attention_wgmma":  # the wrapper, as the path calls it
                    run = lambda: ck.attention(qkv, ctx, B=b, T=t1, t_keys=t1, **kw)
                else:  # the kernel it replaced at <= 128 tokens, by its C entry
                    args = ck.attention_args(qkv, ctx, B=b, T=t1, t_keys=t1, **kw, kernel=kernel)
                    run = lambda: ck._check(ck._lib("attention").egoego_attention(
                        ctypes.byref(args), torch.cuda.current_stream().cuda_stream), kernel)
                ck.kernel_launches.clear()
                run()
                torch.cuda.synchronize()
                if dict(ck.kernel_launches) != ({kernel: 1} if kernel == "attention_wgmma" else {}):
                    raise AssertionError(f"{kernel}: launched {dict(ck.kernel_launches)}")
                err = float((ctx.float() - want).abs().max())
                if not err <= TOL_BF16:
                    raise AssertionError(f"{kernel} {b}x{t1}: max|launch - attention_plain| = {err} > {TOL_BF16}")
                dms, names = device_time_ms(run)
                r[kernel] = {"device_ms": dms, "ms": cuda_time_ms(run), "max_abs_err": err, "kernels": names}
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
            r["sdpa_device_ms"], sdpa_names = device_time_ms(sdpa)
            r["sdpa_max_abs_err"] = float((sdpa().transpose(1, 2).reshape(b * t1, -1).float() - want).abs().max())
            r["plain_ms"] = cuda_time_ms(lambda: fl.attention_plain(qkv, B=b, T=t1, t_keys=t1, **kw, bf16=True))
            wg, wm = r["attention_wgmma"], r["attention_wmma"]
            table[f"{b}x{t1}"] = r
            log(f"phase 2: attention {b}x{t1} tokens bf16: wgmma device {wg['device_ms']:.4f} ms (per call "
                f"{wg['ms']:.4f}), WMMA device {wm['device_ms']:.4f} ms (per call {wm['ms']:.4f}), SDPA bf16 device "
                f"{r['sdpa_device_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {r['gflop']:.2f} GFLOP, {r['mbytes']:.1f} MB); max|launch - plain| wgmma "
                f"{wg['max_abs_err']:.3e}, WMMA {wm['max_abs_err']:.3e}, SDPA {r['sdpa_max_abs_err']:.3e} "
                f"(bound {TOL_BF16}); {wg['kernels']} {wm['kernels']} {sdpa_names} [{card}]")
        if not table[f"{BATCH}x121"]["attention_wgmma"]["device_ms"] <= table[f"{BATCH}x121"]["attention_wmma"][
                "device_ms"]:
            raise AssertionError("attention_wgmma is slower than the WMMA kernel it replaced at 64 x 121")
        return table

    def step_profile(inp, steps=20, bf16=True):
        """Wall time of `steps` reverse steps (host clock around
        synchronize), the device-busy share and the device ms a step from
        torch.profiler; the stem packs xa each step."""
        p = prep[bf16]
        step = lambda: fs.fused_denoise_step(inp["x"], inp["xc"], inp["emb"], inp["pos"], inp["mask"],
                                             inp["noise"], UPDATE, None, None, p, **kw)
        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
        out = {"step_ms": wall / steps * 1e3}
        out["device_busy_share"] = busy_us * 1e-6 / wall if busy_us > 0 else "not measured"
        out["device_ms"] = busy_us / steps / 1e3 if busy_us > 0 else "not measured"
        return out

    def f32_launch_table(inp, gate):
        """Per launch of one f32 step (the CLIs' default numerics), each alone
        on the operands the chain gives it: its device time (torch.profiler)
        beside the CUDA-core kernel it replaced at the same layout
        (gemm_f32_kernel through ck.gemm_cuda_cores; the CUDA-core attention
        kernel by its C entry), torch.matmul f32 at the same (M, K, N) (SDPA
        f32 for the attention), both bounds (3xTF32: 3 operations / 495
        TFLOP/s; the f32 CUDA cores: operations / 67 TFLOP/s; each against
        bytes / 3.35 TB/s, each input read once and each output written once)
        and max|launch - plain| (TOL_F32; the update's f32 xa bit for bit).
        gate: fail if a GEMM launch is not faster than gemm_f32_kernel."""
        p = prep[False]
        lp = p["layers"][1]
        b, t1, _ = inp["h"].shape
        rows, t = b * t1, t1 - 1
        x, m = inp["h"].reshape(rows, dm), inp["mask"].reshape(rows)
        n_qkv = lp["wqkv"].shape[0]
        # the chain's operands: each launch's input is its producer's output
        qkv, ctx = torch.empty(rows, n_qkv, device=dev), torch.empty(rows, nh * dv, device=dev)
        h0, h1 = torch.empty(rows, dm, device=dev), torch.empty(rows, dm, device=dev)
        ln1 = dict(res=x, ln_s=lp["ln1s"], ln_b=lp["ln1b"], row_mask=m)
        ln2 = dict(res=h0, ln_s=lp["ln2s"], ln_b=lp["ln2b"], row_mask=m)
        ck.gemm(ck.BIAS, x, lp["wqkv_split"], lp["bqkv"], qkv, M=rows)
        ck.attention(qkv, ctx, B=b, T=t1, t_keys=t1, **kw)
        ck.gemm(ck.LAYER_NORM, ctx, lp["wfc_split"], lp["bfc"], h0, M=rows, **ln1)
        ck.gemm(ck.BIAS_RELU, h0, lp["w1_split"], lp["b1"], h1, M=rows)
        xa = fs.pack_xa(inp["x"], inp["xc"], p["wst"].shape[1], torch.float32)
        xa_step = xa.clone()
        stem_kw = dict(pos=inp["pos"], emb=inp["emb"], t_data=t)
        step_kw = dict(x=inp["x"], noise=inp["noise"], ipv=inp["ipv"], ipm=inp["ipm"], t_data=t, scal=UPDATE)
        # name: (mode, A, params, weight, bias, M, keywords, (M, K, N) of the product, other reads)
        gemms = {
            "qkv": (ck.BIAS, x, lp, "wqkv", lp["bqkv"], rows, {}, (rows, dm, n_qkv), []),
            "fc_ln": (ck.LAYER_NORM, ctx, lp, "wfc", lp["bfc"], rows, ln1, (rows, nh * dv, dm), [x, m, lp["ln1s"],
                                                                                              lp["ln1b"]]),
            "w1_relu": (ck.BIAS_RELU, h0, lp, "w1", lp["b1"], rows, {}, (rows, dm, dm), []),
            "w2_ln": (ck.LAYER_NORM, h1, lp, "w2", lp["b2"], rows, ln2, (rows, dm, dm), [h0, m, lp["ln2s"],
                                                                                        lp["ln2b"]]),
            "stem": (ck.STEM, xa.reshape(b * t, -1), p, "wst", p["bst"], rows, stem_kw, (b * t, 2 * d, dm),
                     [inp["pos"], inp["emb"]]),
            "step": (ck.STEP, inp["h"], p, "lw", p["lb"], b * t, step_kw, (rows, dm, d),
                     [inp["x"], inp["noise"], inp["ipv"], inp["ipm"]]),
        }
        table = {}

        def row(name, mkn, flops, nbytes, run, old, lib, err, want_launch):
            ck.launch_counts.clear()
            ck.kernel_launches.clear()
            run()
            torch.cuda.synchronize()
            if dict(ck.kernel_launches) != {want_launch: 1}:
                raise AssertionError(f"f32 launch {name}: launched {dict(ck.kernel_launches)}, want {want_launch}")
            r = {"mkn": mkn, "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "max_abs_err": err(),
                 "bound_ms": max(3 * flops / PEAK_TF32, nbytes / HBM_BYTES_S) * 1e3,
                 "bound_f32_core_ms": max(flops / PEAK_F32, nbytes / HBM_BYTES_S) * 1e3}
            r["bound_by"] = "operations" if 3 * flops / PEAK_TF32 >= nbytes / HBM_BYTES_S else "bytes"
            if not r["max_abs_err"] <= TOL_F32:
                raise AssertionError(f"f32 launch {name} {b}x{t1}: max|launch - plain| = {r['max_abs_err']} > "
                                     f"{TOL_F32} (inf: the update's xa is not its f32 x_next)")
            r["device_ms"], r["kernels"] = device_time_ms(run)
            r["cores_device_ms"], _ = device_time_ms(old)
            r["library_device_ms"], _ = device_time_ms(lib)
            r["tflops"] = flops / r["device_ms"] / 1e9
            table[name] = r
            log(f"phase 2: f32 launch {name} {b}x{t1} tokens (M, K, N) = {mkn}: device {r['device_ms']:.4f} ms "
                f"({r['tflops']:.1f} TFLOP/s of f32 work), the CUDA-core kernel {r['cores_device_ms']:.4f} ms, "
                f"{'SDPA' if mkn is None else 'torch.matmul'} f32 {r['library_device_ms']:.4f} ms; bound 3xTF32 "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), f32 cores {r['bound_f32_core_ms']:.4f} ms "
                f"({r['gflop']:.2f} GFLOP, {r['mbytes']:.1f} MB); max|launch - plain| {r['max_abs_err']:.3e} "
                f"(bound {TOL_F32}); {r['kernels']} [{card}]")
            if gate and mkn is not None and not r["device_ms"] < r["cores_device_ms"]:
                raise AssertionError(f"f32 launch {name} {b}x{t1}: gemm_tf32x3 {r['device_ms']:.4f} ms is not faster "
                                     f"than gemm_f32_kernel's {r['cores_device_ms']:.4f} ms")

        for name, (mode, a, prm, wname, bias, mm, kwargs, mkn, extra) in gemms.items():
            n = bias.numel()
            out, out_old = torch.empty(mm, n, device=dev), torch.empty(mm, n, device=dev)
            xa_kw = {"out_b": xa_step} if mode == ck.STEP else {}
            a_l = a.reshape(-1, a.shape[-1])[:, :mkn[1]].contiguous()
            w_l = prm[wname][:n, :mkn[1]].t()

            def err(mode=mode, a=a, prm=prm, wname=wname, bias=bias, mm=mm, kwargs=kwargs, out=out):
                want = ck.gemm_plain(mode, a, prm[wname + "_split"], bias, torch.empty_like(out), M=mm, **kwargs)
                e = float((out - want).abs().max())
                if mode == ck.STEP and not torch.equal(xa_step[..., :d], out.reshape(b, t, d)):
                    e = math.inf
                return e
            reads = [a, prm[wname][:n], bias, *extra]
            nbytes = 4 * sum(x_.numel() for x_ in reads) + 4 * out.numel() * (2 if mode == ck.STEP else 1)
            row(name, mkn, 2 * mkn[0] * mkn[1] * mkn[2], nbytes,
                lambda mode=mode, a=a, prm=prm, wname=wname, bias=bias, mm=mm, kwargs=kwargs, out=out, xa_kw=xa_kw:
                    ck.gemm(mode, a, prm[wname + "_split"], bias, out, M=mm, **kwargs, **xa_kw),
                lambda mode=mode, a=a, prm=prm, wname=wname, bias=bias, mm=mm, kwargs=kwargs, out_old=out_old:
                    ck.gemm_cuda_cores(mode, a, prm[wname], bias, out_old, M=mm, **kwargs),
                lambda a_l=a_l, w_l=w_l: torch.matmul(a_l, w_l), err, "gemm_tf32x3")
            if name == "qkv":  # the attention, on this launch's output
                ctx_k, ctx_c = torch.empty_like(ctx), torch.empty_like(ctx)
                args = ck.attention_args(qkv, ctx_c, B=b, T=t1, t_keys=t1, **kw, kernel="attention")
                q, k, v, _ = ck.qkv_heads(qkv, ctx, B=b, T=t1, **kw)
                row("attention", None, 2 * b * nh * t1 * t1 * (dk + dv), 4 * (qkv.numel() + ctx.numel()),
                    lambda: ck.attention(qkv, ctx_k, B=b, T=t1, t_keys=t1, **kw),
                    lambda: ck._check(ck._lib("attention").egoego_attention(
                        ctypes.byref(args), torch.cuda.current_stream().cuda_stream), "attention"),
                    lambda: F.scaled_dot_product_attention(q, k, v),
                    lambda: float((ctx_k - fl.attention_plain(qkv, B=b, T=t1, t_keys=t1, **kw)).abs().max()), "mha")
        return table

    results, f32_step = {}, {}
    for t in (cfg.window, 30):
        inp = inputs(t)
        for bf16 in (False, True):
            for name, what, wrapper, plain, args, extra in calls(inp, bf16):
                err = check(name, what, wrapper, plain, args, extra, bf16, t)
                r = results.setdefault(name, {"max_abs_err": 0.0, "max_abs_err_f32": 0.0})
                key = "max_abs_err" if bf16 else "max_abs_err_f32"
                r[key] = max(r[key], err)
        if t == cfg.window:
            timed = {name: (wrapper, plain, args, extra) for name, _, wrapper, plain, args, extra in calls(inp, True)}
            for name, (wrapper, plain, args, extra) in timed.items():
                flops, nbytes = cost(name, t)
                r = results[name]
                r["ms"] = cuda_time_ms(lambda: wrapper(*args, **kw, **extra))
                r["plain_ms"] = cuda_time_ms(lambda: plain(*args, **kw))
                r["library_ms"] = cuda_time_ms(library(name, inp))
                r["device_ms"], _ = device_time_ms(lambda: wrapper(*args, **kw, **extra), chain=True)
                r["library_device_ms"], _ = device_time_ms(library(name, inp), chain=True)
                t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3
                r["bound_ms"] = max(t_ops, t_bytes)
                r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
                r["gflop"] = flops / 1e9
                r["mbytes"] = nbytes / 1e6
                log(f"phase 2: {name} bf16 {BATCH}x{t + 1} tokens: kernel {r['ms']:.3f} ms (device "
                    f"{r['device_ms']:.4f}), plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms (device "
                    f"{r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) [{card}]")
            step_prof = step_profile(inp)
            log(f"phase 2: one reverse step, bf16 {BATCH}x{t + 1} tokens: {step_prof} [{card}]")
        # the f32 mode (the CLIs' default), at both windows: each wrapper as the chain calls it, and the step
        shape = f"{BATCH}x{t + 1}"
        timed = {name: (wrapper, plain, args, extra) for name, _, wrapper, plain, args, extra in calls(inp, False)}
        for name, (wrapper, plain, args, extra) in timed.items():
            flops, nbytes = cost(name, t, es=4)
            run = lambda: wrapper(*args, **kw, **extra)
            r = results[name].setdefault("f32", {})[shape] = {
                "ms": cuda_time_ms(run), "plain_ms": cuda_time_ms(lambda: plain(*args, **kw)),
                "library_ms": cuda_time_ms(library(name, inp, bf16=False)),
                "device_ms": device_time_ms(run, chain=True)[0],
                "library_device_ms": device_time_ms(library(name, inp, bf16=False), chain=True)[0],
                "bound_ms": max(3 * flops / PEAK_TF32, nbytes / HBM_BYTES_S) * 1e3,
                "bound_f32_core_ms": max(flops / PEAK_F32, nbytes / HBM_BYTES_S) * 1e3,
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
            log(f"phase 2: {name} f32 {shape} tokens: kernel {r['ms']:.3f} ms (device "
                f"{r['device_ms']:.4f}), plain {r['plain_ms']:.3f} ms, library f32 {r['library_ms']:.3f} ms "
                f"(device {r['library_device_ms']:.4f}), bound 3xTF32 {r['bound_ms']:.4f} ms, f32 cores "
                f"{r['bound_f32_core_ms']:.4f} ms ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) [{card}]")
        r = f32_step[shape] = {"device_ms": sum(n * results[name]["f32"][shape]["device_ms"] for name, n in (
            ("stem_layer", 1), ("decoder_layer", cfg.n_dec_layers - 2), ("layer_epilogue", 1)))}
        r.update({f"profile_{k}": v for k, v in step_profile(inp, bf16=False).items()})
        log(f"phase 2: one reverse step, f32 {shape} tokens: device {r['device_ms']:.4f} ms (stem_layer + "
            f"{cfg.n_dec_layers - 2} x decoder_layer + layer_epilogue); under the profiler "
            f"{ {k: v for k, v in r.items() if k.startswith('profile_')} } [{card}]")
        results["decoder_layer"].setdefault("launch_table", {})[f"{BATCH}x{t + 1}"] = launch_table(inp)
        results["decoder_layer"].setdefault("f32_launch_table", {})[f"{BATCH}x{t + 1}"] = f32_launch_table(
            inp, gate=t == cfg.window)
    results["decoder_layer"]["attention_launch"] = attention_table()
    del prep, inp

    # synthetic AMASS-layout records, stats and rest offsets (seeded)
    data_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    def motion(n, t):
        return {i: {
            "seq_name": f"Transitions_mocap-synthetic{i}",
            "trans": (np.cumsum(rng.randn(t, 3) * 0.01, 0) + [0.0, 0.0, 0.9]).astype(np.float32),
            "root_orient": (rng.randn(t, 3) * 0.1).astype(np.float32),
            "body_pose": (rng.randn(t, 63) * 0.1).astype(np.float32),
        } for i in range(n)}

    data_path = os.path.join(data_dir, "amass_test.p")
    with open(data_path, "wb") as f:
        pickle.dump(motion(BATCH, cfg.window), f)
    stats_path = os.path.join(data_dir, "stats.p")
    with open(stats_path, "wb") as f:
        pickle.dump({"global_jpos_min": np.full((22, 3), -1.5, np.float32),
                     "global_jpos_max": np.full((22, 3), 1.5, np.float32)}, f)
    rest_path = os.path.join(data_dir, "rest.npy")
    np.save(rest_path, np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32))
    per_step = {"stem_layer": 1, "decoder_layer": cfg.n_dec_layers - 2, "layer_epilogue": 1}

    def c_per_step(bf16=True):  # C-entry launches of one reverse step
        return {k: sum(n * c_launches(w, bf16).get(k, 0) for w, n in per_step.items())
                for k in c_launches("stem_layer", bf16)}

    def clear_counts():
        ck.launch_counts.clear()
        ck.kernel_launches.clear()

    def check_counts(windows, steps, what, bf16=True):
        got = {k: ck.launch_counts[k] for k in per_step}
        want = {k: windows * steps * v for k, v in per_step.items()}
        got_c = dict(ck.kernel_launches)
        want_c = {k: windows * steps * v for k, v in c_per_step(bf16).items()}
        log(f"{what}: launches {got} (expected {want}); C entries {got_c} (expected {want_c})")
        if got != want or got_c != want_c:
            raise AssertionError(f"{what}: launch counts {got}, {got_c} != {want}, {want_c}")
        return got

    # -- phase 3: main path A, the eval_stage2 CLI --------------------------
    opt = eval_stage2.parse_opt([
        "--test_data_path", data_path, "--stats_path", stats_path, "--rest_offsets", rest_path,
        "--batch_seqs", str(BATCH), "--fused_step", "--out_dir", os.path.join(data_dir, "out"), "--device", "cuda"])
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eval_stage2.run(opt)
    torch.cuda.synchronize()
    dt_a = time.perf_counter() - t0
    check_counts(1, cfg.timesteps, "phase 3")
    if res["num_seqs"] != BATCH or not all(math.isfinite(v) for v in res["mean"].values()):
        raise AssertionError(f"phase 3: bad eval result {res['mean']}")
    log(f"phase 3: eval_stage2 --fused_step {BATCH} seqs x {cfg.window} frames DDPM-{cfg.timesteps} bf16 in {dt_a:.2f} s "
        f"({BATCH / dt_a:.2f} seqs/s) [{card}]; mpjpe {res['mean']['mpjpe']:.1f} mm (random weights)")

    # -- phase 4: main path B, the two-window chain -------------------------
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, device=dev, compute_dtype="bfloat16")
    mo = motion(BATCH, 140)
    _, _, head = pl.gt_from_smpl_params_batched(
        pipe, *(np.stack([mo[i][k] for i in range(BATCH)]) for k in ("trans", "root_orient", "body_pose")))
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aa, root = pipe.stage2_generate_batched(head, fs.TorchNoise(dev, seed=3))
    torch.cuda.synchronize()
    dt_b = time.perf_counter() - t0
    launches = check_counts(2, cfg.timesteps, "phase 4 DDPM")
    if aa.shape != (BATCH, 140, 22, 3) or root.shape != (BATCH, 140, 3):
        raise AssertionError(f"phase 4: shapes {tuple(aa.shape)}, {tuple(root.shape)}")
    if not (torch.isfinite(aa).all() and torch.isfinite(root).all()):
        raise AssertionError("phase 4: non-finite output")
    log(f"phase 4: DDPM-{cfg.timesteps} chain, {BATCH} x 140 frames (2 windows) in {dt_b:.2f} s "
        f"({BATCH / dt_b:.2f} seqs/s, {dt_b / (2 * cfg.timesteps) * 1e3:.3f} ms/step) [{card}]")

    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, device=dev, sampler="ddim",
                          compute_dtype="bfloat16")
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aa_d, root_d = pipe.stage2_generate_batched(head, fs.TorchNoise(dev, seed=4))
    torch.cuda.synchronize()
    dt_d = time.perf_counter() - t0
    check_counts(2, cfg.ddim_steps, "phase 4 DDIM")
    if not (torch.isfinite(aa_d).all() and torch.isfinite(root_d).all()):
        raise AssertionError("phase 4 DDIM: non-finite output")
    log(f"phase 4: DDIM-{cfg.ddim_steps} chain in {dt_d:.2f} s ({BATCH / dt_d:.2f} seqs/s) [{card}]")

    # -- phase 5: f32, the CLI's default, and the f32 chain vs the CPU -------
    seqs_f32 = 4
    opt = eval_stage2.parse_opt([
        "--test_data_path", data_path, "--stats_path", stats_path, "--rest_offsets", rest_path,
        "--batch_seqs", str(seqs_f32), "--max_seqs", str(seqs_f32), "--ddim_steps", str(cfg.ddim_steps),
        "--out_dir", os.path.join(data_dir, "out_f32"), "--device", "cuda"])
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_f32 = eval_stage2.run(opt)
    torch.cuda.synchronize()
    dt_f32 = time.perf_counter() - t0
    check_counts(1, cfg.ddim_steps, "phase 5 eval_stage2 (no flag: f32)", bf16=False)
    if res_f32["num_seqs"] != seqs_f32 or not all(math.isfinite(v) for v in res_f32["mean"].values()):
        raise AssertionError(f"phase 5: bad eval result {res_f32['mean']}")
    log(f"phase 5: eval_stage2 (no flag: f32) {seqs_f32} seqs x {cfg.window} frames DDIM-{cfg.ddim_steps} in "
        f"{dt_f32:.2f} s [{card}]")

    # both runs draw the same noise from a CPU generator; the sampler moves
    # each draw to its own device
    outs = {}
    for where in (dev, torch.device("cpu")):
        p = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, device=where,
                           sampler="ddim", compute_dtype="float32")
        outs[where.type] = [o.cpu() for o in p.stage2_generate_batched(head[:2, :40].cpu(),
                                                                       fs.TorchNoise("cpu", seed=5))]
    chain_err = max(float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    log(f"phase 5: DDIM-{cfg.ddim_steps} f32 chain, 2 x 40 frames: max|card kernels - CPU plain| = {chain_err:.3e}")
    if not chain_err < 1e-3:
        raise AssertionError(f"phase 5: card and CPU chains disagree by {chain_err}")

    # -- phase 6: the kernels of the --fused and stage-1 routes -------------
    def timed(r, flops, nbytes, peak, kernel, plain, lib, ops="operations"):
        """Per-call times and the bound: ops names the operation rate."""
        r["ms"], r["plain_ms"], r["library_ms"] = cuda_time_ms(kernel), cuda_time_ms(plain), cuda_time_ms(lib)
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = ops if t_ops >= t_bytes else "bytes"
        r["gflop"], r["mbytes"] = flops / 1e9, nbytes / 1e6

    def check_once(what, fn, want):
        clear_counts()
        out = fn()
        counts = (dict(ck.launch_counts), dict(ck.kernel_launches))
        if counts != want:
            raise AssertionError(f"{what}: the wrapper counted/launched {counts}, want {want}")
        return out

    # HeadFormer attention at the release width: 4 heads of 256, f32. The
    # first shape is path D's (300 frames in 2 blocks of 256). The kernel
    # runs three TF32 products for each f32 product, so its bound is
    # 3 FLOPs / PEAK_TF32 (the f32 CUDA-core bound is printed beside it).
    # Per-call ms (CUDA events around one Python call) include the
    # wrapper's host time; device ms (torch.profiler) do not.
    hn_h, hn_d = 4, 256
    blocks_d = -(-FRAMES_D // HEADNET_WINDOW_D)
    fa = {"max_abs_err": 0.0, "per_shape": [],
          "mma_sync_tf32_tflops": mma_sync_tf32_tflops(ck._nvcc(), data_dir)}
    log(f"phase 6: mma.sync m16n8k8 TF32 alone on this card: {fa['mma_sync_tf32_tflops']:.1f} TFLOP/s "
        f"(3xTF32 f32-accurate ceiling of an mma.sync kernel: {fa['mma_sync_tf32_tflops'] / 3:.1f}) [{card}]")
    for b, t in ((blocks_d, HEADNET_WINDOW_D), (8, 256), (4, 300), (2, 1024)):
        q, k, v = (torch.randn(b, t, hn_h, hn_d, generator=g, device=dev).transpose(1, 2) for _ in range(3))
        out_k = check_once("fused_attention", lambda: attn.fused_attention(q, k, v),
                           ({"fused_attention": 1}, {"mha": 1}))
        out_p = attn.fused_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        if out_k.shape != out_p.shape or not math.isfinite(err) or err > TOL_F32:
            raise AssertionError(f"fused_attention {(b, hn_h, t, hn_d)} disagrees with its plain version: {err}")
        fa["max_abs_err"] = max(fa["max_abs_err"], err)
        kernel = lambda: attn.fused_attention(q, k, v)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
        sdpa_err = float((sdpa() - out_p).abs().max())
        flops, nbytes = 2 * b * hn_h * t * t * 2 * hn_d, 4 * b * hn_h * t * 4 * hn_d
        r = {"shape": f"({b}, {hn_h}, {t}, {hn_d})", "max_abs_err": err, "library_max_abs_err": sdpa_err}
        timed(r, 3 * flops, nbytes, PEAK_TF32, kernel, lambda: attn.fused_attention_plain(q, k, v), sdpa,
              ops="operations (3xTF32)")
        r["bound_f32_core_ms"] = max(flops / PEAK_F32, nbytes / HBM_BYTES_S) * 1e3
        r["gflop"] = flops / 1e9
        r["device_ms"], k_names = device_time_ms(kernel)
        r["library_device_ms"], lib_names = device_time_ms(sdpa)
        r["tflops"] = flops / r["device_ms"] / 1e9
        r["library_tflops"] = flops / r["library_device_ms"] / 1e9
        log(f"phase 6: fused_attention f32 {r['shape']}: max|kernel - plain| = {err:.3e} (bound {TOL_F32}), "
            f"max|SDPA - plain| = {sdpa_err:.3e}; per call: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"SDPA f32 {r['library_ms']:.4f} ms; device: kernel {r['device_ms']:.4f} ms "
            f"({r['tflops']:.1f} TFLOP/s), SDPA f32 {r['library_device_ms']:.4f} ms ({r['library_tflops']:.1f} "
            f"TFLOP/s); bound {r['bound_ms']:.4f} ms ({r['bound_by']}), f32-core bound "
            f"{r['bound_f32_core_ms']:.4f} ms ({flops / 1e9:.3f} GFLOP, {r['mbytes']:.1f} MB) [{card}]")
        log(f"phase 6: fused_attention {r['shape']}: host cost per wrapper call (ms - device ms) "
            f"{r['ms'] - r['device_ms']:.4f} ms; SDPA {r['library_ms'] - r['library_device_ms']:.4f} ms; "
            f"device kernels {k_names} vs SDPA {lib_names}")
        fa["per_shape"].append({key: r[key] for key in (
            "shape", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
            "bound_f32_core_ms", "tflops", "library_tflops", "max_abs_err", "library_max_abs_err")})
        if (b, t) == (blocks_d, HEADNET_WINDOW_D):
            fa.update({key: x for key, x in r.items() if key != "max_abs_err"},
                      shape=f"{b} blocks x {hn_h} heads x {t} tokens x {hn_d}, f32")
    del q, k, v, out_k, out_p

    # fused_decoder_layer: one layer of the --fused denoiser at the path's
    # shapes; a padding-mask zero in every other window
    fdl = {"max_abs_err": 0.0, "max_abs_err_f32": 0.0}
    layer = model.motion_transformer.layer_stack[1]
    for t in (cfg.window, 30):
        h = torch.randn(BATCH, t + 1, dm, generator=g, device=dev)
        mask = torch.ones(BATCH, t + 1, device=dev)
        mask[::2, -2] = 0.0
        for bf16 in (False, True):
            lp = fl.layer_params(layer, bf16=bf16)
            out_k = check_once("fused_decoder_layer", lambda: fl.fused_decoder_layer(h, mask, lp, **kw),
                               ({"fused_decoder_layer": 1}, c_launches("fused_decoder_layer", bf16)))
            out_p = fl.decoder_layer_plain(h, mask, lp, **kw)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            tol = TOL_BF16 if bf16 else TOL_F32
            log(f"phase 6: fused_decoder_layer tokens={t + 1} {'bf16' if bf16 else 'f32'}: "
                f"max|kernel - plain| = {err:.3e} (bound {tol})")
            if out_k.shape != out_p.shape or not math.isfinite(err) or err > tol:
                raise AssertionError(f"fused_decoder_layer disagrees with its plain version: {err} > {tol}")
            key = "max_abs_err" if bf16 else "max_abs_err_f32"
            fdl[key] = max(fdl[key], err)
            if bf16 and t == cfg.window:
                flops, nbytes = cost("decoder_layer", t)
                timed(fdl, flops, nbytes, PEAK_BF16, lambda: fl.fused_decoder_layer(h, mask, lp, **kw),
                      lambda: fl.decoder_layer_plain(h, mask, lp, **kw), lambda: library_layer(h, mask, lp))
                fdl["shape"] = f"{BATCH} windows x {t + 1} tokens, bf16"
                fdl["device_ms"], _ = device_time_ms(lambda: fl.fused_decoder_layer(h, mask, lp, **kw), chain=True)
                fdl["library_device_ms"], _ = device_time_ms(lambda: library_layer(h, mask, lp), chain=True)
                log(f"phase 6: fused_decoder_layer bf16 {BATCH}x{t + 1} tokens: kernel {fdl['ms']:.3f} ms "
                    f"(device {fdl['device_ms']:.4f}), plain {fdl['plain_ms']:.3f} ms, library "
                    f"{fdl['library_ms']:.3f} ms (device {fdl['library_device_ms']:.4f}), bound "
                    f"{fdl['bound_ms']:.4f} ms ({fdl['bound_by']}) [{card}]")
    del h, mask, out_k, out_p

    # -- phase 7: main path C, eval_stage2 --fused --------------------------
    opt = eval_stage2.parse_opt([
        "--test_data_path", data_path, "--stats_path", stats_path, "--rest_offsets", rest_path,
        "--batch_seqs", str(BATCH), "--fused", "--out_dir", os.path.join(data_dir, "out_fused"),
        "--device", "cuda"])
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_c = eval_stage2.run(opt)
    torch.cuda.synchronize()
    dt_c = time.perf_counter() - t0
    n_fdl = cfg.n_dec_layers * cfg.timesteps
    want = ({"fused_decoder_layer": n_fdl},
            {k: n_fdl * v for k, v in c_launches("fused_decoder_layer").items()})
    got = (dict(ck.launch_counts), dict(ck.kernel_launches))
    log(f"phase 7: launches {got[0]} (expected {want[0]}); C entries {got[1]} (expected {want[1]})")
    if got != want:
        raise AssertionError(f"phase 7: launch counts {got} != {want}")
    if res_c["num_seqs"] != BATCH or not all(math.isfinite(v) for v in res_c["mean"].values()):
        raise AssertionError(f"phase 7: bad eval result {res_c['mean']}")
    log(f"phase 7: eval_stage2 --fused {BATCH} seqs x {cfg.window} frames DDPM-{cfg.timesteps} bf16 in "
        f"{dt_c:.2f} s ({BATCH / dt_c:.2f} seqs/s, {dt_c / cfg.timesteps * 1e3:.3f} ms/step) [{card}]; "
        f"mpjpe {res_c['mean']['mpjpe']:.1f} mm (random weights)")

    # -- phase 8: main path D, eval_egoego with HeadNet blocks of 256 --------
    kin_root = os.path.join(data_dir, "kinpoly")
    gt_path = write_kinpoly_fixture(kin_root, np.random.RandomState(7), [FRAMES_D] * SEQS_D)
    opt = eval_egoego.parse_opt([
        "--data_root_folder", kin_root, "--full_body_gt_path", gt_path, "--stats_path", stats_path,
        "--rest_offsets", rest_path, "--headnet_window", str(HEADNET_WINDOW_D), "--fused_step",
        "--out_dir", os.path.join(data_dir, "out_egoego"), "--device", "cuda"])
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_d = eval_egoego.run(opt)
    torch.cuda.synchronize()
    dt_egoego = time.perf_counter() - t0
    got = dict(ck.launch_counts)
    n_fa = 2 * SEQS_D  # HeadNet layers x sequences: one attention call per layer per sequence
    # stage 2 per sequence: a first window, then one per (window - overlap) new frames
    windows = SEQS_D * (1 + math.ceil((FRAMES_D - cfg.window) / (cfg.window - cfg.overlap_frames)))
    want = {"fused_attention": n_fa, "stem_layer": windows * cfg.timesteps,
            "decoder_layer": windows * cfg.timesteps * (cfg.n_dec_layers - 2),
            "layer_epilogue": windows * cfg.timesteps}
    want_c = {"mha": n_fa, **{k: windows * cfg.timesteps * v for k, v in c_per_step().items()}}
    log(f"phase 8: launches {got} (expected {want}, {windows} windows); C entries {dict(ck.kernel_launches)} "
        f"(expected {want_c})")
    if got != want or dict(ck.kernel_launches) != want_c:
        raise AssertionError(f"phase 8: launch counts {got}, {dict(ck.kernel_launches)} != {want}, {want_c}")
    entries = res_d["per_seq"].values()
    if res_d["num_seqs"] != SEQS_D or not all(math.isfinite(v) for e in entries for v in e.values()):
        raise AssertionError(f"phase 8: bad eval result {res_d}")
    log(f"phase 8: eval_egoego {SEQS_D} seqs x {FRAMES_D} frames, HeadNet window {HEADNET_WINDOW_D}, "
        f"DDPM-{cfg.timesteps} in {dt_egoego:.2f} s ({SEQS_D / dt_egoego:.3f} seqs/s) [{card}]; "
        f"s1_t_head {res_d['mean']['s1_t_head']:.1f} mm, mpjpe {res_d['mean']['mpjpe']:.1f} mm (random weights)")

    # stage 1 alone on the same records, per sequence, at window 256 (the
    # mha kernel) and at the release window 60 (einsum attention only)
    ds = eval_egoego.select_dataset(opt)
    records = [ds[i] for i in range(len(ds))]
    stage1 = {}
    for window in (HEADNET_WINDOW_D, 60):
        pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, headnet_window=window,
                              device=dev)
        pipe.stage1_head_pose(records[0])  # warm-up
        clear_counts()
        times, outs = [], []
        for rec in records:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(pipe.stage1_head_pose(rec))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n = ck.launch_counts["fused_attention"]
        want_n = 2 * len(records) if window >= 256 else 0
        if n != want_n or dict(ck.launch_counts).keys() - {"fused_attention"}:
            raise AssertionError(f"stage 1 at window {window}: launches {dict(ck.launch_counts)}, "
                                 f"want fused_attention {want_n} only")
        stage1[window] = {"ms_per_seq": statistics.median(times), "outs": outs}
        log(f"phase 8: stage1_head_pose window {window}: {statistics.median(times):.2f} ms per sequence "
            f"(median of {len(times)}, {FRAMES_D} frames), fused_attention launches {n} [{card}]")
    init = torch.as_tensor(records[0]["head_pose"][0:1, 3:], device=dev)
    vels = torch.randn(1, FRAMES_D, 3, generator=g, device=dev)
    for where in (dev, torch.device("cpu")):
        i_w, v_w = init.to(where), vels.to(where)
        va2rot(i_w, v_w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        va2rot(i_w, v_w)
        torch.cuda.synchronize()
        log(f"phase 8: va2rot over {FRAMES_D} frames on {where.type}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path,
                          headnet_window=HEADNET_WINDOW_D, device=dev)
    pipe.stage1_head_pose(records[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.stage1_head_pose(records[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    n_launch = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in ka)
    busy = (f"device busy {busy_us / 1e3:.2f} ms ({busy_us * 1e-6 / wall:.3f} of the wall time)" if busy_us > 0
            else "device busy not measured (the profiler saw no device time)")
    log(f"phase 8: one stage1_head_pose (window {HEADNET_WINDOW_D}) under the profiler: {wall * 1e3:.2f} ms wall, "
        f"{n_launch} kernel launches, {busy} [{card}]")

    # -- phase 9: stage-1 parity, card (mha kernel) vs CPU (plain) ----------
    pipe_cpu = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path,
                              headnet_window=HEADNET_WINDOW_D, device="cpu")
    err_t = err_q = 0.0
    for rec, out in zip(records, stage1[HEADNET_WINDOW_D]["outs"]):
        ref = pipe_cpu.stage1_head_pose(rec)["head_pose"]
        got_hp = out["head_pose"].cpu()
        if got_hp.shape != ref.shape or not torch.isfinite(got_hp).all():
            raise AssertionError(f"phase 9: head pose {tuple(got_hp.shape)} vs {tuple(ref.shape)}")
        err_t = max(err_t, float((got_hp[:, :3] - ref[:, :3]).abs().max()))
        err_q = max(err_q, float((got_hp[:, 3:] - ref[:, 3:]).abs().max()))
    log(f"phase 9: stage1_head_pose window {HEADNET_WINDOW_D}, card vs CPU over {len(records)} sequences: "
        f"max translation error {err_t:.3e} m (bound 1e-3), max quaternion error {err_q:.3e} (bound 1e-4)")
    if not (err_t < 1e-3 and err_q < 1e-4):
        raise AssertionError(f"phase 9: card and CPU stage 1 disagree: {err_t} m, {err_q}")


    # -- phase 10: main path E, eval_egoego --batch_seqs 4 --fused_step ------
    kin_e = os.path.join(data_dir, "kinpoly_e")
    gt_path_e = write_kinpoly_fixture(kin_e, np.random.RandomState(11), FRAMES_E)
    argv_e = ["--data_root_folder", kin_e, "--full_body_gt_path", gt_path_e, "--stats_path", stats_path,
              "--rest_offsets", rest_path, "--headnet_window", str(HEADNET_WINDOW_D), "--fused_step",
              "--batch_seqs", str(BATCH_E), "--out_dir", os.path.join(data_dir, "out_egoego_e"), "--device", "cuda"]
    n_e = len(FRAMES_E)
    batches_e = sum(math.ceil(FRAMES_E.count(f) / BATCH_E) for f in set(FRAMES_E))
    win_e = {f: 1 + math.ceil((f - cfg.window) / (cfg.window - cfg.overlap_frames)) for f in set(FRAMES_E)}
    if len(set(win_e.values())) != 1:
        raise AssertionError(f"phase 10: the buckets' window counts differ: {win_e}")
    windows_e = batches_e * win_e[FRAMES_E[0]]  # chains x windows a chain (batch_size rows each)

    # the kernels at path E's own shapes, each wrapper on card tensors
    # against its plain version: fused_attention on the q, k, v that the
    # batched HeadNet gives it for 4 sequences of each length (8 or 4
    # blocks of 256, the last of each sequence padded), then the step
    # wrappers at BATCH_E windows of each window length the two buckets'
    # chains run (the first window, the next, the ragged tail)
    ds_e = eval_egoego.select_dataset(eval_egoego.parse_opt(argv_e))
    recs_all = [ds_e[i] for i in range(len(ds_e))]
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, headnet_window=HEADNET_WINDOW_D,
                          device=dev)
    seen_fa, fa_e = [], {"max_abs_err": 0.0}
    real_fa = tf_mod.fused_attention
    tf_mod.fused_attention = lambda q, k, v: seen_fa.append((q, k, v)) or real_fa(q, k, v)
    t_windows = set()
    try:
        for f in sorted(set(FRAMES_E)):
            recs_f = [r for r in recs_all if r["of"].shape[0] == f][:BATCH_E]
            s1_f = pipe.stage1_head_pose_batched(recs_f)
            t_chain = min(s1_f["head_pose"].shape[1], f)  # trimmed to the GT's f frames
            for t_idx in range(0, t_chain, cfg.window - cfg.overlap_frames):
                tw = min(cfg.window, t_chain - t_idx)
                if tw > cfg.overlap_frames:
                    t_windows.add(tw)
    finally:
        tf_mod.fused_attention = real_fa
    if len(seen_fa) != 2 * len(set(FRAMES_E)):
        raise AssertionError(f"phase 10: {len(seen_fa)} fused_attention calls in the batched stage 1, want "
                             f"{2 * len(set(FRAMES_E))}")
    for q, k, v in seen_fa:
        out_k = check_once("fused_attention", lambda: attn.fused_attention(q, k, v),
                           ({"fused_attention": 1}, {"mha": 1}))
        out_p = attn.fused_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        log(f"phase 10: fused_attention f32 {tuple(q.shape[:3]) + (v.shape[-1],)} (the batched HeadNet's own "
            f"q, k, v): max|kernel - plain| = {err:.3e} (bound {TOL_F32})")
        if out_k.shape != out_p.shape or not math.isfinite(err) or err > TOL_F32:
            raise AssertionError(f"phase 10: fused_attention {tuple(q.shape)} disagrees with its plain version: {err}")
        fa_e["max_abs_err"] = max(fa_e["max_abs_err"], err)
    del seen_fa, q, k, v, out_k, out_p
    prep = {True: fs.prepare_step_params(model, True), False: fs.prepare_step_params(model, False)}
    step_e = {}
    for tw in sorted(t_windows, reverse=True):
        inp = inputs(tw, BATCH_E)
        for bf16 in (False, True):
            for name, what, wrapper, plain, args, extra in calls(inp, bf16):
                err = check(name, what, wrapper, plain, args, extra, bf16, tw, phase="phase 10")
                key = "max_abs_err" if bf16 else "max_abs_err_f32"
                step_e.setdefault(name, {}).setdefault(key, 0.0)
                step_e[name][key] = max(step_e[name][key], err)
    log(f"phase 10: step wrappers at {BATCH_E} windows of {sorted(t_windows, reverse=True)} frames, f32 and bf16: "
        f"{step_e}")
    del prep, inp
    clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_e = eval_egoego.run(eval_egoego.parse_opt(argv_e))
    torch.cuda.synchronize()
    dt_e = time.perf_counter() - t0
    got = dict(ck.launch_counts)
    n_fa_e = 2 * batches_e  # HeadNet layers x batches: one call a layer over the batch's 2N or N blocks
    want = {"fused_attention": n_fa_e, "stem_layer": windows_e * cfg.timesteps,
            "decoder_layer": windows_e * cfg.timesteps * (cfg.n_dec_layers - 2),
            "layer_epilogue": windows_e * cfg.timesteps}
    want_c = {"mha": n_fa_e, **{k: windows_e * cfg.timesteps * v for k, v in c_per_step().items()}}
    log(f"phase 10: launches {got} (expected {want}: {batches_e} batches x {win_e[FRAMES_E[0]]} windows); "
        f"C entries {dict(ck.kernel_launches)} (expected {want_c})")
    if got != want or dict(ck.kernel_launches) != want_c:
        raise AssertionError(f"phase 10: launch counts {got}, {dict(ck.kernel_launches)} != {want}, {want_c}")
    launches_e = got
    entries = list(res_e["per_seq"].values())
    if res_e["num_seqs"] != n_e or not all(math.isfinite(v) for e in entries for v in e.values()):
        raise AssertionError(f"phase 10: bad eval result {res_e}")
    if not all(e["s1_t_head"] > 0 for e in entries):
        raise AssertionError("phase 10: a stage-1 triple is missing")
    s_seq_d, s_seq_e = dt_egoego / SEQS_D, dt_e / n_e
    log(f"phase 10: eval_egoego --batch_seqs {BATCH_E} --fused_step, {n_e} seqs ({FRAMES_E.count(300)} x 300, "
        f"{FRAMES_E.count(240)} x 240 frames), HeadNet window {HEADNET_WINDOW_D}, DDPM-{cfg.timesteps}: {dt_e:.2f} s, "
        f"{s_seq_e:.3f} s/seq ({n_e / dt_e:.3f} seqs/s) against phase 8's {s_seq_d:.3f} s/seq at batch 1 "
        f"({s_seq_d / s_seq_e:.2f}x) [{card}]; s1_t_head {res_e['mean']['s1_t_head']:.1f} mm, mpjpe "
        f"{res_e['mean']['mpjpe']:.1f} mm (random weights)")

    # the same path under the profiler at DDPM-GAP_TIMESTEPS: the card's
    # timeline at each boundary between consecutive chains
    argv_gap = argv_e[:-4] + ["--timesteps", str(GAP_TIMESTEPS), "--out_dir", os.path.join(data_dir, "out_gap"),
                              "--device", "cuda"]
    step_kernels = sum(c_per_step().values())
    gaps, seen = None, 0
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            eval_egoego.run(eval_egoego.parse_opt(argv_gap))
            torch.cuda.synchronize()
        gaps, seen = chain_boundaries(prof, batches_e, win_e[FRAMES_E[0]] * GAP_TIMESTEPS * step_kernels,
                                      step_kernels)
        if gaps is not None:
            break
    if gaps is None:
        log(f"phase 10: gaps between chains not measured (the profiler saw {seen} step kernels, want "
            f"{batches_e * win_e[FRAMES_E[0]] * GAP_TIMESTEPS * step_kernels})")
    else:
        for k, gp_k in enumerate(gaps, 1):
            log(f"phase 10: chain {k - 1} -> {k} (DDPM-{GAP_TIMESTEPS}, profiled): {gp_k['interval_ms']:.3f} ms from "
                f"the last step kernel to the next chain's first, {gp_k['idle_ms']:.3f} ms of it idle; busy share "
                f"{gp_k['busy_share']:.3f} over the {gp_k['window_ms']:.2f} ms from 10 steps before to 10 after [{card}]")

    # parity on the card: f32 step kernels, DDIM-50, 2 batches of 2 sequences
    with open(gt_path_e, "rb") as f:
        gt_e = pickle.load(f)
    recs_e = recs_all[:4]  # the first 4: 300 frames each
    batches_p = [{"records": recs_e[i:i + 2],
                  "gt_qpos": np.stack([gt_e[r["seq_name"]]["qpos"] for r in recs_e[i:i + 2]]),
                  "gt_head_pose": np.stack([gt_e[r["seq_name"]]["head_pose"] for r in recs_e[i:i + 2]])}
                 for i in (0, 2)]
    pipe = build_pipeline(stats_path=stats_path, rest_offsets_path=rest_path, headnet_window=HEADNET_WINDOW_D,
                          sampler="ddim", device=dev)
    got_p = pl.run_batches_pipelined(pipe, batches_p, fs.TorchNoise(dev, seed=12))
    err_m = 0.0
    for k, (b, noise_k) in enumerate(zip(batches_p, fs.TorchNoise(dev, seed=12).split(2))):
        gq, gp, _ = pl.gt_from_qpos_batched(pipe, b["gt_qpos"])
        s1 = pipe.stage1_head_pose_batched(b["records"])
        hp = s1["head_pose"][:, :b["gt_head_pose"].shape[1]]
        hp = torch.cat([hp[..., :3] + (gp[:, 0:1, pl.HEAD_IDX] - hp[:, 0:1, :3]), hp[..., 3:]], -1)
        for g_md, w_md in zip(got_p[k]["metrics"], pl.evaluate_batch(pipe, hp, gq, gp, noise_k)):
            for name, w in w_md.items():
                err_m = max(err_m, float(np.max(np.abs(g_md[name] - w) / np.maximum(1.0, np.abs(w)))))
    log(f"phase 10: run_batches_pipelined vs the sequential composition, f32 DDIM-{cfg.ddim_steps}, 2 x 2 seqs: "
        f"max metric error {err_m:.3e} (relative above 1, absolute below; bound 1e-5)")
    if not err_m <= 1e-5:
        raise AssertionError(f"phase 10: run_batches_pipelined and the sequential composition disagree: {err_m}")
    s1_b = pipe.stage1_head_pose_batched(recs_e)
    err_hp = err_sc = 0.0
    for i, rec in enumerate(recs_e):
        one = pipe.stage1_head_pose(rec)
        err_hp = max(err_hp, float((s1_b["head_pose"][i] - one["head_pose"]).abs().max()))
        err_sc = max(err_sc, float(abs(s1_b["pred_scale"][i] - one["pred_scale"]) / abs(one["pred_scale"])))
    log(f"phase 10: stage1_head_pose_batched vs stage1_head_pose per record, 4 x 300 frames: head pose "
        f"{err_hp:.3e} (bound 2e-4), pred_scale relative {err_sc:.3e} (bound 1e-4)")
    if not (err_hp <= 2e-4 and err_sc <= 1e-4):
        raise AssertionError(f"phase 10: batched and per-record stage 1 disagree: {err_hp}, {err_sc}")
    for mode, hp_tol, rtol, atol in (("of_bf16", 2e-2, 2e-2, 5e-3), ("of_int8", 5e-2, 5e-2, 1e-2)):
        out = dataclasses.replace(pipe, **{mode: True}).stage1_head_pose_batched(recs_e)
        e_hp = float((out["head_pose"] - s1_b["head_pose"]).abs().max())
        e_sc = float(((out["pred_scale"] - s1_b["pred_scale"]).abs() - rtol * s1_b["pred_scale"].abs()).max())
        log(f"phase 10: --{mode} stage 1 vs f32: head pose {e_hp:.3e} (bound {hp_tol}); pred_scale excess over "
            f"rtol {rtol}: {e_sc:.3e} (bound atol {atol})")
        if not (torch.isfinite(out["head_pose"]).all() and e_hp <= hp_tol and e_sc <= atol):
            raise AssertionError(f"phase 10: --{mode} stage 1 is off: {e_hp}, {e_sc}")
    of_e = torch.randn(4, FRAMES_D, 512, generator=g, device=dev).cpu()
    pinned = of_e.pin_memory()
    copy_ms = cuda_time_ms(lambda: pinned.to(dev, non_blocking=True), warmup=2, reps=10)
    up_ms = cuda_time_ms(lambda: pipe._upload(of_e), warmup=2, reps=10)
    log(f"phase 10: OF upload 4 x {FRAMES_D} x 512 f32 ({of_e.numel() * 4 / 1e6:.2f} MB): the copy from pinned "
        f"memory {copy_ms:.3f} ms, with the pinning (EgoEgoPipeline._upload) {up_ms:.3f} ms [{card}]")

    # -- phase 11: stage-2 training on the card ---------------------------
    training = train_phase(card, data_dir, data_path, rest_path, check_counts, clear_counts)

    # -- phase 12: bf16 inter-layer activations of the step kernels ----------
    act = act_bf16_phase(card, head, stats_path, rest_path, check_counts, clear_counts)
    for name in ACT_WRAPPERS:
        results[name]["act_bf16"] = act["wrappers"][name]

    # -- phase 13: stage-1 training on the card ------------------------------
    stage1_training = stage1_phase(card, data_dir, stats_path, rest_path, per_step, c_per_step, clear_counts)

    # -- phase 14: the parallel-window sampler and the output flags ----------
    outputs = outputs_phase(card, data_dir, stats_path, rest_path, kin_root, gt_path, per_step, c_per_step,
                            clear_counts)

    # -- phase 15: multi-GPU (ranks on the one card) and serving -------------
    parallel = parallel_phase(card, data_dir, data_path, stats_path, rest_path, clear_counts)

    # -- phase 16: optical flow, the raw-flow HeadNet, GIMO ------------------
    optical_flow = optical_flow_phase(card, data_dir)

    replaces = {"stem_layer": "egoego_release_tpu/ops/fused_step.py:126",
                "decoder_layer": "egoego_release_tpu/ops/fused_layer.py:113",
                "layer_epilogue": "egoego_release_tpu/ops/fused_step.py:160",
                "fused_decoder_layer": "egoego_release_tpu/ops/fused_layer.py:172",
                "fused_attention": "egoego_release_tpu/ops/attention.py:31"}
    csrc = "egoego_release_tpu_torch/csrc/"
    layer_srcs = [csrc + "gemm.cu", csrc + "attention.cu"]
    results["fused_decoder_layer"] = dict(fdl, launches=n_fdl, c_kernels={
        k: n_fdl * v for k, v in c_launches("fused_decoder_layer").items()})
    results["fused_attention"] = dict(fa, launches=n_fa, c_kernels={"mha": n_fa},
                                      launches_path_e=launches_e["fused_attention"],
                                      max_abs_err_path_e=fa_e["max_abs_err"])
    for name in per_step:
        results[name].update(launches=launches[name], launches_path_e=launches_e[name],
                             max_abs_err_path_e=step_e[name], shape=f"{BATCH} windows x {cfg.window + 1} tokens, bf16",
                             c_kernels={k: launches[name] * v for k, v in c_launches(name).items()})
    # the stem's and the update's GEMM launch (gemm_wgmma_kernel kStem / kStep) at both windows
    tables = results["decoder_layer"]["launch_table"]
    tables32 = results["decoder_layer"]["f32_launch_table"]
    for name, part in (("stem_layer", "stem"), ("layer_epilogue", "step")):
        results[name]["gemm_launch"] = {shape: {k: tab[part][k] for k in (
            "mkn", "device_ms", "library_device_ms", "bound_ms", "bound_ops_ms", "bound_bytes_ms", "max_abs_err")}
            for shape, tab in tables.items()}
        results[name]["f32"]["gemm_launch"] = {shape: tab[part] for shape, tab in tables32.items()}
    kernels = []
    for name, r in results.items():
        srcs = [csrc + "mha.cu"] if name == "fused_attention" else layer_srcs
        kernels.append({
            "name": name, "route": "cuda", "source": srcs[0], "sources": srcs,
            "replaces": replaces[name], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            **({"max_abs_err_f32": r["max_abs_err_f32"]} if "max_abs_err_f32" in r else {}),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "gflop": r["gflop"], "mbytes": r["mbytes"],
            "shape": r["shape"], "card": card,
            **{key: r[key] for key in ("device_ms", "library_device_ms", "bound_f32_core_ms", "per_shape",
                                       "mma_sync_tf32_tflops", "launch_table", "gemm_launch", "attention_launch",
                                       "c_kernels", "launches_path_e", "max_abs_err_path_e", "act_bf16", "f32",
                                       "f32_launch_table") if key in r},
        })
    # the tensor-parallel layer's own launches: the 64 x 121-token, tp 2 rows
    # of phase 15 (bf16 PARTIAL fc; residual_layernorm with an f32 residual),
    # launches per rank of its tp 2 --fused_step eval_stage2 run
    tp_counts = parallel["eval"]["dp 1 x tp 2 bf16"]["counts_rank0"]
    for name, src, key, pick in (
            ("gemm_partial", csrc + "gemm.cu", "partial", lambda r: r["what"].startswith("fc tp2 64x121") and r["bf16"]),
            ("residual_layernorm", csrc + "residual_layernorm.cu", "residual_layernorm",
             lambda r: r["what"] == "64x121 res f32, out f32+bf16")):
        k = parallel["kernels"][key]
        r = next(r for r in k["rows"] if pick(r))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "sources": [src],
            "replaces": "egoego_release_tpu/ops/fused_layer.py:43",
            "launches": (parallel["eval"]["dp 1 x tp 2 bf16"]["partial_launches"] if key == "partial"
                         else tp_counts["residual_layernorm"]),
            "max_abs_err": k["max_abs_err"], "max_abs_err_f32": k["max_abs_err_f32"], "ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_device_ms"], "gflop": r["gflop"], "mbytes": r["mbytes"],
            "shape": r["what"], "card": card, "per_shape": k["rows"],
            **({"f32": next(r32 for r32 in k["rows"] if r32["what"] == r["what"] and not r32["bf16"])}
               if key == "partial" else {})})
    log(f"main path: eval_stage2 {dt_a:.3f} s; DDPM chain {dt_b:.3f} s; DDIM chain {dt_d:.3f} s; "
        f"eval_stage2 --fused {dt_c:.3f} s; eval_egoego {dt_egoego:.3f} s; eval_egoego --batch_seqs {BATCH_E} "
        f"{dt_e:.3f} s ({s_seq_e:.3f} s/seq against {s_seq_d:.3f}); stage 1 "
        f"{stage1[HEADNET_WINDOW_D]['ms_per_seq']:.2f} ms/seq (window {HEADNET_WINDOW_D}), "
        f"{stage1[60]['ms_per_seq']:.2f} ms/seq (window 60); whole smoke {time.perf_counter() - t_start:.1f} s; "
        f"device times left by the profiler to CUDA events: {len(EVENT_TIMED)}")
    print(json.dumps({"kernels": kernels, "step": step_prof, "step_f32": f32_step, "training": training,
                      "act_bf16": {k: v for k, v in act.items() if k != "wrappers"},
                      "stage1_training": stage1_training, "outputs": outputs,
                      "parallel": {k: v for k, v in parallel.items() if k != "kernels"},
                      "optical_flow": optical_flow}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
