"""TrajARNet baseline evaluation (port of egoego_release_tpu/eval/eval_trajar.py;
the reference's kinpoly/scripts/eval_pose_all.py and eval_amass_metrics.py,
the non-RL statear path).

Each expert record's first fr_num frames: the rollout from its first qpos,
the SMPL FK of the prediction and of the GT, and the metric suite of the
EgoEgo eval (``eval.metrics.compute_metrics_for_smpl``), so the baseline and
the diffusion pipeline are compared on the same numbers. A rollout whose FK
is not finite is reported as diverged. ``--mujoco_xml`` adds the kinpoly
qpos-path suite over that skeleton (``eval.qpos_metrics``).
``--physics_metrics`` needs the simulator-grounded suite of the physics
group, which the port does not have yet: it raises.

    python -m egoego_release_tpu_torch.eval.eval_trajar --expert_path mocap_annotations.p \\
        --ckpt results/trajar/final.pt --rest_offsets rest.npy [--mujoco_xml humanoid.xml] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from egoego_release_tpu_torch.data.kinpoly import StateARDataset
from egoego_release_tpu_torch.eval import metrics as metrics_mod
from egoego_release_tpu_torch.models.trajar import STEP_KEYS, TrajARNet, init_trajar_
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import geometry
from egoego_release_tpu_torch.utils.device import resolve_device

PHYSICS_UNPORTED = ("--physics_metrics needs the simulator-grounded metric suite (eval/physics_metrics.py on "
                    "rl/mujoco_env.py), which belongs to the physics group of ROADMAP A.7 and is not ported to "
                    "egoego_release_tpu_torch yet")


@torch.no_grad()
def eval_record(model: TrajARNet, rec: dict, rest_offsets, return_qpos: bool = False):
    """One record (numpy arrays of fr_num frames) -> its metric means, on
    the model's device (JAX ``eval/eval_trajar.py:32``, which takes the flax
    params beside the model); with ``return_qpos`` also the predicted qpos
    (T, 76)."""
    dev = model.rest_offsets.device
    data = {k: torch.as_tensor(rec[k][None], device=dev) for k in STEP_KEYS}
    gt_qpos = torch.as_tensor(rec["qpos"], device=dev)
    pred = model(data, init_qpos=gt_qpos[:1])["qpos"][0]
    rest = torch.as_tensor(np.asarray(rest_offsets, np.float32), device=dev)

    def fk(qpos):
        trans, aa24 = geometry.qpos_to_smpl(qpos)
        return fk_mod.fk_smpl(trans, aa24[:, :fk_mod.NUM_JOINTS], rest)

    pred_q, pred_p = fk(pred)
    gt_q, gt_p = fk(gt_qpos)
    pred_qpos = pred.cpu().numpy()
    if not bool(torch.isfinite(pred_p).all()):
        # an untrained or underfit policy can diverge through the qpos
        # feedback loop (the reference's rollout would too): report it
        out_d = {"diverged": 1.0}
        return (out_d, pred_qpos) if return_qpos else out_d
    md = metrics_mod.compute_metrics_for_smpl(gt_q, gt_p, 0.0, pred_q, pred_p, 0.0)
    out_d = {k: float(v.mean()) for k, v in md.items() if k != "single_jpe"}
    out_d["diverged"] = 0.0
    return (out_d, pred_qpos) if return_qpos else out_d


def load_or_init(ckpt: str | None, rest_offsets, rnn_hdim: int, mlp_hsize=(1024, 512), device="cpu",
                 seed: int = 0) -> TrajARNet:
    """A ``train_trajar`` ``final.pt`` at ``ckpt``, or (with a warning)
    TrajARNet drawn from ``seed`` (``init_trajar_``), as the JAX CLIs
    initialize without one."""
    if ckpt and os.path.exists(ckpt):
        from egoego_release_tpu_torch.training.train_trajar import load_trajar

        return load_trajar(ckpt, rest_offsets, device, rnn_hdim=rnn_hdim).eval()
    print(f"WARNING: no TrajARNet checkpoint at {ckpt!r}; using random init")
    model = TrajARNet(rnn_hdim=rnn_hdim, mlp_hsize=tuple(mlp_hsize), rest_offsets=np.asarray(rest_offsets))
    return init_trajar_(model, torch.Generator().manual_seed(seed)).to(device).eval()


def run(opt) -> dict:
    """The CLI: returns the mean of each metric (JAX ``eval/eval_trajar.py:64``)."""
    if opt.physics_metrics:
        raise NotImplementedError(PHYSICS_UNPORTED)
    dev = resolve_device(opt.device)
    from egoego_release_tpu_torch.eval.build import load_rest_offsets

    rest = load_rest_offsets(opt.smplh_path, opt.rest_offsets)
    ds = StateARDataset(opt.expert_path, fr_num=opt.fr_num, train=False)
    model = load_or_init(opt.ckpt, rest, opt.rnn_hdim, device=dev)

    qpos_records = {} if opt.mujoco_xml else None
    agg: dict[str, list] = {}
    per_seq = {}
    for i in range(len(ds)):
        rec = ds.sample_seq(i)
        md, pred_qpos = eval_record(model, rec, rest, return_qpos=True)
        per_seq[rec["seq_name"]] = md
        for k, v in md.items():
            agg.setdefault(k, []).append(v)
        if qpos_records is not None and not md.get("diverged"):
            qpos_records[rec["seq_name"]] = {"qpos": pred_qpos, "qpos_gt": np.asarray(rec["qpos"])}
        print(f"{rec['seq_name']}: DIVERGED" if md.get("diverged") else f"{rec['seq_name']}: mpjpe={md['mpjpe']:.2f}mm")
        if opt.max_seqs and i + 1 >= opt.max_seqs:
            break

    summary = {k: float(np.mean(v)) for k, v in agg.items()}
    result = {"mean": summary, "per_seq": per_seq}
    if qpos_records:
        # the kinpoly qpos metric path (eval_metrics_imu_rec.compute_metrics)
        # over the MuJoCo skeleton, beside the tensor suite
        from egoego_release_tpu_torch.eval.qpos_metrics import _fk_take, compute_metrics_for_qpos_records
        from egoego_release_tpu_torch.ops.mujoco_xml import load_mujoco_skeleton

        skeleton = load_mujoco_skeleton(opt.mujoco_xml, device=dev)
        for rec in qpos_records.values():
            rec["head_pose_gt"] = _fk_take(skeleton, rec["qpos_gt"])[1]
        qpos_md = compute_metrics_for_qpos_records(qpos_records, skeleton)
        result["qpos_metrics"] = {k: float(np.mean(v)) for k, v in qpos_md.items() if k != "single_jpe"}
        print("qpos-path mpjpe: %.2f mm, slide_pred: %.2f" % (qpos_md["mpjpe"], qpos_md["slide_pred"]))

    os.makedirs(opt.out_dir, exist_ok=True)
    with open(os.path.join(opt.out_dir, "trajar_baseline_res.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("mean:", json.dumps(summary, indent=2))
    return summary


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--expert_path", required=True)
    p.add_argument("--ckpt", default=None, help="train_trajar's final.pt")
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--fr_num", type=int, default=90)
    p.add_argument("--rnn_hdim", type=int, default=512)
    p.add_argument("--max_seqs", type=int, default=0)
    p.add_argument("--mujoco_xml", default=None,
                   help="humanoid XML; when given, also report the kinpoly qpos-path metric suite "
                        "(eval/qpos_metrics.py)")
    p.add_argument("--physics_metrics", action="store_true",
                   help="the simulator-grounded suite of the physics group: not ported yet, raises")
    p.add_argument("--obj_bodies", nargs="*", default=None,
                   help="object body names for the physics suite's success scoring (with --physics_metrics)")
    p.add_argument("--out_dir", default="./results")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    return run(parse_opt(argv))


if __name__ == "__main__":
    main()
