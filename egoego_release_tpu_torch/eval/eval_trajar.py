"""TrajARNet baseline evaluation (port of egoego_release_tpu/eval/eval_trajar.py;
the reference's kinpoly/scripts/eval_pose_all.py and eval_amass_metrics.py,
the non-RL statear path).

Each expert record's first fr_num frames: the rollout from its first qpos,
the SMPL FK of the prediction and of the GT, and the metric suite of the
EgoEgo eval (``eval.metrics.compute_metrics_for_smpl``), so the baseline and
the diffusion pipeline are compared on the same numbers. A rollout whose FK
is not finite is reported as diverged. ``--mujoco_xml`` adds the kinpoly
qpos-path suite over that skeleton (``eval.qpos_metrics``), and with
``--physics_metrics`` the simulator-grounded suite (``eval.physics_metrics``:
penetration, foot sliding and interaction success from MuJoCo's contacts, on
the host).

    python -m egoego_release_tpu_torch.eval.eval_trajar --expert_path mocap_annotations.p \\
        --ckpt results/trajar/final.pt --rest_offsets rest.npy [--mujoco_xml humanoid.xml [--physics_metrics
        [--obj_bodies Chair Step]]] [--device cpu]
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


def physics_metrics(xml_path: str, qpos_records: dict, obj_bodies: tuple[str, ...] = ()) -> dict:
    """The simulator-grounded suite over the rollouts (JAX
    ``eval/eval_trajar.py:121-165``; eval_amass_metrics.py's
    compute_physcis_metris and compute_obj_interact): per record the
    penetration and foot sliding of the prediction and of the GT, and the
    interaction success of its action (the take name's prefix before
    ``-``); returns their means. MuJoCo runs on the host; the env's control
    laws, which this suite never steps, are put on the CPU beside it."""
    from egoego_release_tpu_torch.eval.physics_metrics import compute_physics_metrics, interaction_success
    from egoego_release_tpu_torch.rl.mujoco_env import MujocoHumanoidEnv

    env = MujocoHumanoidEnv(xml_path, residual_force=False, device="cpu")
    phys_agg: dict[str, list] = {}
    for name, rec in qpos_records.items():
        obj_pose = rec.get("obj_pose")
        # object qpos goes into the simulation only where the model has
        # slots for it (the plain humanoid XML has none)
        obj_pose_sim = None
        if obj_pose is not None:
            extra = env.model.nq - rec["qpos"].shape[1]
            if extra > 0:
                obj_pose_sim = np.asarray(obj_pose)[:, :extra]
        pm_pred = compute_physics_metrics(env, rec["qpos"], obj_pose=obj_pose_sim)
        pm_gt = compute_physics_metrics(env, rec["qpos_gt"], obj_pose=obj_pose_sim)
        action = name.split("-")[0] if "-" in name else "None"
        try:
            succ = interaction_success(action, pm_pred["pen_seq_info"], rec["qpos"], pm_pred["head_pose"],
                                       head_pose_gt=pm_gt["head_pose"], obj_pose=obj_pose, env=env,
                                       obj_body_names=obj_bodies)
            phys_agg.setdefault("succ", []).append(float(succ))
        except ValueError as e:
            # an object-action take without object data or bodies on this model
            print(f"{name}: success not scoreable ({e})")
        for k, v in (("pen_pred", pm_pred["pen"]), ("pen_gt", pm_gt["pen"]), ("slide_pred", pm_pred["sliding"]),
                     ("slide_gt", pm_gt["sliding"])):
            phys_agg.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in phys_agg.items()}


def run(opt) -> dict:
    """The CLI: returns the mean of each metric (JAX ``eval/eval_trajar.py:64``)."""
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

    if qpos_records and opt.physics_metrics:
        result["physics_metrics"] = physics_metrics(opt.mujoco_xml, qpos_records, tuple(opt.obj_bodies or ()))
        print("physics: pen_pred=%.2fmm succ=%.2f" % (result["physics_metrics"]["pen_pred"],
                                                      result["physics_metrics"]["succ"]))

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
                   help="with --mujoco_xml: also run the simulator-grounded penetration/sliding/success suite "
                        "(eval/physics_metrics.py; needs mujoco)")
    p.add_argument("--obj_bodies", nargs="*", default=None,
                   help="object body names on the XML for sit/avoid/step success scoring (e.g. Chair Step)")
    p.add_argument("--out_dir", default="./results")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    return run(parse_opt(argv))


if __name__ == "__main__":
    main()
