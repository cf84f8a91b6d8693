"""statear experiment-matrix sweep (port of egoego_release_tpu/eval/eval_sweep.py;
the reference's multi-config, multi-take eval: the statear YAMLs through
kinpoly/relive/utils/statear_smpl_config.py, each take evaluated as in
kinpoly/scripts/eval_pose_all.py:115-205).

For each statear YAML (``utils.config.KinpolyConfig``): its meta take lists
({data_dir}/meta/{meta_id}.yml, or --meta_path), the split's takes, the
TrajARNet rollout of each (``eval_trajar.eval_record``) and the means of
the metric suite; a per-config and per-take table goes to one JSON file.

    python -m egoego_release_tpu_torch.eval.eval_sweep --configs cfgs/a.yml cfgs/b.yml \\
        --expert_path "{data_dir}/features/{data_file}.p" --ckpt_pattern "results/{cfg}/final.pt" \\
        --rest_offsets rest.npy [--split test] [--wild] [--out sweep_res.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from egoego_release_tpu_torch.data.kinpoly import StateARDataset
from egoego_release_tpu_torch.eval.eval_trajar import eval_record, load_or_init
from egoego_release_tpu_torch.models.trajar import TrajARNet
from egoego_release_tpu_torch.utils.config import KinpolyConfig
from egoego_release_tpu_torch.utils.device import resolve_device


def _cfg_id(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _load_params(ckpt: str | None, rest_offsets, rnn_hdim: int, mlp_hsize, device) -> TrajARNet:
    """The TrajARNet of ``ckpt`` (a ``.pt``), or one drawn from seed 0 with a
    warning (JAX ``eval/eval_sweep.py:47``)."""
    return load_or_init(ckpt, rest_offsets, rnn_hdim, mlp_hsize, device)


def eval_config(cfg_path: str, expert_path_tmpl: str, rest_offsets, ckpt_pattern: str | None = None,
                meta_path: str | None = None, data_dir: str | None = None, split: str = "test", wild: bool = False,
                rnn_hdim: int = 512, mlp_hsize: tuple[int, ...] = (1024, 512), max_takes: int = 0,
                model: TrajARNet | None = None, device="cuda") -> dict:
    """One statear config: its takes, each evaluated, the means (JAX
    ``eval/eval_sweep.py:60``). ``model`` (on its device) is used as it is
    when given."""
    dev = resolve_device(device)
    cfg = KinpolyConfig(cfg_path)
    cfg_id = _cfg_id(cfg_path)
    data_dir = data_dir or cfg.get("dataset_path", ".")
    meta = cfg.load_meta(meta_path=meta_path, data_dir=data_dir, wild=wild)
    takes = [t["take"] for t in KinpolyConfig.resolve_takes(meta)[split]]

    expert_path = expert_path_tmpl.format(data_dir=data_dir, data_file=cfg.data_file(wild), cfg=cfg_id)
    ds = StateARDataset(expert_path, fr_num=int(cfg.get("fr_num", 90)), train=False, takes=takes)
    if len(ds) == 0:
        return {"config": cfg_id, "error": f"no {split} takes matched in {expert_path}"}
    if model is None:
        ckpt = ckpt_pattern.format(cfg=cfg_id) if ckpt_pattern else None
        model = _load_params(ckpt, rest_offsets, int(cfg.model_specs.get("rnn_hdim", rnn_hdim)), mlp_hsize, dev)

    per_take: dict[str, dict] = {}
    agg: dict[str, list] = {}
    for i in range(len(ds)):
        rec = ds.sample_seq(i)
        md = eval_record(model, rec, rest_offsets)
        per_take[rec["seq_name"]] = md
        for k, v in md.items():
            agg.setdefault(k, []).append(v)
        if max_takes and i + 1 >= max_takes:
            break
    return {"config": cfg_id, "split": split, "num_takes": len(per_take),
            "mean": {k: float(np.mean(v)) for k, v in agg.items()}, "per_take": per_take}


def run_sweep(opt) -> dict:
    """The CLI: every config of ``opt.configs``; writes ``opt.out``."""
    dev = resolve_device(opt.device)
    from egoego_release_tpu_torch.eval.build import load_rest_offsets

    rest = load_rest_offsets(opt.smplh_path, opt.rest_offsets)
    results = {}
    for cfg_path in opt.configs:
        res = eval_config(cfg_path, opt.expert_path, rest, ckpt_pattern=opt.ckpt_pattern, meta_path=opt.meta_path,
                          data_dir=opt.data_dir, split=opt.split, wild=opt.wild, max_takes=opt.max_takes, device=dev)
        results[res["config"]] = res
        if "error" in res:
            print(f"{res['config']}: {res['error']}")
            continue
        mean = res["mean"]
        print(f"{res['config']}: takes={res['num_takes']} mpjpe={mean.get('mpjpe', float('nan')):.2f}mm "
              f"root_dist={mean.get('root_dist', float('nan')):.4f} diverged={mean.get('diverged', 0.0):.2f}")

    os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
    with open(opt.out, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"sweep results -> {opt.out}")
    return results


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--configs", nargs="+", required=True, help="statear experiment YAMLs")
    p.add_argument("--expert_path", required=True,
                   help="expert pickle path template; {data_dir}/{data_file}/{cfg} placeholders are substituted "
                        "per config")
    p.add_argument("--ckpt_pattern", default=None, help="train_trajar .pt path template with a {cfg} placeholder")
    p.add_argument("--meta_path", default=None, help="override the {data_dir}/meta/{meta_id}.yml location")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--split", choices=["train", "test"], default="test")
    p.add_argument("--wild", action="store_true", help="use data_wild_file/meta_wild_id (kinpoly-realworld)")
    p.add_argument("--smplh_path", default=None)
    p.add_argument("--rest_offsets", default=None)
    p.add_argument("--max_takes", type=int, default=0)
    p.add_argument("--out", default="./results/statear_sweep.json")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    return run_sweep(parse_opt(argv))


if __name__ == "__main__":
    main()
