"""The port's full-pipeline CLIs on the CPU (``--device cpu``): eval_egoego
on a synthetic kinpoly-layout fixture, per sequence and with
``--batch_seqs``, eval_stage2 with ``--fused``, and run_egoego on a
synthetic demo fixture, with the output flags of both. Full release widths, random weights, a few
diffusion steps; the results must be finite and carry the JAX CLIs'
keys."""

import json
import os
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from egoego_release_tpu.eval import metrics as jmetrics
from egoego_release_tpu_torch.eval import eval_egoego, eval_stage2, run_egoego

T = 20
SMALL_RUN = ["--window", "16", "--timesteps", "3", "--device", "cpu"]


def _stats_and_rest(tmp_path, rng):
    stats = tmp_path / "stats.p"
    with open(stats, "wb") as f:
        pickle.dump({"global_jpos_min": np.full((22, 3), -1.5, np.float32),
                     "global_jpos_max": np.full((22, 3), 1.5, np.float32)}, f)
    rest = tmp_path / "rest.npy"
    np.save(rest, np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32))
    return str(stats), str(rest)


def _head_record(rng, seq_name, feat_dir, t=T, of_prefix=None):
    of_files = []
    for i in range(t):
        f = feat_dir / f"raft_of_feats_{seq_name}_{i}.npy"
        np.save(f, rng.randn(512).astype(np.float32))
        of_files.append(str(f) if of_prefix is None else str(f).replace(of_prefix[1], of_prefix[0]))
    head_qpos = np.concatenate([np.cumsum(rng.uniform(-0.02, 0.02, (t + 1, 3)), 0) + [0, 0, 1.5],
                                np.tile([1.0, 0, 0, 0], (t + 1, 1))], -1).astype(np.float32)
    return {"seq_name": seq_name, "head_qpos": head_qpos,
            "head_vels": (rng.randn(t + 1, 6) * 0.01).astype(np.float32), "of_files": of_files}


def _slam_npy(rng, path, t=T):
    slam = np.concatenate([np.cumsum(rng.uniform(-0.02, 0.02, (t + 1, 3)), 0),
                           np.tile([1.0, 0, 0, 0], (t + 1, 1))], -1).astype(np.float32)
    np.save(path, slam)


def make_kinpoly_fixture(tmp_path, n_seqs=2, lengths=None):
    """The layout RealWorldHeadPoseDataset(eval_on_kinpoly_mocap=True)
    reads: kinpoly-mocap/mocap_annotations.p, kinpoly/droid_slam_res/{scene}/
    {take}.npy, per-frame OF feature npys; plus the qpos GT pickle (written
    with joblib, read back without it). ``lengths``: frames per sequence
    (default T each)."""
    import joblib

    rng = np.random.RandomState(0)
    root = tmp_path / "root"
    feat_dir = root / "feats"
    slam_dir = root / "kinpoly" / "droid_slam_res" / "subj"
    for d in (feat_dir, slam_dir, root / "kinpoly-mocap"):
        d.mkdir(parents=True)
    recs, gt = {}, {}
    for si, t in enumerate(lengths or [T] * n_seqs):
        name = f"subj-take{si + 1}"
        recs[si] = _head_record(rng, name, feat_dir, t=t)
        _slam_npy(rng, slam_dir / f"take{si + 1}.npy", t=t)
        qpos = np.zeros((t, 76), np.float32)
        qpos[:, 2] = 0.92
        qpos[:, 3:7] = [0.7071, 0.7071, 0, 0]
        qpos[:, :2] = np.cumsum(rng.uniform(-0.01, 0.01, (t, 2)), 0)
        qpos[:, 7:] = rng.uniform(-0.2, 0.2, 69)
        gt[name] = {"qpos": qpos, "head_pose": recs[si]["head_qpos"][:t]}
    joblib.dump(recs, root / "kinpoly-mocap" / "mocap_annotations.p")
    gt_path = tmp_path / "full_body_gt.p"
    joblib.dump(gt, gt_path)
    stats, rest = _stats_and_rest(tmp_path, rng)
    return {"root": str(root), "gt": str(gt_path), "stats": stats, "rest": rest,
            "names": [f"subj-take{i + 1}" for i in range(len(recs))]}


@pytest.fixture()
def kinpoly(tmp_path):
    return make_kinpoly_fixture(tmp_path)


def _egoego_argv(fx, out_dir, *extra):
    return ["--data_root_folder", fx["root"], "--full_body_gt_path", fx["gt"], "--stats_path", fx["stats"],
            "--rest_offsets", fx["rest"], "--headnet_window", "8", "--out_dir", str(out_dir),
            *SMALL_RUN, *extra]


def _metric_keys():
    z = jnp.zeros((8, 22, 3))
    q = jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (8, 22, 1))
    return set(jmetrics.compute_metrics_for_smpl(q, z, 0.0, q, z, 0.0)) - {"single_jpe"}


@pytest.mark.parametrize("extra", [[], ["--fused"]])
def test_eval_egoego_cli_on_cpu(kinpoly, tmp_path, extra):
    """Stage 1 + qpos GT + stage 2 + metrics per sequence: every entry is
    finite and has the JAX CLI's keys (the metric suite plus s1_e_head,
    s1_o_head, s1_t_head), in the JAX CLI's JSON layout."""
    result = eval_egoego.run(eval_egoego.parse_opt(_egoego_argv(kinpoly, tmp_path / "out", *extra)))
    want = _metric_keys() | {"s1_e_head", "s1_o_head", "s1_t_head"}
    saved = json.load(open(tmp_path / "out" / "egoego_pipeline_res_on_kinpoly.json"))
    assert saved["num_seqs"] == result["num_seqs"] == 2
    assert set(saved["per_seq"]) == set(kinpoly["names"]) and set(saved["mean"]) == want
    for entry in saved["per_seq"].values():
        assert set(entry) == want
        assert all(np.isfinite(v) for v in entry.values())


def test_eval_egoego_gt_head_pose(kinpoly, tmp_path):
    """--use_gt_head_pose: the GT head in, so the stage-1 error is ~0."""
    result = eval_egoego.run(eval_egoego.parse_opt(
        _egoego_argv(kinpoly, tmp_path / "out", "--use_gt_head_pose", "--max_seqs", "1")))
    assert result["num_seqs"] == 1
    entry = result["per_seq"][kinpoly["names"][0]]
    assert entry["s1_t_head"] < 1e-3 and entry["s1_e_head"] < 1e-3


@pytest.mark.parametrize("flag", [["--mujoco_xml", "h.xml"], ["--save_html_vis"], ["--dp", "2"], ["--tp", "2"]])
def test_eval_egoego_unported_flags_raise(kinpoly, tmp_path, flag):
    """--dp/--tp are not ported and raise. --mujoco_xml and --save_html_vis
    are ported and run, even with --batch_seqs 2 (the per-sequence path, as
    in JAX): finite metrics for every sequence, and one HTML file each."""
    if flag[0] in ("--dp", "--tp"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eval_egoego.run(eval_egoego.parse_opt(_egoego_argv(kinpoly, tmp_path / "out", *flag)))
        return
    import chip_smoke

    if flag[0] == "--mujoco_xml":
        flag = [flag[0], chip_smoke.write_humanoid_xml(str(tmp_path / flag[1]),
                                                        chip_smoke.smpl_rest_to_mujoco(np.load(kinpoly["rest"])))]
    result = eval_egoego.run(eval_egoego.parse_opt(_egoego_argv(kinpoly, tmp_path / "out", "--batch_seqs", "2",
                                                                *flag)))
    assert result["num_seqs"] == 2
    assert all(np.isfinite(v) for e in result["per_seq"].values() for v in e.values())
    html = sorted(p.name for p in (tmp_path / "out").glob("*.html"))
    assert html == ([f"{n}.html" for n in kinpoly["names"]] if flag[0] == "--save_html_vis" else [])


@pytest.mark.parametrize("extra", [[], ["--use_gt_head_pose"], ["--of_int8"]])
def test_eval_egoego_batched_cli_on_cpu(tmp_path, extra):
    """--batch_seqs 2 over sequences of two lengths (20, 20, 16, 20 frames:
    buckets of 3 and 1, so three chunks, one of them short) through the
    pipelined loop: every entry finite with the JAX CLI's keys; in
    --use_gt_head_pose mode the s1_* columns are exact zeros."""
    fx = make_kinpoly_fixture(tmp_path, lengths=[T, T, 16, T])
    result = eval_egoego.run(eval_egoego.parse_opt(
        _egoego_argv(fx, tmp_path / "out", "--batch_seqs", "2", *extra)))
    want = _metric_keys() | {"s1_e_head", "s1_o_head", "s1_t_head"}
    saved = json.load(open(tmp_path / "out" / "egoego_pipeline_res_on_kinpoly.json"))
    assert saved["num_seqs"] == result["num_seqs"] == 4 and set(saved["per_seq"]) == set(fx["names"])
    for entry in saved["per_seq"].values():
        assert set(entry) == want and all(np.isfinite(v) for v in entry.values())
        s1 = [entry[k] for k in ("s1_e_head", "s1_o_head", "s1_t_head")]
        assert s1 == [0.0, 0.0, 0.0] if "--use_gt_head_pose" in extra else min(s1) > 0.0


def test_eval_egoego_of_bf16_with_of_int8_raises_before_building(kinpoly, tmp_path, monkeypatch):
    """The two upload modes exclude each other: build_pipeline refuses the
    pair before it builds any model (JAX checks only when stage 1 runs)."""
    from egoego_release_tpu_torch.eval import build

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(build, "CondGaussianDiffusion", no_model)
    with pytest.raises(ValueError, match="mutually exclusive"):
        eval_egoego.run(eval_egoego.parse_opt(_egoego_argv(
            kinpoly, tmp_path / "out", "--batch_seqs", "2", "--of_bf16", "--of_int8")))


@pytest.mark.parametrize("flag", ["--of_bf16", "--of_int8"])
def test_eval_egoego_per_sequence_warns_once_on_upload_flags(kinpoly, tmp_path, flag):
    """--batch_seqs 1 with an upload flag: one warning for the run, and
    JAX's f32 numerics (the same result as without the flag)."""
    plain = eval_egoego.run(eval_egoego.parse_opt(_egoego_argv(kinpoly, tmp_path / "a")))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        flagged = eval_egoego.run(eval_egoego.parse_opt(_egoego_argv(kinpoly, tmp_path / "b", flag)))
    said = [w for w in caught if "--of_bf16/--of_int8" in str(w.message)]
    assert len(said) == 1
    assert flagged["per_seq"] == plain["per_seq"]


def test_eval_stage2_fused_on_cpu(tmp_path):
    """eval_stage2 --fused runs the fused_decoder_layer denoiser (plain on
    the CPU) and writes finite metrics."""
    rng = np.random.RandomState(1)
    data = {i: {"seq_name": f"HumanEva-seq{i}",
                "trans": (np.cumsum(rng.randn(16, 3) * 0.01, 0) + [0, 0, 0.9]).astype(np.float32),
                "root_orient": (rng.randn(16, 3) * 0.1).astype(np.float32),
                "body_pose": (rng.randn(16, 63) * 0.1).astype(np.float32)} for i in range(2)}
    with open(tmp_path / "data.p", "wb") as f:
        pickle.dump(data, f)
    stats, rest = _stats_and_rest(tmp_path, rng)
    result = eval_stage2.run(eval_stage2.parse_opt([
        "--test_data_path", str(tmp_path / "data.p"), "--stats_path", stats, "--rest_offsets", rest,
        "--batch_seqs", "2", "--fused", "--out_dir", str(tmp_path / "out"), *SMALL_RUN]))
    assert result["num_seqs"] == 2 and set(result["mean"]) == _metric_keys()
    assert all(np.isfinite(v) for v in result["mean"].values())


def test_run_egoego_demo_on_cpu(tmp_path):
    """run_egoego on a synthetic demo fixture (demo_ares_data.p with the
    authors' cluster paths in of_files, droid_slam_res/{scene}/{name}.npy):
    one npz per sequence with finite predictions."""
    rng = np.random.RandomState(2)
    root = tmp_path / "ares"
    feat_dir = root / "feats"
    scene_dir = root / "droid_slam_res" / "frl_apartment_4"
    for d in (feat_dir, scene_dir):
        d.mkdir(parents=True)
    cluster = "/viscam/u/jiamanli/datasets/egomotion_syn_dataset/habitat_rendering_replica_all"
    rec = _head_record(rng, "frl_apartment_4-demo_seq", feat_dir, of_prefix=(cluster, str(root)))
    with open(root / "demo_ares_data.p", "wb") as f:
        pickle.dump({0: rec}, f)
    _slam_npy(rng, scene_dir / "demo_seq.npy")
    stats, rest = _stats_and_rest(tmp_path, rng)
    written = run_egoego.run(run_egoego.parse_opt([
        "--data_root_folder", str(root), "--stats_path", stats, "--rest_offsets", rest,
        "--out_dir", str(tmp_path / "out"), *SMALL_RUN]))
    assert len(written) == 1
    out = np.load(written[0])
    assert set(out.files) == {"local_aa", "root_pos", "head_pose", "pred_scale", "pred_jpos"}
    assert out["local_aa"].shape == (T + 1, 22, 3) and out["pred_jpos"].shape == (T + 1, 22, 3)
    assert all(np.isfinite(out[k]).all() for k in out.files)


@pytest.mark.parametrize("flag", ["--export_objs", "--save_html_vis"])
def test_run_egoego_unported_flags_raise(tmp_path, flag):
    """Both flags are ported: each run writes its npz and the flag's output
    (one .obj per frame under <seq>_objs/ through a synthetic SMPL-H model
    at --smplh_path, or <seq>.html) beside it."""
    import chip_smoke

    root = tmp_path / "ares"
    name = chip_smoke.write_ares_demo_fixture(str(root), np.random.RandomState(3), n_seqs=1, frames=T)[0]
    stats, rest = _stats_and_rest(tmp_path, np.random.RandomState(4))
    smplh = chip_smoke.write_smplh_models(str(tmp_path / "smplh"), np.random.RandomState(5), 104, 60,
                                          genders=("male",))
    written = run_egoego.run(run_egoego.parse_opt([
        "--data_root_folder", str(root), "--stats_path", stats, "--rest_offsets", rest, "--smplh_path", smplh,
        "--out_dir", str(tmp_path / "out"), flag, *SMALL_RUN]))
    assert [p.rsplit("/", 1)[-1] for p in written] == [name + ".npz"]
    if flag == "--export_objs":
        assert sorted(os.listdir(tmp_path / "out" / (name + "_objs"))) == [f"{i:05d}.obj" for i in range(T + 1)]
    else:
        assert "const DATA = " in (tmp_path / "out" / (name + ".html")).read_text()
