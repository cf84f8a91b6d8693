"""The PyTorch port's geometry, floor, metric and schedule code against the
JAX package, on the same numpy inputs made from a seed (CPU).

Tolerances: 1e-5 absolute for float32 rotation/FK math on O(1) values
(both sides compute in f32 in possibly different operation orders); the
metric suite is compared relative 1e-5 (its values reach ~1e3 mm).
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.diffusion import schedule as jschedule
from egoego_release_tpu.eval import metrics as jmetrics
from egoego_release_tpu.ops import fk as jfk
from egoego_release_tpu.ops import floor as jfloor
from egoego_release_tpu.ops import geometry as jgeometry
from egoego_release_tpu.ops import heading as jheading
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu_torch.diffusion import schedule as tschedule
from egoego_release_tpu_torch.eval import metrics as tmetrics
from egoego_release_tpu_torch.ops import fk as tfk
from egoego_release_tpu_torch.ops import floor as tfloor
from egoego_release_tpu_torch.ops import geometry as tgeometry
from egoego_release_tpu_torch.ops import heading as theading
from egoego_release_tpu_torch.ops import rotations as trot

ATOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _mats(rng, n):
    """Rotation matrices covering all four Shepperd pivots: random ones plus
    near-180-degree turns about each axis."""
    q = _quats(rng, n)
    m = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    flips = [np.diag(v).astype(np.float32) for v in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
    return np.concatenate([m, np.stack(flips)], 0)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", [
    "quat_multiply", "quat_apply", "quat_to_matrix", "matrix_to_quat", "axis_angle_to_quat",
    "quat_to_axis_angle", "rot6d_to_matrix", "matrix_to_rot6d", "quat_between",
])
def test_rotations_match_jax(name):
    rng = np.random.RandomState(0)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    v = rng.randn(64, 3).astype(np.float32)
    if name in ("quat_multiply",):
        args = (q1, q2)
    elif name == "quat_apply":
        args = (q1, v)
    elif name == "quat_between":
        args = (v, rng.randn(64, 3).astype(np.float32))
    elif name in ("quat_to_matrix", "quat_to_axis_angle"):
        args = (q1,)
    elif name in ("matrix_to_quat", "matrix_to_rot6d"):
        args = (_mats(rng, 64),)
    elif name == "axis_angle_to_quat":
        aa = rng.randn(64, 3).astype(np.float32)
        aa[:4] *= 1e-7  # the small-angle Taylor branch
        args = (aa,)
    else:
        args = (rng.randn(64, 6).astype(np.float32),)
    out_t = getattr(trot, name)(*(torch.from_numpy(a) for a in args))
    out_j = getattr(jrot, name)(*(jnp.asarray(a) for a in args))
    if name == "quat_to_axis_angle":
        # compare rotations, not their axis-angle encodings
        out_t = trot.axis_angle_to_matrix(out_t)
        out_j = jrot.axis_angle_to_matrix(out_j)
    _close(out_t, out_j)


def test_matrix_to_axis_angle_as_rotation():
    rng = np.random.RandomState(1)
    m = _mats(rng, 32)
    aa_t = trot.matrix_to_axis_angle(torch.from_numpy(m))
    aa_j = jrot.matrix_to_axis_angle(jnp.asarray(m))
    _close(trot.axis_angle_to_matrix(aa_t), jrot.axis_angle_to_matrix(aa_j), atol=2e-5)


def test_rotate_at_frame_matches_jax():
    rng = np.random.RandomState(2)
    trans = rng.randn(3, 17, 3).astype(np.float32)
    quat = _quats(rng, 51).reshape(3, 17, 4)
    out_t = theading.rotate_at_frame(torch.from_numpy(trans), torch.from_numpy(quat))
    out_j = jheading.rotate_at_frame(jnp.asarray(trans), jnp.asarray(quat))
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        _close(a, b)


def test_fk_and_ik_match_jax():
    rng = np.random.RandomState(3)
    root = rng.randn(9, 3).astype(np.float32)
    aa = (rng.randn(9, 22, 3) * 0.5).astype(np.float32)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    gq_t, gp_t = tfk.fk_smpl(torch.from_numpy(root), torch.from_numpy(aa), torch.from_numpy(rest))
    gq_j, gp_j = jfk.fk_smpl(jnp.asarray(root), jnp.asarray(aa), jnp.asarray(rest))
    _close(gq_t, gq_j)
    _close(gp_t, gp_j)
    _close(tfk.ik_to_local_quat(gq_t), jfk.ik_to_local_quat(gq_j))


def _floor_jpos(seed, n=4, t=60):
    """Toe trajectories with still stretches at a few heights, so the
    clustering sees core, border and noise points."""
    rng = np.random.RandomState(seed)
    jpos = rng.randn(n, t, 22, 3).astype(np.float32) * 0.05
    for i in range(n):
        for toe in (10, 11):
            steps = np.where(rng.rand(t, 3) < 0.6, rng.randn(t, 3) * 0.0015, rng.randn(t, 3) * 0.03)
            path = np.cumsum(steps, 0)
            path[:, 2] = rng.choice([0.0, 0.004, 0.02, 0.1], t) + rng.randn(t) * 0.001
            jpos[i, :, toe] = path
    return jpos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_floor_matches_jax(seed):
    jpos = _floor_jpos(seed)
    out_t = tfloor.floor_heights(torch.from_numpy(jpos))
    out_j = jfloor.floor_heights(jnp.asarray(jpos))
    _close(out_t, out_j, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_host_floor_matches_jax(seed):
    """The port's numpy DBSCAN against the JAX package's (sklearn where
    installed): same floor, contacts and terrain flag."""
    for seq in _floor_jpos(seed):
        f_t, c_t, d_t = tgeometry.determine_floor_height_and_contacts(seq, fps=30)
        f_j, c_j, d_j = jgeometry.determine_floor_height_and_contacts(seq, fps=30)
        assert f_t == pytest.approx(f_j, abs=1e-7)
        np.testing.assert_array_equal(c_t, c_j)
        assert d_t == d_j


@pytest.mark.parametrize("batched", [False, True])
def test_metrics_match_jax(batched):
    """One sequence against compute_metrics_for_smpl, and a batch of three
    in one call against the JAX package's vmapped batched_metrics_for_smpl."""
    rng = np.random.RandomState(4)
    t, lead = 30, ((3,) if batched else ())
    q = lambda: _quats(rng, int(np.prod(lead + (t, 22)))).reshape(lead + (t, 22, 4))
    p = lambda: rng.randn(*lead, t, 22, 3).astype(np.float32) * 0.3
    f = lambda v: np.full(lead, v, np.float32)
    args = [q(), p(), f(0.01), q(), p(), f(-0.02)]
    md_t = tmetrics.compute_metrics_for_smpl(*(torch.as_tensor(a) for a in args))
    jfn = jmetrics.batched_metrics_for_smpl if batched else jmetrics.compute_metrics_for_smpl
    md_j = jfn(*(jnp.asarray(a) for a in args))
    assert set(md_t) == set(md_j)
    for k in md_j:
        np.testing.assert_allclose(md_t[k].numpy(), np.asarray(md_j[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("schedule,steps", [("cosine", 1000), ("cosine", 6), ("linear", 50)])
def test_schedule_matches_jax(schedule, steps):
    ct = tschedule.make_diffusion_constants(steps, schedule)
    cj = jschedule.make_diffusion_constants(steps, schedule)
    for name in ct._fields:
        np.testing.assert_array_equal(getattr(ct, name), np.asarray(getattr(cj, name)), err_msg=name)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "egoego_release_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 70
    names = {str(f.relative_to(REPO / "egoego_release_tpu_torch")) for f in files[:-1]}
    assert names >= {f"preprocess/{m}.py" for m in ("amass", "qpos", "ares", "ego_camera", "augment", "mocap_skeleton")}
    assert names >= {"models/trajar.py", "models/posereg.py", "training/train_trajar.py", "training/train_posereg.py",
                     "eval/eval_trajar.py", "eval/eval_sweep.py", "data/kinpoly.py"}
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax", "joblib", "egoego_release_tpu"), (f, mod)


def _slice15_entry(entry, tmp_path):
    """A call of one of slice 15's entry points on a tiny fixture, taking the
    device keywords of ``test_entry_points_need_cuda_unless_cpu``'s make()."""
    import importlib.util

    from egoego_release_tpu_torch.data.formats import save_pickle

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.RandomState(0)
    rest = tmp_path / "rest.npy"
    dev = lambda kw: ["--device", kw["device"]] if kw else []
    if entry == "amass":
        from egoego_release_tpu_torch.preprocess import amass

        cs.write_smplh_models(str(tmp_path / "smplh"), rng, n_verts=104, n_faces=8, genders=("male",))
        cs.write_amass_fixture(str(tmp_path / "raw"), rng, [("CMU", "walk", 150, 60, False)])
        return lambda **kw: amass.main(["process", "--amass_root", str(tmp_path / "raw"), "--smplh_path",
                                        str(tmp_path / "smplh"), "--out", str(tmp_path / "out")] + dev(kw))
    if entry == "qpos":
        from egoego_release_tpu_torch.preprocess import qpos

        cs.smooth_motion_pickle(str(tmp_path / "motion.p"), rng, 1)
        return lambda **kw: qpos.main(["--motion_path", str(tmp_path / "motion.p"), "--out", str(tmp_path / "e.p"),
                                       "--rest_offsets", str(rest)] + dev(kw))
    t = 8
    expert = {"take": {"seq_name": "take", "qpos": np.tile(np.r_[0, 0, 0.9, 1, 0, 0, 0, np.full(69, 0.1)], (t, 1)),
                       "qvel": np.zeros((t - 1, 75)), "head_pose": np.tile([0, 0, 1.5, 1, 0, 0, 0], (t, 1)),
                       "head_vels": np.zeros((t, 6)), "obj_pose": np.tile([0, 0, 0, 1, 0, 0, 0], (t, 1)),
                       "obj_head_relative_poses": np.zeros((t, 7))}}
    save_pickle({k: {n: np.asarray(v, np.float32) if n != "seq_name" else v for n, v in r.items()}
                 for k, r in expert.items()}, str(tmp_path / "expert.p"))
    if entry == "train_trajar":
        from egoego_release_tpu_torch.training import train_trajar

        return lambda **kw: train_trajar.main(["--expert_path", str(tmp_path / "expert.p"), "--rest_offsets",
                                               str(rest), "--epochs", "1", "--fr_num", "4", "--batch_size", "1",
                                               "--save_dir", str(tmp_path / "trajar")] + dev(kw))
    if entry == "train_posereg":
        from egoego_release_tpu_torch.training import train_posereg

        save_pickle({"take": rng.randn(t, 16).astype(np.float32)}, str(tmp_path / "feats.p"))
        return lambda **kw: train_posereg.main(["--expert_path", str(tmp_path / "expert.p"), "--of_feats_path",
                                                str(tmp_path / "feats.p"), "--fr_num", "4", "--epochs", "1"] + dev(kw))
    from egoego_release_tpu_torch.eval import eval_trajar

    return lambda **kw: eval_trajar.main(["--expert_path", str(tmp_path / "expert.p"), "--rest_offsets", str(rest),
                                          "--fr_num", "4", "--rnn_hdim", "8", "--out_dir", str(tmp_path)] + dev(kw))


@pytest.mark.parametrize("entry", ["diffusion", "build", "cli", "train", "amass", "qpos", "train_trajar",
                                   "train_posereg", "eval_trajar"])
def test_entry_points_need_cuda_unless_cpu(entry, tmp_path, monkeypatch):
    """Without CUDA the entry points raise on their default device and run
    when the caller passes device='cpu'."""
    import joblib

    from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
    from egoego_release_tpu_torch.eval import eval_stage2
    from egoego_release_tpu_torch.eval.build import build_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(window=8, timesteps=2)
    stats = tmp_path / "stats.p"
    joblib.dump({"global_jpos_min": -np.ones((22, 3)), "global_jpos_max": np.ones((22, 3))}, stats)
    rest = tmp_path / "rest.npy"
    np.save(rest, np.zeros((22, 3), np.float32))
    if entry == "diffusion":
        cfg = DiffusionConfig(d_model=16, n_head=2, d_k=8, d_v=8, n_dec_layers=2, **small)
        make = lambda **kw: CondGaussianDiffusion(cfg, **kw)
    elif entry == "build":
        make = lambda **kw: build_pipeline(stats_path=str(stats), rest_offsets_path=str(rest), **kw)
    elif entry == "cli":
        def make(**kw):
            argv = ["--test_data_path", str(tmp_path / "none.p"), "--stats_path", str(stats),
                    "--rest_offsets", str(rest)] + (["--device", kw["device"]] if kw else [])
            joblib.dump({}, tmp_path / "none.p")
            return eval_stage2.run(eval_stage2.parse_opt(argv + ["--out_dir", str(tmp_path)]))
    elif entry == "train":
        from egoego_release_tpu_torch.training import train_diffusion

        motion = np.random.RandomState(0).uniform(-0.2, 0.2, (40, 69)).astype(np.float32)
        joblib.dump({0: {"trans": motion[:, :3], "root_orient": motion[:, 3:6], "body_pose": motion[:, 6:]}},
                    tmp_path / "train.p")

        def make(**kw):
            return train_diffusion.main(
                ["--train_data_path", str(tmp_path / "train.p"), "--set", "stage2.d_model=16",
                 "stage2.d_k=8", "stage2.d_v=8", "stage2.n_dec_layers=2", "stage2.timesteps=2",
                 "data.batch_size=2", "train.num_steps=1", f"data.rest_offsets={rest}",
                 f"logging.save_dir={tmp_path / 'runs'}"] + (["--device", kw["device"]] if kw else []))
    else:
        make = _slice15_entry(entry, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert make(device="cpu") is not None


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result without a card,
    also from a directory that holds nothing else of the repo."""
    import os
    import shutil
    import subprocess
    import sys

    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr
