"""The port's SMPL-H model (``ops/smpl``), the new ``ops/geometry`` and
``ops/rotations`` functions, the mesh and HTML exporters (``vis``) and
``run_egoego --export_objs --save_html_vis`` against the JAX package on the
CPU.

The SMPL-H npzs are synthetic (``chip_smoke.write_smplh_models``, small
vertex and face counts, SMPL-H's 52 joints and 16 betas): the real models
are licensed. Tolerances: LBS 1e-4 (f32 sums over 52 joints and the pose
blendshapes); rest joints and offsets, rotations and geometry 1e-5; .obj
vertices 1e-4 after their 6-decimal text; HTML data within one step of the
viewer's 4-decimal rounding plus 1e-5, 1.1e-4 (values 1e-5 apart may round
to neighbouring steps), and quantized mesh vertices within one uint16 step.
"""

import base64
import os
import pickle
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mujoco_qpos import JaxCliNoise, chain_windows, write_release_checkpoints

import chip_smoke
from egoego_release_tpu.eval import run_egoego as jrun
from egoego_release_tpu.ops import geometry as jgeo
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu.ops import smpl as jsmpl
from egoego_release_tpu.vis import html_viewer as jhtml
from egoego_release_tpu.vis import mesh_export as jmesh
from egoego_release_tpu_torch.eval import run_egoego
from egoego_release_tpu_torch.ops import geometry as tgeo
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.ops import smpl as tsmpl
from egoego_release_tpu_torch.vis import html_viewer as thtml
from egoego_release_tpu_torch.vis import mesh_export as tmesh

N_VERTS, N_FACES = 156, 120


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def smplh_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("smplh")
    return str(chip_smoke.write_smplh_models(str(root), np.random.RandomState(0), N_VERTS, N_FACES))


def _pose(rng, b, joints=52):
    return ((rng.randn(b, 16) * 0.5).astype(np.float32), (rng.randn(b, joints, 3) * 0.3).astype(np.float32),
            rng.randn(b, 3).astype(np.float32))


def test_load_smpl_npz_matches_jax(smplh_dir):
    path = os.path.join(smplh_dir, "male", "model.npz")
    tm, jm = tsmpl.load_smpl_npz(path), jsmpl.load_smpl_npz(path)
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "weights", "parents", "faces"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, name)), np.asarray(getattr(jm, name)), err_msg=name)
    assert tm.parents[0] == -1 and tm.shapedirs.shape[-1] == 16


@pytest.mark.parametrize("want_verts", [True, False])
def test_lbs_matches_jax(smplh_dir, want_verts):
    path = os.path.join(smplh_dir, "female", "model.npz")
    tm, jm = tsmpl.load_smpl_npz(path), jsmpl.load_smpl_npz(path)
    betas, pose, trans = _pose(np.random.RandomState(1), 4)
    jt, vt = tsmpl.lbs(tm, torch.from_numpy(betas), torch.from_numpy(pose), torch.from_numpy(trans), want_verts)
    jj, vj = jsmpl.lbs(jm, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(trans), want_verts)
    _close(jt.numpy(), jj, 1e-4)
    if want_verts:
        assert vt.shape == (4, N_VERTS, 3)
        _close(vt.numpy(), vj, 1e-4)
    else:
        assert vt is None and vj is None


def test_rest_joints_and_offsets_match_jax(smplh_dir):
    path = os.path.join(smplh_dir, "male", "model.npz")
    tm, jm = tsmpl.load_smpl_npz(path), jsmpl.load_smpl_npz(path)
    betas = np.random.RandomState(2).randn(1, 16).astype(np.float32)
    _close(tsmpl.rest_joints(tm).numpy(), jsmpl.rest_joints(jm), 1e-5)
    _close(tsmpl.rest_joints(tm, torch.from_numpy(betas)).numpy(), jsmpl.rest_joints(jm, jnp.asarray(betas)), 1e-5)
    _close(tsmpl.rest_offsets_22(tm).numpy(), jsmpl.rest_offsets_22(jm), 1e-5)


def test_gendered_smpl_run_matches_jax(smplh_dir):
    tg, jg = tsmpl.load_gendered_smpl(smplh_dir), jsmpl.load_gendered_smpl(smplh_dir)
    betas, pose, trans = _pose(np.random.RandomState(3), 4)
    is_female = np.array([True, False, False, True])
    jt, vt = tg.run(torch.from_numpy(betas), torch.from_numpy(pose), torch.from_numpy(trans),
                    torch.from_numpy(is_female))
    jj, vj = jg.run(jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(trans), jnp.asarray(is_female))
    _close(jt.numpy(), jj, 1e-4)
    _close(vt.numpy(), vj, 1e-4)


def test_rot6d_quat_round_trip_matches_jax():
    rng = np.random.RandomState(4)
    q = chip_smoke.smooth_quats(rng, 30)
    d6 = rng.randn(30, 6).astype(np.float32)
    _close(trot.quat_to_rot6d(torch.from_numpy(q)).numpy(), jrot.quat_to_rot6d(jnp.asarray(q)), 1e-5)
    _close(trot.rot6d_to_quat(torch.from_numpy(d6)).numpy(), jrot.rot6d_to_quat(jnp.asarray(d6)), 1e-5)


def _head_pose(rng, t):
    return np.concatenate([np.cumsum(rng.randn(t, 3) * 0.01, 0) + [0, 0, 1.6], chip_smoke.smooth_quats(rng, t)],
                          -1).astype(np.float32)


def test_get_head_vel_matches_jax():
    hp = _head_pose(np.random.RandomState(5), 40)
    got = tgeo.get_head_vel(torch.from_numpy(hp))
    assert got.shape == (40, 6)
    _close(got.numpy(), jgeo.get_head_vel(jnp.asarray(hp)), 1e-5, 1e-5)


@pytest.mark.parametrize("num_objs", [1, 2])
def test_get_obj_relative_pose_matches_jax(num_objs):
    rng = np.random.RandomState(6)
    ref = _head_pose(rng, 25)
    obj = np.concatenate([_head_pose(rng, 25) for _ in range(num_objs)], -1)
    _close(tgeo.get_obj_relative_pose(torch.from_numpy(obj), torch.from_numpy(ref), num_objs).numpy(),
           jgeo.get_obj_relative_pose(jnp.asarray(obj), jnp.asarray(ref), num_objs), 1e-5)


def test_smpl_to_qpos_matches_jax():
    rng = np.random.RandomState(7)
    trans, aa = rng.randn(20, 3).astype(np.float32), (rng.randn(20, 24, 3) * 0.4).astype(np.float32)
    got = tgeo.smpl_to_qpos(torch.from_numpy(trans), torch.from_numpy(aa))
    assert got.shape == (20, 76)
    _close(got.numpy(), jgeo.smpl_to_qpos(jnp.asarray(trans), jnp.asarray(aa)), 1e-5)


def _read_obj(path):
    v, f = [], []
    for line in open(path):
        kind, *vals = line.split()
        (v if kind == "v" else f).append([float(x) for x in vals])
    return np.asarray(v), np.asarray(f, np.int64)


def test_save_obj_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    verts, faces = rng.randn(10, 3).astype(np.float32), rng.randint(0, 10, (7, 3))
    tmesh.save_obj(str(tmp_path / "t.obj"), verts, faces)
    jmesh.save_obj(str(tmp_path / "j.obj"), verts, faces)
    assert open(tmp_path / "t.obj").read() == open(tmp_path / "j.obj").read()


def test_export_obj_sequence_matches_jax(smplh_dir, tmp_path):
    """5 frames in LBS batches of 2 (a ragged last batch): one .obj per frame,
    with the same names, faces and, within 1e-4, vertices as JAX's."""
    rng = np.random.RandomState(9)
    aa, root = (rng.randn(5, 22, 3) * 0.3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    got = tmesh.export_obj_sequence(smplh_dir, aa, root, str(tmp_path / "t"), batch=2, device="cpu")
    want = jmesh.export_obj_sequence(smplh_dir, aa, root, str(tmp_path / "j"), batch=2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == \
        [f"{i:05d}.obj" for i in range(5)]
    for a, b in zip(got, want):
        (va, fa), (vb, fb) = _read_obj(a), _read_obj(b)
        assert va.shape == (N_VERTS, 3)
        np.testing.assert_array_equal(fa, fb)
        _close(va, vb, 1e-4)


def same_html_data(a, b):
    """Equal structure; numbers within one step of the 4-decimal rounding
    plus 1e-5; quantized mesh vertices within one uint16 step."""
    assert a.keys() == b.keys()
    for k in a:
        if k == "vertsB64":
            qa, qb = (np.frombuffer(base64.b64decode(x), "<u2").astype(np.int64) for x in (a[k], b[k]))
            assert qa.shape == qb.shape and np.abs(qa - qb).max() <= 1
        elif isinstance(a[k], dict):
            same_html_data(a[k], b[k])
        elif isinstance(a[k], list) and a[k] and isinstance(a[k][0], dict):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                same_html_data(x, y)
        elif isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            _close(a[k], b[k], 1.1e-4)


@pytest.mark.parametrize("kind", ["skeleton", "mesh"])
def test_html_viewers_match_jax(kind, tmp_path):
    rng = np.random.RandomState(10)
    head = rng.randn(6, 3).astype(np.float32)
    if kind == "skeleton":
        jpos = rng.randn(6, 22, 3).astype(np.float32)
        args = (jpos,)
        kw = dict(gt_jpos=jpos + 0.1, head_traj=head, title="seq")
        fns = (thtml.vis_skeleton_motion_html, jhtml.vis_skeleton_motion_html)
    else:
        verts, faces = rng.randn(6, 30, 3).astype(np.float32), rng.randint(0, 30, (40, 3))
        args = (verts, faces)
        kw = dict(gt_verts=verts * 1.1, head_traj=head, title="seq")
        fns = (thtml.vis_mesh_motion_html, jhtml.vis_mesh_motion_html)
    paths = [fn(*args, str(tmp_path / f"{i}.html"), **kw) for i, fn in enumerate(fns)]
    got, want = (chip_smoke.html_data(p) for p in paths)
    assert got["numFrames"] == 6
    same_html_data(got, want)
    strip = lambda p: re.sub(r"const DATA = \{.*?\};\n", "", open(p).read(), flags=re.S)
    assert strip(paths[0]) == strip(paths[1])


def test_run_egoego_export_objs_and_html_match_jax_cli(smplh_dir, tmp_path, monkeypatch):
    """run_egoego --export_objs --save_html_vis --smplh_path on the CPU
    against the JAX CLI on the same weights (released .pt files), noise
    (JAX's keys replayed) and demo fixture: the same npz keys and values
    within 1e-4, the same .obj files (vertices within 1e-4) and the same
    HTML data."""
    root = str(tmp_path / "ares")
    names = chip_smoke.write_ares_demo_fixture(root, np.random.RandomState(11), n_seqs=1, frames=20)
    fx = {"stats": str(tmp_path / "stats.p"), "rest": str(tmp_path / "rest.npy")}
    with open(fx["stats"], "wb") as f:
        pickle.dump({"global_jpos_min": np.full((22, 3), -1.5, np.float32),
                     "global_jpos_max": np.full((22, 3), 1.5, np.float32)}, f)
    rng = np.random.RandomState(12)
    np.save(fx["rest"], np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32))
    ckpts = write_release_checkpoints(tmp_path)

    def argv(out):
        return ["--data_root_folder", root, "--stats_path", fx["stats"], "--rest_offsets", fx["rest"],
                "--smplh_path", smplh_dir, "--diffusion_ckpt", ckpts["diffusion"], "--headnet_ckpt",
                ckpts["headnet"], "--gravitynet_ckpt", ckpts["gravitynet"], "--window", "16", "--timesteps", "3",
                "--export_objs", "--save_html_vis", "--out_dir", str(tmp_path / out)]

    monkeypatch.setattr(run_egoego, "TorchNoise", lambda device, seed: JaxCliNoise(seed, chain_windows(21, 16)))
    written = run_egoego.run(run_egoego.parse_opt(argv("t") + ["--device", "cpu"]))
    jrun.run(jrun.parse_opt(argv("j")))
    name = names[0]
    assert [os.path.basename(p) for p in written] == [name + ".npz"]
    got, want = np.load(written[0]), np.load(tmp_path / "j" / (name + ".npz"))
    assert set(got.files) == set(want.files)
    for k in want.files:
        _close(got[k], want[k], 1e-4)
    objs = sorted(os.listdir(tmp_path / "t" / (name + "_objs")))
    assert objs == sorted(os.listdir(tmp_path / "j" / (name + "_objs"))) and len(objs) == 21
    for o in objs:
        (va, fa), (vb, fb) = (_read_obj(tmp_path / d / (name + "_objs") / o) for d in ("t", "j"))
        np.testing.assert_array_equal(fa, fb)
        _close(va, vb, 1e-4)
    same_html_data(*(chip_smoke.html_data(tmp_path / d / (name + ".html")) for d in ("t", "j")))
