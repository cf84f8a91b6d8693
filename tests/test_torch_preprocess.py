"""The port's preprocessing CLIs (AMASS, qpos, ARES, ego camera, the norm
stats) and its host-only copies (augment, mocap_skeleton) against the JAX
package on the CPU, on fixtures written here: synthetic SMPL-H models
(``chip_smoke.write_smplh_models``, small) and an AMASS-layout npz tree
(``chip_smoke.write_amass_fixture``) whose sequences hold still three
times, so that the floor fit finds clusters, one of them on a step, which
both discard.

Tolerance: 1e-5 (absolute) on every float array the CLIs write (joints,
trans, head poses and rotations, qpos, object poses, camera poses), and
30 x 1e-5 on the velocities (head_vels, qvel): finite differences over dt =
1/30 s carry 1/dt times the rounding of the poses they difference (an f32
quaternion's ~1e-7, doubled by the angle). The floor height within 1e-5;
the contacts, the discards, the files written and the pickles' keys equal.
The SMPL forward runs in chunks of 100 frames in both packages here, so
that a sequence spans several; every array has 100 frames at each step
(the sequences' lengths are chosen so), since JAX compiles each op anew
for each shape.
"""

import importlib.util
import os
import pathlib
import pickle

import joblib
import numpy as np
import pytest

from egoego_release_tpu.data import formats as jformats
from egoego_release_tpu.preprocess import amass as jamass
from egoego_release_tpu.preprocess import ares as jares
from egoego_release_tpu.preprocess import augment as jaug
from egoego_release_tpu.preprocess import ego_camera as jcam
from egoego_release_tpu.preprocess import mocap_skeleton as jmocap
from egoego_release_tpu.preprocess import qpos as jqpos
from egoego_release_tpu_torch.data import formats as tformats
from egoego_release_tpu_torch.preprocess import amass as tamass
from egoego_release_tpu_torch.preprocess import ares as tares
from egoego_release_tpu_torch.preprocess import augment as taug
from egoego_release_tpu_torch.preprocess import ego_camera as tcam
from egoego_release_tpu_torch.preprocess import mocap_skeleton as tmocap
from egoego_release_tpu_torch.preprocess import qpos as tqpos

ATOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent
# (subset, name, frames, fps, terrain): train and test subsets, 60 and 120 fps, one on a step
SEQS = (("CMU", "01_walk", 250, 60, False), ("KIT", "03_walk", 500, 120, False),
        ("HumanEva", "S1_walk", 250, 60, False), ("ACCAD", "step_up", 250, 60, True))
CHUNK = 100  # frames of an SMPL forward: every chunk here is whole, so JAX compiles one shape
VEL_ATOL = 30 * ATOL  # finite differences over dt = 1/30 s: 1/dt times the rounding of what they difference


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, what):
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if b.dtype.kind == "f":
            atol = VEL_ATOL if k in ("head_vels", "qvel") else ATOL
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """Both packages' ``amass process`` and ``aggregate`` on one fixture."""
    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("amass")
    rng = np.random.RandomState(0)
    cs.write_smplh_models(str(root / "smplh"), rng, n_verts=520, n_faces=64, genders=("male",))
    cs.write_amass_fixture(str(root / "raw"), rng, SEQS)
    mp = pytest.MonkeyPatch()
    mp.setattr(jamass, "SPLIT_FRAME_LIMIT", CHUNK)
    mp.setattr(tamass, "SPLIT_FRAME_LIMIT", CHUNK)
    out = {}
    for name, mod, extra in (("jax", jamass, []), ("port", tamass, ["--device", "cpu"])):
        mod.main(["process", "--amass_root", str(root / "raw"), "--smplh_path", str(root / "smplh"),
                  "--out", str(root / name)] + extra)
        mod.main(["aggregate", "--processed_root", str(root / name), "--out", str(root / name / "motion.p")])
        out[name] = root / name
    mp.undo()
    out["root"] = root
    return out


def _npzs(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*.npz"))


def test_amass_process_matches_jax(processed):
    names = _npzs(processed["jax"])
    assert names == _npzs(processed["port"])
    assert len(names) == 3 and not any("step_up" in n for n in names)  # the step is discarded by both
    for n in names:
        want, got = np.load(processed["jax"] / n), np.load(processed["port"] / n)
        assert sorted(got.files) == sorted(want.files)
        assert float(got["fps"]) == float(want["fps"]) == 30.0 and str(got["gender"]) == "male"
        assert abs(float(got["floor_height"]) - float(want["floor_height"])) <= ATOL
        assert want["contacts"].any()
        _close(got, {k: want[k] for k in want.files if k not in ("fps", "gender", "floor_height")}, n)


def test_aggregate_pickles_match_jax_and_cross_read(processed):
    for split in ("", "train_", "test_"):
        j_path, t_path = processed["jax"] / f"{split}motion.p", processed["port"] / f"{split}motion.p"
        want = joblib.load(j_path)
        for got in (joblib.load(t_path), tformats.load_motion_dict(str(t_path)),
                    tformats.load_pickle(str(j_path))):
            assert list(got) == list(want)
            for key in want:
                assert sorted(got[key]) == sorted(want[key])
                _close(got[key], want[key], f"{split}{key}")
    assert len(joblib.load(processed["port"] / "train_motion.p")) == 2
    assert len(joblib.load(processed["port"] / "test_motion.p")) == 1


def test_qpos_expert_pickle_matches_jax(processed, tmp_path):
    rest = np.random.RandomState(1).uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    rest[0] = 0.0
    np.save(tmp_path / "rest.npy", rest)
    motion = str(processed["port"] / "motion.p")
    jqpos.main(["--motion_path", motion, "--out", str(tmp_path / "jax.p"), "--rest_offsets",
                str(tmp_path / "rest.npy")])
    tqpos.main(["--motion_path", motion, "--out", str(tmp_path / "port.p"), "--rest_offsets",
                str(tmp_path / "rest.npy"), "--device", "cpu"])
    want, got = joblib.load(tmp_path / "jax.p"), tformats.load_pickle(str(tmp_path / "port.p"))
    assert list(got) == list(want) and len(want) == 3
    for key in want:
        assert sorted(got[key]) == sorted(want[key])
        assert got[key]["seq_name"] == want[key]["seq_name"] == key
        _close(got[key], {k: v for k, v in want[key].items() if k != "seq_name"}, key)
        assert got[key]["qvel"].shape[0] == got[key]["qpos"].shape[0] - 1


def test_norm_stats_pickles_cross_read(tmp_path):
    rng = np.random.RandomState(2)
    stats = {"global_jpos_min": rng.randn(22, 3).astype(np.float32),
             "global_jpos_max": rng.randn(22, 3).astype(np.float32),
             "global_jvel_min": rng.randn(22, 3).astype(np.float32),
             "global_jvel_max": rng.randn(22, 3).astype(np.float32)}
    tformats.save_norm_stats(str(tmp_path / "port.p"), stats)
    jformats.save_norm_stats(str(tmp_path / "jax.p"), stats)
    for path in ("port.p", "jax.p"):
        got_j = jformats.load_norm_stats(str(tmp_path / path))
        got_t = tformats.load_norm_stats(str(tmp_path / path))
        for k in ("jpos_min", "jpos_max"):
            np.testing.assert_array_equal(np.asarray(getattr(got_j, k)), stats[f"global_{k}"])
            np.testing.assert_array_equal(getattr(got_t, k).numpy(), stats[f"global_{k}"])
        raw = tformats.load_pickle(str(tmp_path / path))
        assert sorted(raw) == sorted(stats)
    with open(tmp_path / "port.p", "rb") as f:  # a plain pickle
        assert sorted(pickle.load(f)) == sorted(stats)


def test_ares_extract_and_process_match_jax(processed, tmp_path):
    cs = _chip_smoke()
    npz = _npzs(processed["port"])
    picks = [("office_0", "seqA", npz[0], 0, CHUNK), ("frl_apartment_0", "seqB", npz[1], 0, CHUNK),
             ("frl_apartment_0", "seqC", npz[2], 0, CHUNK)]
    out = {}
    for name, mod, extra in (("jax", jares, []), ("port", tares, ["--device", "cpu"])):
        render = tmp_path / name / "render"
        index = cs.write_render_fixture(str(render), str(processed["port"]), picks)
        mod.main(["extract", "--amass_processed_root", str(processed["port"]), "--rendered_root", str(render),
                  "--index_pkl", index])
        os.remove(index)
        mod.main(["--rendered_root", str(render), "--smplh_path", str(processed["root"] / "smplh"), "--out",
                  str(tmp_path / name / "out")] + extra)
        out[name] = tmp_path / name / "out"
    for seq in ("office_0/seqA", "frl_apartment_0/seqB"):
        a = np.load(tmp_path / "jax" / "render" / seq / "ori_motion_seq.npz")
        b = np.load(tmp_path / "port" / "render" / seq / "ori_motion_seq.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for split, n in (("", 3), ("train_", 2), ("test_", 1)):
        want = joblib.load(out["jax"] / f"{split}ares_smplh_motion.p")
        got = tformats.load_pickle(str(out["port"] / f"{split}ares_smplh_motion.p"))
        assert list(got) == list(want) and len(want) == n
        for key in want:
            w, g = want[key], got[key]
            assert sorted(g) == sorted(w) and g["seq_name"] == w["seq_name"] and g["gender"] == w["gender"]
            assert [os.path.basename(f) for f in g["of_files"]] == [os.path.basename(f) for f in w["of_files"]]
            _close(g, {k: v for k, v in w.items() if k not in ("seq_name", "gender", "of_files")}, key)


def test_ego_camera_matches_jax(processed, tmp_path):
    src = np.load(next(processed["port"].rglob("*.npz")))
    t = src["trans"].shape[0]
    for name in ("jax", "port"):
        d = tmp_path / name / "motion0"
        d.mkdir(parents=True)
        np.savez(d / "motion_seq.npz", root_orient=src["root_orient"], pose_body=src["pose_body"].reshape(t, 21, 3),
                 joints=src["joints"], head_cam_v_pos=src["joints"][:, 15] + [0.0, 0.05, 0.1])
        (tmp_path / name / "motion1").mkdir()
        np.savez(tmp_path / name / "motion1" / "motion_seq.npz", root_orient=src["root_orient"],
                 pose_body=src["pose_body"].reshape(t, 21, 3), joints=src["joints"])
    jcam.main(["--data_dir", str(tmp_path / "jax")])
    assert tcam.main(["--data_dir", str(tmp_path / "port"), "--device", "cpu"]) == 2
    for m in ("motion0", "motion1"):
        want = np.load(tmp_path / "jax" / m / "camera_poses.npz")
        got = np.load(tmp_path / "port" / m / "camera_poses.npz")
        assert sorted(got.files) == sorted(want.files)
        _close(got, want, m)
    # camera_poses_from_motion on (T, 3, 3) rotation matrices as well
    from egoego_release_tpu_torch.ops.rotations import axis_angle_to_matrix
    import torch

    mats = axis_angle_to_matrix(torch.as_tensor(src["pose_body"].reshape(t, 21, 3))).numpy()
    root = axis_angle_to_matrix(torch.as_tensor(src["root_orient"])).numpy()
    _close(tcam.camera_poses_from_motion(root, mats, src["joints"][:, 15], device="cpu"),
           jcam.camera_poses_from_motion(root, mats, src["joints"][:, 15]), "matrices")


def test_augment_matches_jax():
    rng = np.random.RandomState(3)
    pose = rng.uniform(-2.5, 2.5, (16, 72))
    np.testing.assert_array_equal(taug.flip_smpl(pose), jaug.flip_smpl(pose))
    np.testing.assert_array_equal(taug.sample_random_hemisphere_root(np.random.RandomState(5)),
                                  jaug.sample_random_hemisphere_root(np.random.RandomState(5)))
    np.testing.assert_array_equal(taug.get_random_shape(4, np.random.RandomState(6)),
                                  jaug.get_random_shape(4, np.random.RandomState(6)))
    seq, tran = rng.randn(400, 72), rng.randn(400, 3)
    got = taug.sample_seq_length(seq, tran, 150, np.random.RandomState(7))
    want = jaug.sample_seq_length(seq, tran, 150, np.random.RandomState(7))
    assert got[2] == want[2] and len(got[0]) == len(want[0]) == 2
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(x, y)
    for z in (0.5, 0.1):  # fixed or invalid; crawling
        qpos = rng.randn(30, 76)
        wbpos = rng.randn(30, 24, 3) * 0.3 + z
        got, want = taug.fix_height_qpos(qpos, wbpos), jaug.fix_height_qpos(qpos, wbpos)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def test_mocap_skeleton_matches_jax(tmp_path):
    bvh = (REPO / "tests" / "test_mocap_skeleton.py").read_text().split('BVH_TEXT = """')[1].split('"""')[0]
    (tmp_path / "a.bvh").write_text(bvh)
    outs = {}
    for name, mod in (("jax", jmocap), ("port", tmocap)):
        sk, qpos = mod.bvh_to_mjcf(str(tmp_path / "a.bvh"), str(tmp_path / f"{name}.xml"), str(tmp_path / f"{name}.npy"))
        outs[name] = ((tmp_path / f"{name}.xml").read_text(), qpos, [b.name for b in sk.bones])
    assert outs["port"][0] == outs["jax"][0]
    np.testing.assert_array_equal(outs["port"][1], outs["jax"][1])
    assert outs["port"][2] == outs["jax"][2]
