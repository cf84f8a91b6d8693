"""The port's physics evaluation against the JAX package on the CPU:
``ops/mujoco_compat.py``, ``rl/mujoco_env.py`` (with the port's control
laws), ``eval/physics_metrics.py`` and ``eval_trajar --physics_metrics``.

The MJCF is ``chip_smoke.write_humanoid_xml(..., physics=True)`` from
random rest offsets: kinpoly's global-coordinate convention, capsule
geoms, a motor per hinge and a floor plane (the reference's XML is not in
this checkout). MuJoCo runs on the host in both packages; the control laws
at f32 in both.

Tolerances: the converted XML string equal; the qpos after two control
steps (30 substeps) within 1e-4 absolute; the physics metrics of the same
trajectory equal (the same host code on the same MuJoCo state); the CLI's
means within 1e-4 relative (or absolute below 1), as
``tests/test_torch_trajar.py`` holds eval_trajar's (the two rollouts
differ by f32 rounding, and the physics suite reads them).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.eval import physics_metrics as jpm
from egoego_release_tpu.ops import mujoco_compat as jcompat
from egoego_release_tpu.rl.mujoco_env import MujocoHumanoidEnv as JEnv
from egoego_release_tpu_torch.eval import physics_metrics as tpm
from egoego_release_tpu_torch.ops import mujoco_compat as tcompat
from egoego_release_tpu_torch.rl.mujoco_env import MujocoHumanoidEnv as TEnv
from test_torch_trajar import JittedTrajARNet, _chip_smoke, calm


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("physics")
    rng = np.random.RandomState(0)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    rest[0] = 0.0
    xml = cs.write_humanoid_xml(str(root / "humanoid.xml"), cs.smpl_rest_to_mujoco(rest), physics=True)
    return dict(cs=cs, root=root, rest=rest, xml=xml, jenv=JEnv(xml, residual_force=False),
                tenv=TEnv(xml, residual_force=False, device="cpu"))


def _standing(env, t=8, z=2.0, seed=0):
    rng = np.random.RandomState(seed)
    q = np.zeros((t, env.model.nq))
    q[:, 2] = z
    q[:, 3] = 1.0
    q[:, 7:] = rng.uniform(-0.3, 0.3, (t, env.model.nq - 7))
    return q


def test_convert_global_mjcf_equals_jax(model):
    assert tcompat.convert_global_mjcf(model["xml"]) == jcompat.convert_global_mjcf(model["xml"])
    m = tcompat.load_humanoid_model(model["xml"])
    assert (m.nq, m.nv, m.nu) == (76, 75, 69) and m.body_mass.sum() > 0


@pytest.mark.parametrize("rfc", [False, True])
def test_do_simulation_matches_jax(model, rfc):
    """Two 30 Hz control steps (15 substeps each, the PD torque and the
    residual force recomputed every substep) from the same state."""
    jenv, tenv = JEnv(model["xml"], residual_force=rfc), TEnv(model["xml"], residual_force=rfc, device="cpu")
    rng = np.random.RandomState(3)
    q0 = _standing(jenv, 1, z=1.2)[0]
    target = q0[7:] + rng.uniform(-0.2, 0.2, 69)
    out = {}
    for name, env in (("jax", jenv), ("port", tenv)):
        env.reset(q0)
        for k in range(2):
            action = np.random.RandomState(10 + k).randn(env.action_dim) * 0.1
            qpos, qvel = env.do_simulation(action, target)
        out[name] = qpos
    assert np.abs(out["port"] - out["jax"]).max() <= 1e-4
    assert np.abs(out["port"] - q0).max() > 1e-3  # the controls moved the body


def test_compute_physics_metrics_equals_jax(model):
    """A trajectory clear of the floor and one buried in it."""
    jenv, tenv = model["jenv"], model["tenv"]
    clear = _standing(jenv)
    buried = clear.copy()
    buried[:, 2] = 0.0
    for q, pen in ((clear, False), (buried, True)):
        want, got = jpm.compute_physics_metrics(jenv, q), tpm.compute_physics_metrics(tenv, q)
        assert got["pen"] == want["pen"] and got["sliding"] == want["sliding"]
        assert got["pen_seq_info"] == want["pen_seq_info"]
        np.testing.assert_array_equal(got["joint_pos"], want["joint_pos"])
        np.testing.assert_array_equal(got["head_pose"], want["head_pose"])
        assert (got["pen"] > 10.0) if pen else (got["pen"] == 0.0)


def test_interaction_success_equals_jax(model):
    jenv, tenv = model["jenv"], model["tenv"]
    floor, pelvis = 0, next(iter(tpm._geom_ids_for_bodies(tenv, {"Pelvis"})))
    ankle = next(iter(tpm._geom_ids_for_bodies(tenv, {"L_Ankle"})))
    t = 6
    world = tenv._mj.mj_id2name(tenv.model, tenv._mj.mjtObj.mjOBJ_BODY, 0)
    pen_sit = [[] for _ in range(t)]
    pen_sit[2] = pen_sit[3] = [(floor, pelvis, 0.02, 0.022)]
    pen_step = [[] for _ in range(t)]
    pen_step[2] = [(floor, ankle, 0.01, 0.012)]
    traj, rise = np.zeros((t, 76)), np.zeros((t, 76))
    rise[3:, 2] = 0.2
    head, far = np.zeros((t, 7)), np.zeros((t, 7))
    far[-1, :3] = 1.0
    moved = np.zeros((t, 10))
    moved[-1, 7:10] = [0.2, 0.0, 0.0]
    cases = [("None", pen_sit, traj, head, {}), ("None", pen_sit, traj, head, {"fail_safe": True}),
             ("sit", pen_sit, traj, head, {"obj_body_names": (world,)}),
             ("avoid", pen_step, traj, head, {"obj_body_names": (world,)}),
             ("avoid", [[]] * t, traj, head, {"obj_body_names": (world,)}),
             ("avoid", [[]] * t, traj, far, {"obj_body_names": (world,)}),
             ("push", pen_sit, traj, head, {"obj_pose": np.zeros((t, 10))}),
             ("push", pen_sit, traj, head, {"obj_pose": moved}),
             ("step", pen_step, rise, head, {"obj_body_names": (world,)}),
             ("step", pen_step, traj, head, {"obj_body_names": (world,)})]
    results = []
    for action, pen, tr, hp, kw in cases:
        want = jpm.interaction_success(action, pen, tr, hp, head_pose_gt=head, env=jenv, **kw)
        got = tpm.interaction_success(action, pen, tr, hp, head_pose_gt=head, env=tenv, **kw)
        assert got == want, (action, kw)
        results.append(got)
    assert True in results and False in results
    for action, kw in (("sit", {"obj_body_names": ("Chair",)}), ("push", {})):
        with pytest.raises(ValueError):
            tpm.interaction_success(action, pen_sit, traj, head, head_pose_gt=head, env=tenv, **kw)
    np.testing.assert_array_equal(tpm.contiguous_regions(np.array([0, 1, 1, 0, 1], bool)),
                                  jpm.contiguous_regions(np.array([0, 1, 1, 0, 1], bool)))
    onehot = np.array([0, 1, 0, 0])
    np.testing.assert_array_equal(tpm.convert_obj_qpos(onehot, np.arange(14.0)),
                                  jpm.convert_obj_qpos(onehot, np.arange(14.0)))


def test_eval_trajar_physics_metrics_matches_jax(model, tmp_path, monkeypatch):
    """Both CLIs with --mujoco_xml --physics_metrics over two expert records
    on the same weights (the JAX CLI's checkpointer handed them in memory, its
    apply jitted; the port reading a .pt)."""
    import orbax.checkpoint as ocp

    from egoego_release_tpu.eval import eval_trajar as je
    from egoego_release_tpu.eval import qpos_metrics as jqm
    from egoego_release_tpu.models import trajar as jt
    from egoego_release_tpu_torch.data import formats as tformats
    from egoego_release_tpu_torch.eval import eval_trajar as te
    from egoego_release_tpu_torch.preprocess.qpos import convert_motion_pickle
    from egoego_release_tpu_torch.utils.convert import trajar_state_dict_from_jax

    cs, rest, root = model["cs"], model["rest"], tmp_path
    fr, hdim = 8, 16
    np.save(root / "rest.npy", rest)
    cs.smooth_motion_pickle(str(root / "motion.p"), np.random.RandomState(1), 2)
    motion = tformats.load_pickle(str(root / "motion.p"))
    for rec in motion.values():  # a root that turns about y too (test_torch_trajar.calm)
        rec["root_orient"][:, 1] = 0.05 + 0.1 * np.sin(np.arange(len(rec["root_orient"])) / 20.0)
    tformats.save_pickle(motion, str(root / "motion.p"))
    convert_motion_pickle(str(root / "motion.p"), str(root / "expert.p"), rest, device="cpu")
    rec0 = next(iter(tformats.load_pickle(str(root / "expert.p")).values()))
    data = {k: jnp.asarray(rec0[k][None, :fr]) for k in ("head_pose", "head_vels", "obj_pose",
                                                         "obj_head_relative_poses")}
    jm = jt.TrajARNet(rnn_hdim=hdim, mlp_hsize=(1024, 512), rest_offsets=tuple(map(tuple, rest.tolist())))
    params = calm(jax.jit(jm.init)(jax.random.PRNGKey(1), data))
    monkeypatch.setattr(ocp, "PyTreeCheckpointer", lambda: type("Restore", (), {"restore": lambda self, path: params})())
    monkeypatch.setattr(je, "TrajARNet", JittedTrajARNet)
    for mod, name in ((je.fk_mod, "fk_smpl"), (je.geometry, "qpos_to_smpl"),
                      (je.metrics_mod, "compute_metrics_for_smpl")):
        monkeypatch.setattr(mod, name, jax.jit(getattr(mod, name)))
    qpos_fk, fk_jit = jqm.qpos_fk, {}
    monkeypatch.setattr(jqm, "qpos_fk", lambda sk, q: fk_jit.setdefault(id(sk), jax.jit(lambda q: qpos_fk(sk, q)))(q))
    (root / "jax_ckpt").mkdir()
    torch.save({"model": trajar_state_dict_from_jax(params), "rnn_hdim": hdim, "mlp_hsize": [1024, 512]},
               root / "final.pt")
    argv = ["--expert_path", str(root / "expert.p"), "--rest_offsets", str(root / "rest.npy"), "--fr_num", str(fr),
            "--rnn_hdim", str(hdim), "--mujoco_xml", model["xml"], "--physics_metrics", "--max_seqs", "2"]
    je.run(je.parse_opt(argv + ["--ckpt", str(root / "jax_ckpt"), "--out_dir", str(root / "j")]))
    te.run(te.parse_opt(argv + ["--ckpt", str(root / "final.pt"), "--out_dir", str(root / "t"), "--device", "cpu"]))
    want = json.load(open(root / "j" / "trajar_baseline_res.json"))["physics_metrics"]
    got = json.load(open(root / "t" / "trajar_baseline_res.json"))["physics_metrics"]
    assert sorted(got) == sorted(want) == ["pen_gt", "pen_pred", "slide_gt", "slide_pred", "succ"]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got[k], v)
    assert got["succ"] == 1.0  # "synthetic-trainN" takes: no object action
