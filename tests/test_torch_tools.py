"""The port's capability tools (egoego_release_tpu_torch/tools/
train_overfit_check.py, train_full_system_check.py,
train_kinematic_tracking.py) against the JAX tools (tools/*.py, loaded
with importlib) on the CPU, at small widths, on the files of
``chip_smoke.write_tools_fixture``; the JAX tools' path constants are
pointed at them by monkeypatching.

The trained numbers are not compared across packages: JAX draws batches
and noise from PRNGKeys, the port from seeded torch / numpy sources. The
deterministic parts are held on the same inputs and weights:
- the HeadNet training batches of ``train_full_system_check``: identical;
- ``trim_record``: identical; ``neutral_expert_record``: within 1e-6 of
  each array's max (f32 FK and codec, XLA against torch);
- tracking on a 30-frame record from the same policy weights
  (``utils.convert``), the per-frame MPJPE within 1e-3 of JAX's (relative,
  against max(JAX's, 1e-3 mm)): ``one_step_tracking`` (teacher-forced: one
  step from each expert state) on weights after 30 regression steps,
  against the same step composed from JAX's env, policy and
  ``step_qpos``; and, as a smoke check, ``eval_tracking``'s free rollout
  under a policy whose mean head is at 1e-2 of flax's scale, so that f32
  roundoff does not grow through saturating actions;
- ``bc_pretrain``: one regression step and one closed-loop step, each from
  the parameters JAX's step started from, every parameter tensor within
  1e-5 of its max |x| and the losses within 1e-5 relative; the closed-loop
  learning rate equal to optax's cosine schedule at every step within 1e-6
  relative (optax evaluates it in f32, the port in float64).
Each tool's ``main --device cpu`` runs end to end at its smallest knobs and
prints the JAX tool's JSON keys; without ``--device`` it asks for the card
and raises here; without its data paths it stops at the command line. ``train_overfit_check`` trains the release stage-2 model,
too large for the CPU tests: its ``DiffusionConfig`` is replaced by small
widths in the test.
"""

import dataclasses
import functools
import importlib
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egoego_release_tpu.rl import train_agent as jta
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import DiffusionConfig
from egoego_release_tpu_torch.preprocess import qpos as tqpos
from egoego_release_tpu_torch.rl import train_agent as tta
from egoego_release_tpu_torch.rl.ppo import GaussianPolicy, optax_adam
from egoego_release_tpu_torch.tools import train_full_system_check as tfull
from egoego_release_tpu_torch.tools import train_kinematic_tracking as tkin
from egoego_release_tpu_torch.tools import train_overfit_check as tover
from egoego_release_tpu_torch.tools._data import tool_rest_offsets
from egoego_release_tpu_torch.utils import convert
from test_torch_trajar import _chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]
HSIZE = [32, 16]


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol, what, floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * max(top, floor), f"{what}: {err} > {tol} x {top}"


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Two fixtures: a 40-frame demo for the stage-1 / stage-2 tools, and a
    6-frame one (a 5-frame standing take, 4-frame PPO windows, a (32, 16)
    policy) for the kinematic tool's runs, whose closed-loop BC rolls each
    take out at least 50 times."""
    cs = _chip_smoke()
    long = cs.write_tools_fixture(str(tmp_path_factory.mktemp("tools40")), np.random.RandomState(0), frames=40,
                                  neutral_frames=8, fr_num=6, policy_specs={"policy_hsize": HSIZE})
    short = cs.write_tools_fixture(str(tmp_path_factory.mktemp("tools6")), np.random.RandomState(1), frames=6,
                                   neutral_frames=5, fr_num=4, policy_specs={"policy_hsize": HSIZE})
    return {"long": long, "short": short, "rest": tool_rest_offsets()}


def expert_record(demo, rest, frames=None):
    """The port's expert record of the fixture's demo motion (its first ``frames``)."""
    rec = list(tkin.load_pickle(demo).values())[0]
    aa = np.concatenate([rec["root_orient"][:, None], rec["body_pose"].reshape(-1, 21, 3)], 1)
    out = tqpos.motion_to_expert(rec["trans"][:frames], aa[:frames], rest, device="cpu")
    out["seq_name"] = "demo"
    return out


@pytest.fixture(scope="module")
def kin(fx):
    """(JAX env, agent), (port env, agent) from the fixture's statear YAML;
    the JAX env's FK and observation jitted (each is otherwise hundreds of
    eagerly compiled ops)."""
    cfg = fx["short"]["cfg"]
    jenv, jagent = jta.build_from_config(jta.KinpolyConfig(cfg), fx["rest"], 2)
    jenv._body_pose = jax.jit(jenv._body_pose)
    jenv.obs = jax.jit(jenv.obs)
    return (jenv, jagent), tta.build_from_config(tta.KinpolyConfig(cfg), fx["rest"], 2, device="cpu")


def port_policy(tenv, tagent, params):
    policy = GaussianPolicy(tenv.obs_dim, tenv.action_dim, tagent.hsize, tagent.log_std_init)
    policy.load_state_dict(convert.policy_state_dict_from_jax(params))
    return policy


def close_params(policy, params, tol, what):
    want = convert.policy_state_dict_from_jax(params)
    got = policy.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].detach(), want[k], tol, f"{what} {k}")


# -- train_full_system_check ---------------------------------------------------


def test_headnet_batches_are_jax_crops(fx, monkeypatch):
    """The JAX tool's train_headnet with its trainer replaced by a recorder:
    the batches it builds equal the port's ``headnet_batch`` draws."""
    from egoego_release_tpu.training import trainer_stage1 as jts
    from egoego_release_tpu_torch.data.headpose import ARESDemoDataset
    from egoego_release_tpu_torch.utils.config import Stage1ModelConfig, load_config

    seen = []

    class Recorder:
        def __init__(self, *a, **kw):
            pass

        def init_state(self, params):
            return types.SimpleNamespace(params=params)

        def train_step(self, state, batch, key):
            seen.append(batch)
            return state, jnp.float32(0.0), None

    class NoModel:  # the batches need no model: skip flax's init
        def __init__(self, **kw):
            pass

        def init(self, *a):
            return {}

    from egoego_release_tpu.models import headnet as jheadnet

    monkeypatch.setattr(jts, "Stage1Trainer", Recorder)
    monkeypatch.setattr(jheadnet, "HeadFormer", NoModel)
    cfg = load_config(None)
    cfg = dataclasses.replace(cfg, headnet=Stage1ModelConfig(window=30, **tfull.TINY))
    rec = ARESDemoDataset(fx["long"]["root"])[0]
    steps, bs = 3, 4
    jax_tool("train_full_system_check").train_headnet(cfg, rec, steps, bs, jax.random.PRNGKey(10))
    assert len(seen) == steps
    rng = np.random.RandomState(0)
    for want in seen:
        got = tfull.headnet_batch(np.asarray(rec["of"], np.float32), np.asarray(rec["head_pose"], np.float32),
                                  np.asarray(rec["head_vels"], np.float32), 30, bs, rng)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_full_system_main_on_cpu(fx, monkeypatch, tmp_path):
    for k, v in dict(FULLSYS_S1_STEPS="2", FULLSYS_S1_BS="2", FULLSYS_S2_STEPS="2", FULLSYS_S2_BS="2",
                     FULLSYS_S2_ACCUM="1", FULLSYS_TINY="1", FULLSYS_SAVE=str(tmp_path / "save")).items():
        monkeypatch.setenv(k, v)
    argv = ["--demo_root", fx["long"]["root"], "--stats", fx["long"]["stats"]]
    out = tfull.main(argv + ["--device", "cpu"])
    regimes = ["stage1_trained", "stage1_random", "gt_record_head", "gt_fk_head"]
    assert list(out) == ["metric", "s1_steps", "s2_steps", "stage1_trained", "stage1_random"] + [
        f"e2e_{r}" for r in regimes]
    for r in regimes:
        assert set(out[f"e2e_{r}"]) == {"mpjpe_mm", "head_trans_dist_mm", "pred_fs_mm"}
        assert all(np.isfinite(v) for v in out[f"e2e_{r}"].values())
    assert set(out["stage1_trained"]) == {"head_pose_frob", "head_rot_frob", "head_traj_err_mm", "pred_scale"}
    assert sorted(p.name for p in (tmp_path / "save").iterdir()) == ["gravitynet.pt", "headnet.pt", "stage2_ema.pt"]
    from egoego_release_tpu_torch.utils.convert import load_stage2_diffusion_ckpt

    sd, step = load_stage2_diffusion_ckpt(str(tmp_path / "save" / "stage2_ema.pt"))
    assert step == 2 and sd
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfull.main(argv)


# -- train_overfit_check -------------------------------------------------------


def test_overfit_main_on_cpu(fx, monkeypatch, capsys):
    monkeypatch.setattr(tover, "DiffusionConfig", functools.partial(
        DiffusionConfig, d_model=64, n_head=2, n_dec_layers=2, d_k=32, d_v=32, window=60, timesteps=8))
    for k, v in dict(OVERFIT_STEPS="2", OVERFIT_BS="2", OVERFIT_ACCUM="1").items():
        monkeypatch.setenv(k, v)
    argv = ["--demo", fx["long"]["demo"], "--stats", fx["long"]["stats"]]
    out = tover.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert list(out) == ["metric", "steps", "micro_bs", "grad_accum", "remat", "train_seconds",
                         "window_grads_per_sec", "mpjpe_random_init_mm", "mpjpe_trained_mm"]
    assert np.isfinite(out["mpjpe_random_init_mm"]) and np.isfinite(out["mpjpe_trained_mm"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tover.main(argv)


# -- train_kinematic_tracking --------------------------------------------------


def test_trim_record_matches_jax(fx):
    rec = expert_record(fx["short"]["demo"], fx["rest"])
    want = jax_tool("train_kinematic_tracking").trim_record(rec, 6)
    got = tkin.trim_record(rec, 6)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    assert got["qpos"].shape[0] == 6 and got["qvel"].shape[0] == 5


def test_neutral_expert_record_matches_jax(fx, monkeypatch):
    """Every array within 1e-6 of its max, the velocities (finite
    differences over dt) within 1e-6 / dt of the positions' max."""
    from egoego_release_tpu.ops import fk as jfk
    from egoego_release_tpu.ops import geometry as jgeom
    from egoego_release_tpu.preprocess import qpos as jqpos

    jtool = jax_tool("train_kinematic_tracking")
    monkeypatch.setattr(jtool, "NEUTRAL", fx["short"]["neutral"])
    for mod, name in ((jgeom, "smpl_to_qpos"), (jgeom, "get_head_vel"), (jfk, "fk_smpl"), (jqpos, "get_qvel_fd")):
        monkeypatch.setattr(mod, name, jax.jit(getattr(mod, name)))
    want = jtool.neutral_expert_record(fx["rest"])
    got = tkin.neutral_expert_record(fx["rest"], fx["short"]["neutral"], device="cpu")
    assert sorted(got) == sorted(want) and got["seq_name"] == want["seq_name"] == "standing_neutral"
    pos = {"qvel": "qpos", "head_vels": "head_pose"}
    for k in want:
        if k in pos:  # finite differences over dt = 1/30 of the positions
            _close(got[k], want[k], 30.0 * 1e-6, k, floor=float(np.abs(want[pos[k]]).max()))
        elif k != "seq_name":
            _close(got[k], want[k], 1e-6, k)


def test_eval_tracking_matches_jax(fx, kin):
    (jenv, jagent), (tenv, tagent) = kin
    rec = expert_record(fx["long"]["demo"], fx["rest"], 30)
    params = jax.tree_util.tree_map(lambda x: x, jagent.init_state(jax.random.PRNGKey(0))["policy"])
    params["params"]["fc"]["kernel"] = params["params"]["fc"]["kernel"] * 1e-2
    want = jax_tool("train_kinematic_tracking").eval_tracking(jenv, jagent, {"policy": params}, rec, fx["rest"])
    got = tkin.eval_tracking(tenv, tagent, {"policy": port_policy(tenv, tagent, params)}, rec, fx["rest"])
    pf, pf_j = got["per_frame_mpjpe_mm"], np.asarray(want["per_frame_mpjpe_mm"])
    assert pf.shape == pf_j.shape == (30,) and pf_j[1:].min() > 1.0
    rel = np.abs(pf - pf_j) / np.maximum(pf_j, 1e-3)
    assert rel.max() <= 1e-3, rel.max()
    for k in ("mpjpe_mm", "global_mpjpe_mm", "head_dist_mm"):
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
    # a cold start at frame 20: the rollout's first frame is the expert's
    cold = tkin.eval_tracking(tenv, tagent, {"policy": port_policy(tenv, tagent, params)}, rec, fx["rest"], start=20)
    assert cold["per_frame_mpjpe_mm"].shape == (10,) and cold["per_frame_mpjpe_mm"][0] == 0.0


def jax_one_step_tracking(jenv, jagent, params, rec):
    """JAX's teacher-forced step, composed as its bc_pretrain builds phase
    1's batch: from each expert state the policy's mean, clipped to +-20,
    through step_qpos; the root-centred MPJPE in mm against the next frame."""
    from egoego_release_tpu.models.trajar import step_qpos
    from egoego_release_tpu.rl.env import EnvState

    qpos, qvel_fd = jnp.asarray(rec["qpos"]), jnp.asarray(rec["qvel"])
    b = qpos.shape[0] - 1
    qvel = jnp.concatenate([jnp.zeros((1, qvel_fd.shape[1])), qvel_fd])
    expert = {k: jnp.repeat(jnp.asarray(rec[k])[:, None], b, axis=1) for k in ("qpos", "head_pose", "head_vels")}
    state = EnvState(qpos=qpos[:-1], qvel=qvel[:b], t=jnp.arange(b, dtype=jnp.int32), done=jnp.zeros((b,), bool))

    @jax.jit
    def step(params):
        mean, _ = jagent.policy.apply(params, jenv.obs(state, expert))
        nq, _ = step_qpos(qpos[:-1], jnp.clip(mean, -20.0, 20.0))
        pred, gt = jenv._body_pose(nq)[1], jenv._body_pose(qpos[1:])[1]
        pred_c, gt_c = pred - pred[:, 0:1], gt - gt[:, 0:1]
        return jnp.linalg.norm(pred_c - gt_c, axis=-1).mean(-1) * 1000.0
    return np.asarray(step(params))


def test_one_step_tracking_matches_jax(fx, kin):
    """On weights at a trained policy's magnitude: flax's init, then 30 of
    the port's regression steps (lr 1e-3), carried to JAX."""
    (jenv, jagent), (tenv, tagent) = kin
    rec = expert_record(fx["long"]["demo"], fx["rest"], 30)
    policy = port_policy(tenv, tagent, jagent.init_state(jax.random.PRNGKey(0))["policy"])
    obs, target = tkin.regression_data(tenv, [rec])
    opt = optax_adam(policy, 1e-3)
    losses = [float(tkin.regression_step(policy, opt, obs, target)) for _ in range(30)]
    assert losses[-1] < losses[0]
    params = convert.policy_params_from_state_dict(policy.state_dict())
    want = jax_one_step_tracking(jenv, jagent, params, rec)
    got = tkin.one_step_tracking(tenv, {"policy": policy}, rec)
    assert got.shape == want.shape == (29,) and want.min() > 1.0
    rel = np.abs(got - want) / np.maximum(want, 1e-3)
    assert rel.max() <= 1e-3, rel.max()


def test_cl_learning_rate_is_optax_schedule():
    for lr, steps in ((1e-3, 50), (3e-4, 1000)):
        sched = optax.cosine_decay_schedule(lr * 0.3, steps, alpha=0.05)
        for count in list(range(steps + 3)):
            want = float(sched(jnp.asarray(count, jnp.int32)))
            got = tkin.cl_learning_rate(count, lr, steps)
            assert abs(got - want) <= 1e-6 * want, (lr, steps, count, got, want)


def test_bc_pretrain_steps_match_jax(fx, kin, monkeypatch):
    """JAX's bc_pretrain(steps=1) with jax.jit recording its two jitted
    steps (``bc_step``, then the first ``closed_loop_step``, after which it
    stops); the port's steps from the parameters each JAX step started
    from, with fresh Adam states as JAX's. In float64 (JAX under
    ``enable_x64``; flax keeps the parameters f32, the activations promote):
    Adam's first step moves an entry by lr g / (|g| + 1e-8), so f32
    roundoff in a gradient near 1e-8 would move it by up to lr."""
    from egoego_release_tpu.models import trajar as jtrajar

    _, (tenv, tagent) = kin
    rec = {k: v.astype(np.float64) if isinstance(v, np.ndarray) else v
           for k, v in expert_record(fx["short"]["demo"], fx["rest"]).items()}
    with jax.enable_x64(True):  # the skeleton in float64 too: JAX's FK allocates in its dtype
        jenv, jagent = jta.build_from_config(jta.KinpolyConfig(fx["short"]["cfg"]), fx["rest"].astype(np.float64), 2)
    jenv._body_pose = jax.jit(jenv._body_pose)
    jenv.obs = jax.jit(jenv.obs)
    jtool = jax_tool("train_kinematic_tracking")
    calls, real_jit = [], jax.jit

    class Stop(Exception):
        pass

    def recording_jit(fn, *a, **kw):
        jf = real_jit(fn, *a, **kw)
        if fn.__name__ not in ("bc_step", "closed_loop_step"):
            return jf

        def call(*args):
            out = jf(*args)
            calls.append((fn.__name__, args[0], out[0], float(out[2])))
            if len(calls) == 2:
                raise Stop
            return out
        return call

    monkeypatch.setattr(jtrajar, "inverse_step_qpos", jax.jit(jtrajar.inverse_step_qpos))
    monkeypatch.setattr(jax, "jit", recording_jit)
    with jax.enable_x64(True), pytest.raises(Stop):
        jtool.bc_pretrain(jenv, jagent, rec, jax.random.PRNGKey(0), steps=1)
    monkeypatch.undo()
    (n0, p0, p1, loss0), (n1, q0, q1, loss1) = calls
    assert (n0, n1) == ("bc_step", "closed_loop_step")

    monkeypatch.setattr(tenv, "rest_offsets", tenv.rest_offsets.double())
    policy = port_policy(tenv, tagent, p0).double()
    obs, target = tkin.regression_data(tenv, [rec])
    got = float(tkin.regression_step(policy, optax_adam(policy, 1e-3), obs, target))
    assert abs(got - loss0) <= 1e-5 * abs(loss0), (got, loss0)
    close_params(policy, p1, 1e-5, "regression step")

    policy = port_policy(tenv, tagent, q0).double()
    got = float(tkin.closed_loop_step(tenv, policy, optax_adam(policy, 1e-3), [rec],
                                      tkin.cl_learning_rate(0, 1e-3, 50)))
    assert abs(got - loss1) <= 1e-5 * abs(loss1), (got, loss1)
    close_params(policy, q1, 1e-5, "closed-loop step")


@pytest.mark.parametrize("mode", ["single_holdout", "cross_take", "multi_take"])
def test_kinematic_main_on_cpu(fx, monkeypatch, tmp_path, capsys, mode):
    env = {"KIN_BC_STEPS": "2", "KIN_ITERS": "1", "KIN_ENVS": "2"}
    env.update({"single_holdout": {"KIN_HOLDOUT": "5"}, "cross_take": {"KIN_CROSS_TAKE": "1"},
                "multi_take": {"KIN_MULTI_TAKE": "1"}}[mode])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    f = fx["short"]
    argv = ["--demo", f["demo"], "--neutral", f["neutral"], "--cfg", f["cfg"], "--work_dir", str(tmp_path)]
    out = tkin.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    if mode == "multi_take":
        assert out["take_frames"] == {"demo": 6, "standing_neutral": 5, "demo_flip": 6, "demo_rot": 6,
                                      "standing_neutral_flip": 5, "standing_neutral_rot": 5}
        assert set(out) == {"metric", "bc_steps", "take_frames", "joint_real", "heldout_take", "take_list_ppo"}
        assert sorted(out["heldout_take"]) == ["demo+aug->standing_neutral", "standing_neutral+aug->demo"]
        assert out["take_list_ppo"]["takes"] == ["demo", "standing_neutral"]
        assert np.isfinite(out["take_list_ppo"]["demo_mpjpe_mm"])
    elif mode == "cross_take":
        assert set(out) == {"metric", "bc_steps", "take_frames", "directions"}
        assert sorted(out["directions"]) == ["demo->standing_neutral", "standing_neutral->demo"]
        assert all(np.isfinite(v) for r in out["directions"].values() for v in r.values())
    else:
        assert set(out) == {"metric", "iters", "num_envs", "bc_steps", "bc_seconds", "train_seconds", "tracking_bc",
                            "tracking_final", "tracking_untrained", "reward_first10", "reward_last10", "holdout"}
        assert set(out["tracking_final"]) == {"mpjpe_mm", "global_mpjpe_mm", "head_dist_mm"}
        assert out["holdout"]["train_frames"] == 5 and np.isfinite(out["holdout"]["cold_start_unseen_mpjpe_mm"])
        assert "demo sequence 6 frames" in out["metric"]
        assert sorted(p.name for p in tmp_path.iterdir()) == ["_kin_expert.p", "_kin_expert_train.p"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tkin.main(argv)


@pytest.mark.parametrize("tool", ["train_overfit_check", "train_full_system_check", "train_kinematic_tracking",
                                  "physics_tracking_check", "train_physics_controller"])
def test_main_needs_its_data_paths(tool, capsys):
    """No default data path: the reference data are not in the repository."""
    mod = importlib.import_module(f"egoego_release_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--device", "cpu"])
    assert e.value.code == 2 and "the following arguments are required" in capsys.readouterr().err
