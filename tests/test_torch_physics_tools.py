"""The port's physics capability tools (egoego_release_tpu_torch/tools/
physics_tracking_check.py, train_physics_controller.py) against the JAX
tools (tools/*.py, loaded with importlib) on the CPU, on the MJCF of
``chip_smoke.write_humanoid_xml(..., physics=True)`` and the expert record
of ``chip_smoke.write_tools_fixture``'s demo. MuJoCo is the same library on
both sides; the control laws run in f32 in both (``rl/mujoco_env.py``),
through torch here and XLA there.

Tolerances:
- ``scale_mean_head``: exact (one f32 product each side).
- ``fk_positions`` / ``fk_reference``: within 1e-9 m (MuJoCo's FK alone).
- ``score``: within 1e-9 on the same positions.
- ``rollout_open_loop`` (30 frames, with and without the residual force):
  the simulated positions within 1e-4 m (f32 control laws: two rollouts
  part by roundoff, as tests/test_torch_physics.py bounds qpos), and the
  scores within 0.01 mm and 1e-3 m of height (the rounding of the printed
  metrics), the upright counts equal.
- ``rollout_closed_loop`` for 10 frames from the same weights and
  observation filter: the simulated positions within 1e-6 m, the scores as
  above.
Each tool's ``main --device cpu`` runs end to end at its smallest knobs and
prints the JAX tool's JSON keys; without ``--device`` it asks for the card
and raises here.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.rl import imitation as jim
from egoego_release_tpu.rl import train_physics_agent as jtpa
from egoego_release_tpu.rl.mujoco_env import MujocoHumanoidEnv as JaxEnv
from egoego_release_tpu_torch.rl import imitation as tim
from egoego_release_tpu_torch.rl import ppo as tppo
from egoego_release_tpu_torch.rl import train_physics_agent as ttpa
from egoego_release_tpu_torch.rl.mujoco_env import MujocoHumanoidEnv as PortEnv
from egoego_release_tpu_torch.tools import physics_tracking_check as tcheck
from egoego_release_tpu_torch.tools import train_physics_controller as tctrl
from egoego_release_tpu_torch.tools._data import tool_rest_offsets
from egoego_release_tpu_torch.utils import convert
from test_torch_trajar import _chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]
HSIZE = (32, 16)
FRAMES = 31


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("physics_tools")
    f = cs.write_tools_fixture(str(root), np.random.RandomState(2), frames=FRAMES, neutral_frames=5, fr_num=4)
    f["xml"] = cs.write_humanoid_xml(str(root / "humanoid.xml"), cs.smpl_rest_to_mujoco(tool_rest_offsets()),
                                     physics=True)
    f["qpos"], f["qvel"] = tcheck.expert_qpos_qvel(f["demo"], str(root), "cpu")
    return f


def scores_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, (what, k, got[k], v)
        else:  # the printed rounding: 0.01 mm, 1e-3 m
            assert abs(got[k] - v) <= (1e-3 if k.endswith("_m") else 0.01) + 1e-9, (what, k, got[k], v)


def spy_score(monkeypatch, mod):
    """Record the (sim, ref) arrays that ``mod.score`` is called with."""
    seen, real = [], mod.score
    monkeypatch.setattr(mod, "score", lambda sim, ref: seen.append((sim, ref)) or real(sim, ref))
    return seen


def test_fk_positions_and_reference_match_jax(fx):
    jcheck, jctrl = jax_tool("physics_tracking_check"), jax_tool("train_physics_controller")
    je, te = JaxEnv(fx["xml"]), PortEnv(fx["xml"], device="cpu")
    for q in fx["qpos"][::7]:
        np.testing.assert_allclose(tcheck.fk_positions(te, q), jcheck.fk_positions(je, q), rtol=0, atol=1e-9)
    ref = tctrl.fk_reference(te, fx["qpos"])
    assert ref.shape == (FRAMES - 1, 24, 3)
    np.testing.assert_allclose(ref, jctrl.fk_reference(je, fx["qpos"]), rtol=0, atol=1e-9)


def test_score_matches_jax():
    rng = np.random.RandomState(0)
    sim = rng.randn(40, 24, 3) * 0.3
    sim[:, 0, 2] = 0.85 + 0.1 * np.sin(np.arange(40) / 3.0)
    ref = sim + rng.randn(40, 24, 3) * 0.01
    want = jax_tool("train_physics_controller").score(sim, ref)
    got = tctrl.score(sim, ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert 0 < got["frames_upright"] < 40 and got["max_consecutive_upright"] <= got["frames_upright"]


@pytest.mark.parametrize("rfc", [True, False])
def test_rollout_open_loop_matches_jax(fx, monkeypatch, rfc):
    jctrl = jax_tool("train_physics_controller")
    js = jim.PhysicsImitation(fx["xml"], reward_id="world_rfc_implicit", residual_force=rfc)
    ts = tim.PhysicsImitation(fx["xml"], reward_id="world_rfc_implicit", residual_force=rfc, device="cpu")
    q, v = fx["qpos"], fx["qvel"]
    ref = tctrl.fk_reference(ts.env, q)
    seen_j, seen_t = spy_score(monkeypatch, jctrl), spy_score(monkeypatch, tctrl)
    want = jctrl.rollout_open_loop(js, q, v, ref)
    got = tctrl.rollout_open_loop(ts, q, v, ref)
    np.testing.assert_allclose(seen_t[0][0], seen_j[0][0], rtol=0, atol=1e-4)
    scores_close(got, want, f"open loop rfc={rfc}")


def test_scale_mean_head_matches_jax(fx):
    jagent = jtpa.PhysicsPPO(jim.PhysicsImitation(fx["xml"]), hsize=HSIZE)
    params = jagent.init_state(jax.random.PRNGKey(0))["policy"]
    want = convert.policy_state_dict_from_jax(jax_tool("train_physics_controller").scale_mean_head(params))
    policy = tppo.make_policy(jagent.obs_dim, jagent.action_dim, HSIZE)
    policy.load_state_dict(convert.policy_state_dict_from_jax(params))
    assert tctrl.scale_mean_head(policy) is policy
    got = policy.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(got["fc.weight"].abs().max()) < 0.02 * float(
        convert.policy_state_dict_from_jax(params)["fc.weight"].abs().max())


def test_rollout_closed_loop_matches_jax(fx, monkeypatch):
    """10 frames of the demo from the same weights (mean head at 1e-2) and
    the same observation filter (updated on the same observations)."""
    jctrl = jax_tool("train_physics_controller")
    q, v = fx["qpos"][:10], fx["qvel"][:10]
    jagent = jtpa.PhysicsPPO(jim.PhysicsImitation(fx["xml"], reward_id="world_rfc_implicit"), hsize=HSIZE)
    tagent = ttpa.PhysicsPPO(tim.PhysicsImitation(fx["xml"], reward_id="world_rfc_implicit", device="cpu"),
                             hsize=HSIZE)
    params = jctrl.scale_mean_head(jagent.init_state(jax.random.PRNGKey(1))["policy"])
    policy = tppo.make_policy(tagent.obs_dim, tagent.action_dim, HSIZE)
    policy.load_state_dict(convert.policy_state_dict_from_jax(params))
    raw = np.random.RandomState(3).randn(16, jagent.obs_dim).astype(np.float32)
    jagent.zfilter = jtpa.ZFilter.update(jagent.zfilter, jnp.asarray(raw))
    tagent.zfilter = ttpa.ZFilter.update(tagent.zfilter, torch.from_numpy(raw))
    ref = tctrl.fk_reference(tagent.sess.env, q)
    seen_j, seen_t = spy_score(monkeypatch, jctrl), spy_score(monkeypatch, tctrl)
    want = jctrl.rollout_closed_loop(jagent, {"policy": params}, q, v, ref)
    got = tctrl.rollout_closed_loop(tagent, {"policy": policy}, q, v, ref)
    assert seen_t[0][0].shape == (9, 24, 3)
    np.testing.assert_allclose(seen_t[0][0], seen_j[0][0], rtol=0, atol=1e-6)
    scores_close(got, want, "closed loop")


def test_physics_tracking_main_on_cpu(fx, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # MuJoCo may write MUJOCO_LOG.TXT into the working directory
    argv = ["--demo", fx["demo"], "--xml", fx["xml"], "--work_dir", str(tmp_path)]
    out = tcheck.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert list(out) == ["metric", "frames", "rfc", "no_rfc"] and out["frames"] == FRAMES
    for k in ("rfc", "no_rfc"):
        assert set(out[k]) == {"root_centered_mpjpe_mm", "first10_root_centered_mpjpe_mm",
                               "first30_root_centered_mpjpe_mm", "global_mpjpe_mm", "final_root_height_m",
                               "sim_seconds"}
        assert all(np.isfinite(x) for x in out[k].values())
    assert (tmp_path / "_phys_expert.p").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcheck.main(argv)


def test_physics_controller_main_on_cpu(fx, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    snap = tmp_path / "best.pkl"
    for k, v in dict(PHYS_ITERS="1", PHYS_HORIZON="4", PHYS_ROLLOUTS="2", PHYS_SAVE=str(snap)).items():
        monkeypatch.setenv(k, v)
    argv = ["--demo", fx["demo"], "--xml", fx["xml"], "--work_dir", str(tmp_path)]
    out = tctrl.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert list(out) == ["metric", "iters", "rollouts_per_iter", "horizon", "on_fail", "train_seconds",
                         "reward_first10", "reward_last10", "open_loop", "closed_loop_final", "closed_loop_best",
                         "bar"]
    assert out["iters"] == 1 and out["closed_loop_final"]["total_frames"] == FRAMES - 1
    assert set(out["bar"]) == {"first30_mpjpe_beats_open_loop", "upright_beats_open_loop"}
    # a warm start from the snapshot, eval only
    monkeypatch.setenv("PHYS_INIT", str(snap))
    monkeypatch.setenv("PHYS_ITERS", "0")
    monkeypatch.delenv("PHYS_SAVE")
    again = tctrl.main(argv + ["--device", "cpu"])
    assert again["iters"] == 0 and again["closed_loop_best"] == again["closed_loop_final"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tctrl.main(argv)
