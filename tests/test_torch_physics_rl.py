"""The port's physics RL (rl/imitation.py, rl/ar_session.py,
rl/train_physics_agent.py) against the JAX package on the CPU, at small
widths: hidden sizes (32, 16), horizons of 6, 10-frame expert windows.

The MJCF is ``chip_smoke.write_humanoid_xml(..., physics=True)`` (nq 76,
nv 75, nu 69, 24 bodies). MuJoCo steps on the host in both packages; the
control laws run in f32 in both (``rl/mujoco_env.py``), through torch here
and XLA there, so two rollouts from one state part by f32 rounding: qpos by
~2e-6 after three control steps. The PPO fixtures keep the body in the air
(no contact) so that the two rollouts stay that close.

Tolerances:
- ``PhysicsImitation.step``: the reward within 1e-5 of max(1, |reward|),
  ``done`` equal, qpos within 1e-4 (tests/test_torch_physics.py's bound), over three control
  steps under a kinematic, a UHC and a sim reward.
- ``ARPhysicsSession``: qpos within 1e-4 after four control steps with a
  linear cc policy; the AR observation within 1e-4 of its max; after
  ``ar_fail_safe`` the state equal.
- ``PhysicsPPO.iterate``, ``iterate_parallel`` (2 tasks, fail-safe resets)
  and ``ARAgentPPO.iterate``, one iteration each, from the same weights
  (``utils.convert``) and JAX's key stream replayed, in float64 (JAX under
  ``jax.enable_x64``): (1) the port's rollout against JAX's: the
  observations, actions and values within 1e-4 of their max, the rewards
  within 1e-5 of max(1, |r|), ``done`` equal; (2) the rest of the iteration
  (the observation filter, GAE, the epochs of Adam) on the port's own
  rollout against JAX's on the same rollout: each parameter tensor within
  1e-4 of its max |x|, the filter within 1e-6, the metrics within 1e-5
  relative. The iteration is split so because Adam moves an entry whose
  gradient is rounding noise by +-lr, so that the rollouts' f32 parting
  would show in a parameter as up to 1e-3 of its max. The bound is 1e-4,
  not 1e-5: JAX's batch keeps the rewards and values in f32 and its GAE
  scan carries their dtype, so its advantages are f32 (the port's too),
  and the two normalize them with sums in another order; where an entry's
  gradients nearly cancel across the epochs, Adam's later steps magnify
  that 1e-7 (measured: 2.9e-5 of a bias that moved three steps of lr).
- The observation widths: equal to the length ``uhc_observation`` returns
  (and to JAX's formulas).
- ``main --device cpu --iters 1`` runs; without ``--device`` it asks for the
  card and raises here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.rl import ar_session as jas
from egoego_release_tpu.rl import imitation as jim
from egoego_release_tpu.rl import train_physics_agent as jtpa
from egoego_release_tpu_torch.rl import ar_session as tas
from egoego_release_tpu_torch.rl import imitation as tim
from egoego_release_tpu_torch.rl import ppo as tppo
from egoego_release_tpu_torch.rl import train_physics_agent as ttpa
from egoego_release_tpu_torch.utils import convert
from test_torch_trajar import _chip_smoke

HSIZE, HORIZON, T = (32, 16), 6, 10


class JaxKeys:
    """JAX's key stream as the port's noise source: per step ``key, ka =
    split(key)`` and a normal draw from ka (``train_physics_agent.py:130``),
    per parallel rollout one of ``split(key, n + 1)[1:]`` (``:271``)."""

    def __init__(self, key, dtype=jnp.float64):
        self.k, self.dtype = key, dtype

    def step(self, shape):
        # enable_x64 is a thread's own setting: the parallel rollouts draw on threads
        with jax.enable_x64(self.dtype == jnp.float64):
            self.k, ka = jax.random.split(self.k)
            return torch.from_numpy(np.array(jax.random.normal(ka, shape, self.dtype)))

    def split(self, k):
        keys = jax.random.split(self.k, k + 1)
        self.k = keys[0]
        return [JaxKeys(keys[i + 1], self.dtype) for i in range(k)]


def _close(got, want, tol, what, floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * max(top, floor), f"{what}: {err} > {tol} x {top}"


def targets_in_air(rng, t=T, z=2.0):
    """A smooth target motion two metres up (no contact for the first
    control steps), joints moving a degree a frame."""
    q = np.zeros((t, 76))
    q[:, :3] = [0.0, 0.0, z] + np.cumsum(rng.uniform(-0.005, 0.005, (t, 3)), 0)
    q[:, 3] = 1.0
    q[:, 7:] = np.cumsum(rng.uniform(-0.02, 0.02, (t, 69)), 0)
    return q


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("physics_rl")
    rng = np.random.RandomState(0)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    rest[0] = 0.0
    xml = cs.write_humanoid_xml(str(root / "humanoid.xml"), cs.smpl_rest_to_mujoco(rest), physics=True)
    return dict(cs=cs, root=root, rest=rest, xml=xml, q=targets_in_air(rng), rng=rng)


# -- PhysicsImitation -------------------------------------------------------


@pytest.mark.parametrize("reward_id", ["dynamic_supervision_v4", "dynamic_supervision_v3", "world_rfc_implicit",
                                       "deep_mimic"])
def test_physics_imitation_step_matches_jax(model, reward_id):
    q = model["q"]
    js = jim.PhysicsImitation(model["xml"], reward_id=reward_id)
    ts = tim.PhysicsImitation(model["xml"], reward_id=reward_id, device="cpu")
    for s in (js, ts):
        s.reset(q[0])
        if s.uhc_reward is not None or s.sim_reward is not None:
            s.set_expert(q)
            s.reset(q[0])
    rng = np.random.RandomState(3)
    ar = reward_id == "dynamic_supervision_v3"
    for i in range(1, 4):
        a = rng.randn(75) * 0.1
        kw = dict(expert_ind=i, ar_qpos=q[i] + 0.01, prev_target_qpos=q[i - 1] if i > 1 else None) if ar else \
            dict(expert_ind=i)
        rj, dj, ij = js.step(a, q[i], **kw)
        rt, dt, it = ts.step(a, q[i], **kw)
        assert abs(rt - rj) <= 1e-5 * max(1.0, abs(rj)), (reward_id, i, rt, rj)
        assert dt == dj
        _close(ts.env.get_qpos(), js.env.get_qpos(), 1e-4, f"qpos {i}", floor=1.0)
        _close(it["components"], ij["components"], 1e-5, f"components {i}", floor=1.0)
        assert abs(it["body_diff"] - ij["body_diff"]) <= 1e-4


def test_clone_keeps_the_configuration(model):
    ts = tim.PhysicsImitation(model["xml"], reward_id="deep_mimic", device="cpu", residual_force=False)
    c = ts.clone()
    assert c is not ts and c.env is not ts.env and c.device == ts.device
    assert c.sim_reward is ts.sim_reward and c.env.action_dim == ts.env.action_dim == 69


# -- ARPhysicsSession -------------------------------------------------------


def _ar_context(rng, q):
    t = len(q)
    head = np.concatenate([q[:, :3] + [0.0, 0.0, 0.5], np.tile([1.0, 0.0, 0.0, 0.0], (t, 1))], -1)
    return {"qpos": q, "head_pose": head, "head_vels": rng.randn(t, 6) * 0.1,
            "obj_head_relative_poses": np.tile([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], (t, 1))}


def _hold_action(qpos):
    """The AR action that re-targets the current pose with no root velocity
    (step_ar's layout: [z, quat, eulers (69), root qvel (6)])."""
    return np.concatenate([qpos[2:], np.zeros(6)])


def _sessions(model, **kw):
    w = 0.01 * np.random.RandomState(0).randn(715, 75)   # cc_obs v1 -> a linear policy
    pol = lambda obs: obs @ w
    return (jas.ARPhysicsSession(model["xml"], pol, episode_len=6, residual_force=False, **kw),
            tas.ARPhysicsSession(model["xml"], pol, episode_len=6, residual_force=False, device="cpu", **kw))


def test_ar_session_matches_jax(model):
    q = model["q"]
    js, ts = _sessions(model)
    ctx = _ar_context(np.random.RandomState(1), q)
    for s in (js, ts):
        s.set_context(ctx)
        s.reset(q[0])
    _close(ts.ar_obs(), js.ar_obs(), 1e-12, "ar_obs at reset")
    for i in range(4):
        act = _hold_action(q[min(i + 1, T - 1)])
        oj, rj, dj, ij = js.step(act)
        ot, rt, dt, it = ts.step(act)
        _close(ts.env.get_qpos(), js.env.get_qpos(), 1e-4, f"qpos {i}", floor=1.0)
        _close(ot, oj, 1e-4, f"ar_obs {i}")
        assert abs(rt - rj) <= 1e-5 * max(1.0, abs(rj)) and dt == dj and it["fail"] == ij["fail"]
        _close(it["cc_obs"], ij["cc_obs"], 1e-4, f"cc_obs {i}")
    # policy_v 2: a direct target
    oj, rj, *_ = js.step(target_qpos=q[5])
    ot, rt, *_ = ts.step(target_qpos=q[5])
    assert abs(rt - rj) <= 1e-5 * max(1.0, abs(rj))
    js.ar_fail_safe()
    ts.ar_fail_safe()
    np.testing.assert_array_equal(ts.env.get_qpos(), js.env.get_qpos())
    np.testing.assert_array_equal(ts.env.get_qvel(), js.env.get_qvel())
    _close(ts._target_dict(q[3])["body_com"], js._target_dict(q[3])["body_com"], 1e-6, "target body_com")
    _close(ts.step_ar(_hold_action(q[4])), js.step_ar(_hold_action(q[4])), 1e-6, "step_ar", floor=1.0)


# -- PPO --------------------------------------------------------------------


def _calm(jstate):
    """The Gaussian actor's output layer at a tenth of flax's scale (the
    MCP primitives' already are, ``rl/ppo.py``): from flax's init the
    mean actions of clipped observations reach a radian and more, and the
    stable-PD torques then make the light capsule body unstable."""
    p = jstate["policy"]["params"]
    if "fc" in p:
        p["fc"]["kernel"] = p["fc"]["kernel"] * 0.1
    return jstate


def _port_state(tagent, jstate, actor_type):
    policy = tppo.make_policy(tagent.obs_dim, tagent.action_dim, HSIZE, actor_type)
    policy.load_state_dict(convert.policy_state_dict_from_jax(jstate["policy"]))
    value = tppo.ValueNet(tagent.obs_dim, HSIZE)
    value.load_state_dict(convert.value_state_dict_from_jax(jstate["value"]))
    tagent.zfilter = {k: v.double() for k, v in tagent.zfilter.items()}
    return tagent.state_for(policy.double(), value.double())


def _spy(agent):
    """Record what the agent's ``collect`` returns, keyed by the id of its
    third argument (a rollout's start qpos or AR context)."""
    seen, collect = {}, agent.collect

    def spy(state, noise, first, *a, **kw):
        seen[id(first)] = collect(state, noise, first, *a, **kw)
        return seen[id(first)]

    agent.collect = spy
    return seen


def _check_rollout(got, want, what):
    assert len(got["rewards"]) == len(want["rewards"]), what
    np.testing.assert_array_equal(got["dones"], want["dones"], err_msg=what)
    for k in ("raw_obs", "obs", "actions", "values"):
        _close(got[k], want[k], 1e-4, f"{what} {k}")
    _close(got["rewards"], want["rewards"], 1e-5, f"{what} rewards", floor=1.0)
    _close(got["logps"], want["logps"], 1e-5, f"{what} logps", floor=1.0)


def _check_iteration(tagent, tstate, tm, jagent, jstate, jm):
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1e-6), (k, tm[k], jm[k])
    for what, module, want in (("policy", tstate["policy"], convert.policy_state_dict_from_jax(jstate["policy"])),
                               ("value", tstate["value"], convert.value_state_dict_from_jax(jstate["value"]))):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], 1e-4, f"{what} {k}")
    for k in ("count", "mean", "m2"):
        _close(tagent.zfilter[k], jagent.zfilter[k], 1e-6, f"zfilter {k}", floor=1.0)


@pytest.mark.parametrize("reward_id,actor_type,obs_v", [("dynamic_supervision_v4", "gauss", None),
                                                        ("world_rfc_implicit", "mcp", 2),
                                                        ("deep_mimic", "gauss", 1)])
def test_physics_ppo_iterate_matches_jax(model, reward_id, actor_type, obs_v):
    q = model["q"]
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jagent = jtpa.PhysicsPPO(jim.PhysicsImitation(model["xml"], reward_id=reward_id), hsize=HSIZE,
                                 actor_type=actor_type, obs_v=obs_v, epochs=3)
        tagent = ttpa.PhysicsPPO(tim.PhysicsImitation(model["xml"], reward_id=reward_id, device="cpu"),
                                 hsize=HSIZE, actor_type=actor_type, obs_v=obs_v, epochs=3)
        assert tagent.obs_dim == jagent.obs_dim
        jstate = _calm(jagent.init_state(jax.random.PRNGKey(0)))
        tstate = _port_state(tagent, jstate, actor_type)
        _, jbatch = jagent.collect(jstate, key, q[0], q, HORIZON)
        seen = _spy(tagent)
        tstate, tm = tagent.iterate(tstate, JaxKeys(key), q[0], q, HORIZON)
        tbatch = seen[id(q[0])] if id(q[0]) in seen else next(iter(seen.values()))
        _check_rollout(tbatch, jbatch, reward_id)
        # JAX's iteration on the port's rollout
        jagent.collect = lambda *a, **kw: (key, tbatch)
        jnew, _, jm = jagent.iterate(jstate, key, q[0], q, HORIZON)
    _check_iteration(tagent, tstate, tm, jagent, jnew, jm)
    first = convert.policy_state_dict_from_jax(jstate["policy"])
    assert any(float((v - first[k]).abs().max()) > 0 for k, v in tstate["policy"].state_dict().items())


def test_physics_ppo_iterate_parallel_matches_jax(model):
    """Two rollouts on two threads, one of them pushed past the
    termination threshold, so that a fail-safe reset runs."""
    q = model["q"]
    q2 = q.copy()
    q2[:, 7:] *= -1.0
    qvels = np.random.RandomState(4).randn(T, 75) * 0.1
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        kw = dict(reward_id="dynamic_supervision_v4", term_body_diff=0.05)
        jagent = jtpa.PhysicsPPO(jim.PhysicsImitation(model["xml"], **kw), hsize=HSIZE, epochs=2)
        tagent = ttpa.PhysicsPPO(tim.PhysicsImitation(model["xml"], device="cpu", **kw), hsize=HSIZE, epochs=2)
        jstate = _calm(jagent.init_state(jax.random.PRNGKey(1)))
        tstate = _port_state(tagent, jstate, "gauss")
        tasks = [(q[0], q), (q2[0], q2, None, qvels)]
        jkeys = jax.random.split(key, 3)
        jbatches = [jagent.collect(jstate, jkeys[i + 1], t[0], t[1], HORIZON, sess=jagent.sess.clone(),
                                   qvel0=t[2] if len(t) > 2 else None, on_fail="failsafe",
                                   fail_qvels=t[3] if len(t) > 3 else None)[1] for i, t in enumerate(tasks)]
        seen = _spy(tagent)
        tstate, tm = tagent.iterate_parallel(tstate, JaxKeys(key), tasks, HORIZON, num_threads=2, on_fail="failsafe")
        tbatches = [seen[id(t[0])] for t in tasks]
        for i, (tb, jb) in enumerate(zip(tbatches, jbatches)):
            _check_rollout(tb, jb, f"rollout {i}")
        assert tbatches[1]["dones"].any() and len(tbatches[1]["rewards"]) == HORIZON
        by_start = {id(t[0]): b for t, b in zip(tasks, tbatches)}
        jagent.collect = lambda state, k, qpos0, *a, **kw: (k, by_start[id(qpos0)])
        jnew, _, jm = jagent.iterate_parallel(jstate, key, tasks, HORIZON, num_threads=2, on_fail="failsafe")
    _check_iteration(tagent, tstate, tm, jagent, jnew, jm)


def test_ar_agent_ppo_iterate_matches_jax(model):
    q = model["q"]
    ctx = _ar_context(np.random.RandomState(2), q)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        js, ts = _sessions(model)
        js.set_context(ctx)
        js.reset(q[0])
        obs_dim = len(js.ar_obs())
        jagent = jtpa.ARAgentPPO(js, obs_dim, hsize=HSIZE, epochs=2)
        tagent = ttpa.ARAgentPPO(ts, obs_dim, hsize=HSIZE, epochs=2)
        assert tagent.action_dim == jagent.action_dim == 80
        jstate = jagent.init_state(jax.random.PRNGKey(2))
        tstate = _port_state(tagent, jstate, "gauss")
        _, jbatch = jagent.collect(jstate, key, ctx, 4)
        seen = _spy(tagent)
        tstate, tm = tagent.iterate(tstate, JaxKeys(key), ctx, 4)
        tbatch = seen[id(ctx)]
        _check_rollout(tbatch, jbatch, "ar rollout")
        jagent.collect = lambda *a, **kw: (key, tbatch)
        jnew, _, jm = jagent.iterate(jstate, key, ctx, 4)
    _check_iteration(tagent, tstate, tm, jagent, jnew, jm)


@pytest.mark.parametrize("obs_v,specs", [(None, None), (0, None), (1, None), (2, None),
                                         (0, {"obs_vel": "full", "obs_heading": True, "obs_phase": True}),
                                         (2, {"obs_vel": "full"})])
def test_obs_dim_is_the_observation_length(model, obs_v, specs):
    q = model["q"]
    agent = ttpa.PhysicsPPO(tim.PhysicsImitation(model["xml"], device="cpu"), obs_v=obs_v, obs_specs=specs)
    jagent = jtpa.PhysicsPPO(jim.PhysicsImitation(model["xml"]), obs_v=obs_v, obs_specs=specs)
    agent.sess.reset(q[0])
    if obs_v is not None:
        agent.sess.set_expert(q)
    assert agent.obs(q[1], cur_t=1).shape == (agent.obs_dim,)
    assert agent.obs_dim == jagent.obs_dim


def test_main_runs_on_cpu(model, tmp_path, monkeypatch):
    from egoego_release_tpu_torch.preprocess.qpos import convert_motion_pickle

    # from a random policy the standing body may go unstable, and MuJoCo
    # then writes MUJOCO_LOG.TXT into the working directory
    monkeypatch.chdir(tmp_path)

    cs = model["cs"]
    cs.smooth_motion_pickle(str(tmp_path / "motion.p"), np.random.RandomState(0), 1)
    convert_motion_pickle(str(tmp_path / "motion.p"), str(tmp_path / "expert.p"), model["rest"], device="cpu")
    argv = ["--xml", model["xml"], "--expert_path", str(tmp_path / "expert.p"), "--horizon", "8", "--iters", "1"]
    out = ttpa.main(argv + ["--device", "cpu"])
    (m,) = out["history"]
    assert 1 <= m["episode_len"] <= 8 and all(np.isfinite(v) for v in m.values())
    assert next(out["state"]["policy"].parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttpa.main(argv)


def test_console_scripts_name_every_port_cli():
    """pyproject.toml's egoego-torch-* scripts: one for each CLI of the JAX
    package's (its torch-checkpoint ingestion aside: the port reads .pt as
    is), each resolving to a main of the port."""
    import importlib
    import pathlib
    import tomllib

    repo = pathlib.Path(__file__).resolve().parents[1]
    scripts = tomllib.loads((repo / "pyproject.toml").read_text())["project"]["scripts"]
    port = {v for k, v in scripts.items() if k.startswith("egoego-torch-")}
    jax_clis = {v.replace("egoego_release_tpu.", "egoego_release_tpu_torch.", 1) for k, v in scripts.items()
                if not k.startswith("egoego-torch-")}
    assert jax_clis - port == {"egoego_release_tpu_torch.utils.torch_ckpt:main"}
    assert "egoego_release_tpu_torch.rl.train_physics_agent:main" in port
    for target in port:
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn)), target
