"""The port's kinematic RL group (rl/rewards.py, rl/env.py, rl/ppo.py,
rl/trpo.py, rl/train_agent.py and the policy / value converters) against
the JAX package on the CPU, at small widths: 4 envs, 12-frame expert
windows of the port's ``preprocess.qpos`` records (smooth synthetic motion),
hidden sizes (32, 16), a horizon of 6. Both iterations replay JAX's key
stream through the port's noise source (``noise.step``), and both packages
start from the same weights (``utils.convert``). Every JAX function a test
calls is jitted, once per module.

Tolerances: the rewards and their terms within 1e-4 of each output's max
(the angular-velocity term divides 2 acos(w) by dt, and acos is steep near
w = 1, so the two compilers' rounding of w shows 30 times larger there);
the env's qpos, the observation and the rewards within 1e-5 of their max,
qvel within 3e-4 (it divides by dt), t and done equal; GAE within 1e-5 of
its max; after one PPO iteration (2 epochs) and one TRPO iteration, both
in float64 (``_iteration_pair`` says why), each parameter tensor within
1e-5 of its max |x|, the metrics within 1e-4 relative; ZFilter's mean within 1e-5 and its std within 1e-4 of numpy's.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation as ScipyRot

from egoego_release_tpu.rl import env as jenv_mod
from egoego_release_tpu.rl import ppo as jppo
from egoego_release_tpu.rl import rewards as jr
from egoego_release_tpu.rl import trpo as jtrpo
from egoego_release_tpu_torch.data.kinpoly import StateARDataset
from egoego_release_tpu_torch.rl import env as tenv_mod
from egoego_release_tpu_torch.rl import ppo as tppo
from egoego_release_tpu_torch.rl import rewards as tr
from egoego_release_tpu_torch.rl import trpo as ttrpo
from egoego_release_tpu_torch.utils import convert
from test_torch_trajar import _chip_smoke

FR, NENV, HSIZE, HORIZON = 12, 4, (32, 16), 6


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * max(top, 1e-30), f"{what}: {err} > {tol} x {top}"


class JaxKeySteps:
    """The action noise of a JAX rollout: per step ``k, ka = split(k)`` and
    a normal draw from ka (``rl/ppo.py:165``)."""

    def __init__(self, key, dtype=jnp.float32):
        self.k, self.dtype = key, dtype

    def step(self, shape):
        self.k, ka = jax.random.split(self.k)
        return torch.from_numpy(np.array(jax.random.normal(ka, shape, self.dtype)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Rest offsets, an expert pickle of the port's qpos CLI, a time-major
    expert batch of NENV windows, and the JAX and port envs."""
    from egoego_release_tpu_torch.preprocess.qpos import convert_motion_pickle

    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("rl")
    rng = np.random.RandomState(0)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    rest[0] = 0.0
    np.save(root / "rest.npy", rest)
    cs.smooth_motion_pickle(str(root / "motion.p"), rng, 2)
    convert_motion_pickle(str(root / "motion.p"), str(root / "expert.p"), rest, device="cpu")
    ds = StateARDataset(str(root / "expert.p"), fr_num=FR, train=True, seed=2)
    items = [ds.sample_seq() for _ in range(NENV)]
    expert = {k: np.stack([it[k] for it in items], axis=1) for k in ("qpos", "head_pose", "head_vels")}
    # the target head a few cm off the FK of the expert's qpos (as a SLAM
    # head track is): at reset the head difference of the observation would
    # otherwise be rounding noise, whose gradient Adam scales to +-lr, and
    # the two packages' noise differs
    expert["head_pose"][..., :3] += np.float32([0.02, -0.01, 0.015])
    return dict(root=root, rest=rest, expert=expert)


def _envs(rest, **kw):
    return jenv_mod.KinematicHumanoidEnv(rest, **kw), tenv_mod.KinematicHumanoidEnv(rest, device="cpu", **kw)


def _experts(expert):
    return ({k: jnp.asarray(v) for k, v in expert.items()}, {k: torch.from_numpy(v) for k, v in expert.items()})


# -- rewards --------------------------------------------------------------


def _quats(rng, n):
    return ScipyRot.random(n, random_state=rng).as_quat()[:, [3, 0, 1, 2]]


def _noisy(rng, q, scale):
    q = q + rng.randn(*q.shape) * scale
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _context(seed, b=5, j=22):
    rng = np.random.RandomState(seed)
    cur_b = _quats(rng, b * j).reshape(b, j, 4)
    fields = {
        "cur_hpose": np.concatenate([rng.randn(b, 3) * 0.1, _quats(rng, b)], -1),
        "cur_bquat": cur_b, "prev_bquat": _noisy(rng, cur_b, 0.05), "tgt_bquat": _noisy(rng, cur_b, 0.05),
        "cur_wbpos": rng.randn(b, j, 3) * 0.3,
        "ar_bquat": _noisy(rng, cur_b, 0.06), "gt_bquat": _noisy(rng, cur_b, 0.08),
        "tgt_qpos": np.concatenate([rng.randn(b, 3) * 0.1, _quats(rng, b), rng.randn(b, 69)], -1),
    }
    fields["tgt_hpose"] = np.concatenate([fields["cur_hpose"][:, :3] + rng.randn(b, 3) * 0.05,
                                          _noisy(rng, fields["cur_hpose"][:, 3:], 0.02)], -1)
    fields["tgt_wbpos"] = fields["cur_wbpos"] + rng.randn(b, j, 3) * 0.05
    fields["ar_prev_bquat"] = _noisy(rng, fields["ar_bquat"], 0.05)
    fields["gt_prev_bquat"] = _noisy(rng, fields["gt_bquat"], 0.05)
    ar = fields["tgt_qpos"] + np.concatenate([rng.randn(b, 3) * 0.05, rng.randn(b, 4) * 0.02, rng.randn(b, 69)], -1)
    ar[:, 3:7] /= np.linalg.norm(ar[:, 3:7], axis=-1, keepdims=True)
    fields["ar_qpos"] = ar
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    return (jr.RewardContext(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tr.RewardContext(**{k: torch.from_numpy(v) for k, v in fields.items()}))


@pytest.mark.parametrize("name", sorted(jr.REWARD_FUNCS))
def test_reward_funcs_match_jax(name):
    assert sorted(tr.REWARD_FUNCS) == sorted(jr.REWARD_FUNCS) and tr.DEFAULT_WEIGHTS == jr.DEFAULT_WEIGHTS
    ws = {"k_hp": 0.7, "k_hq": 1.3, "k_p": 0.9, "k_jp": 0.2, "k_rp": 0.15, "k_rq": 0.2, "k_act_p": 0.3,
          "k_act_v": 0.05, "w_hp": 0.8, "w_hq": 1.2, "w_p": 0.9, "w_jp": 1.1, "w_act_p": 0.7, "w_act_v": 0.6}
    for seed, weights in ((0, None), (1, ws)):
        jctx, tctx = _context(seed)
        want = jax.jit(lambda c: jr.REWARD_FUNCS[name](c, weights))(jctx)
        got = tr.REWARD_FUNCS[name](tctx, weights)
        _close(got[0], want[0], 1e-4, f"{name} reward")
        _close(got[1], want[1], 1e-4, f"{name} terms")


def test_reward_helpers_match_jax():
    rng = np.random.RandomState(4)
    q = _quats(rng, 64).astype(np.float32)
    q[:4] = [[1, 0, 0, 0], [-1, 0, 0, 0], [0.9999999, 0, 0, 0.0003], [0, 1, 0, 0]]
    _close(tr.rotation_vec_from_quat(torch.from_numpy(q)), jax.jit(jr.rotation_vec_from_quat)(jnp.asarray(q)), 1e-5,
           "rotation_vec_from_quat")
    a, b = q[:32].reshape(2, 16, 4), q[32:].reshape(2, 16, 4)
    _close(tr.multi_quat_norm_v2(tr.multi_quat_diff(torch.from_numpy(a), torch.from_numpy(b))),
           jax.jit(lambda x, y: jr.multi_quat_norm_v2(jr.multi_quat_diff(x, y)))(jnp.asarray(a), jnp.asarray(b)),
           1e-5, "multi_quat_norm_v2")


# -- env ------------------------------------------------------------------


@pytest.mark.parametrize("reward_id", [None, "dynamic_supervision_v3"])
def test_env_reset_obs_step_match_jax(setup, reward_id):
    """Three steps of random actions (the third with a root that flies off,
    so that fail_safe ends some envs), the expert prepared by both."""
    jenv, tenv = _envs(setup["rest"], reward_id=reward_id)
    je, te = _experts(setup["expert"])
    je, te = jenv.prepare_expert(je), tenv.prepare_expert(te)
    for k in ("bquat", "wbpos"):
        _close(te[k], je[k], 1e-5, k)
    js, ts = jenv.reset(je["qpos"][0]), tenv.reset(te["qpos"][0])
    jobs, jstep = jax.jit(jenv.obs), jax.jit(jenv.step)
    rng = np.random.RandomState(5)
    base = setup["expert"]["qpos"]
    for i in range(3):
        _close(tenv.obs(ts, te), jobs(js, je), 1e-5, f"obs {i}")
        act = np.concatenate([base[i + 1, :, 2:3], base[i + 1, :, 3:7], base[i + 1, :, 7:],
                              rng.randn(NENV, 6) * 0.3], -1).astype(np.float32)
        if i == 2:
            act[:2, 74:77] = 1000.0
        js, jrew, jdone = jstep(js, jnp.asarray(act), je)
        ts, trew, tdone = tenv.step(ts, torch.from_numpy(act), te)
        _close(ts.qpos, js.qpos, 1e-5, f"qpos {i}")
        _close(ts.qvel, js.qvel, 3e-4, f"qvel {i}")
        _close(trew, jrew, 1e-5, f"reward {i}")
        np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert tdone.numpy()[:2].all() and not tdone.numpy()[2:].all()


def test_gae_matches_jax():
    rng = np.random.RandomState(2)
    t, b = 7, 3
    r, v = rng.randn(t, b).astype(np.float32), rng.randn(t, b).astype(np.float32)
    last, dones = rng.randn(b).astype(np.float32), rng.rand(t, b) < 0.2
    want = jax.jit(jppo.gae_advantages, static_argnums=(4, 5))(*map(jnp.asarray, (r, v, last, dones)), 0.95, 0.9)
    got = tppo.gae_advantages(*map(torch.from_numpy, (r, v, last, dones)), 0.95, 0.9)
    for g, w, what in zip(got, want, ("advantages", "returns")):
        _close(g, w, 1e-5, what)


# -- PPO and TRPO ---------------------------------------------------------


def _load(module, sd):
    module.load_state_dict(sd)
    return module.double()


def _check_params(policy, value, jstate, tol=1e-5):
    for what, module, want in (("policy", policy, convert.policy_state_dict_from_jax(jstate["policy"])),
                               ("value", value, convert.value_state_dict_from_jax(jstate["value"]))):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], tol, f"{what} {k}")


def _iteration_pair(setup, jagent_cls, jcfg, tagent_cls, tcfg, init_key, key, rollout_key):
    """One iteration of each package in float64 (JAX under enable_x64, its
    Dense kernels f32 as flax keeps them; the port's modules in float64
    from the same values): in f32, Adam's first steps move every entry by
    about lr whatever its gradient's size, so an entry whose gradient lies
    within f32 roundoff of zero would take the opposite step on the other
    side (1e-3 of the max here). Returns (JAX's new state, its metrics, the
    port's state, its metrics, JAX's initial state)."""
    with jax.enable_x64(True):
        jenv, tenv = _envs(setup["rest"], reward_id="dynamic_supervision_v3")
        tenv.rest_offsets = tenv.rest_offsets.double()
        expert = {k: v.astype(np.float64) for k, v in setup["expert"].items()}
        je, te = _experts(expert)
        jagent, tagent = jagent_cls(jenv, jcfg, hsize=HSIZE), tagent_cls(tenv, tcfg, hsize=HSIZE)
        jstate = jagent.init_state(init_key)
        policy = _load(tppo.GaussianPolicy(tenv.obs_dim, tenv.action_dim, HSIZE),
                       convert.policy_state_dict_from_jax(jstate["policy"]))
        value = _load(tppo.ValueNet(tenv.obs_dim, HSIZE), convert.value_state_dict_from_jax(jstate["value"]))
        jnew, _, jm = jagent.iterate(jstate, key, jenv.reset(je["qpos"][0]), je)
        noise = JaxKeySteps(rollout_key, jnp.float64)
        state, _, tm = tagent.iterate(tagent.state_for(policy, value), noise, tenv.reset(te["qpos"][0]), te)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1e-6), (k, tm[k], jm[k])
    _check_params(state["policy"], state["value"], jnew)
    return jnew, jm, state, tm, jstate


def test_ppo_iteration_matches_jax(setup):
    cfg = dict(horizon=HORIZON, epochs=2)
    key = jax.random.PRNGKey(3)
    jnew, _, _, _, jstate = _iteration_pair(setup, jppo.PPOAgent, jppo.PPOConfig(**cfg), tppo.PPOAgent,
                                            tppo.PPOConfig(**cfg), jax.random.PRNGKey(0), key,
                                            jax.random.split(key)[0])
    # the weights moved: the comparison holds an update, not the start
    moved = convert.policy_state_dict_from_jax(jnew["policy"])["fc.weight"]
    assert float((moved - convert.policy_state_dict_from_jax(jstate["policy"])["fc.weight"]).abs().max()) > 1e-5


def test_trpo_iteration_matches_jax(setup):
    cfg = dict(horizon=HORIZON, cg_iters=4, value_epochs=2)
    key = jax.random.PRNGKey(4)
    jnew, jm, _, tm, jstate = _iteration_pair(setup, jtrpo.TRPOAgent, jtrpo.TRPOConfig(**cfg), ttrpo.TRPOAgent,
                                              ttrpo.TRPOConfig(**cfg), jax.random.PRNGKey(1), key, key)
    assert float(jm["accepted"]) == float(tm["accepted"]) == 1.0  # a step was taken
    assert float(tm["kl"]) <= 1e-2
    moved = convert.policy_state_dict_from_jax(jnew["policy"])["fc.weight"]
    assert float((moved - convert.policy_state_dict_from_jax(jstate["policy"])["fc.weight"]).abs().max()) > 1e-5


def test_conjugate_gradient_matches_jax():
    """On an SPD system in f32: within 1e-5 of the solution's max, and a
    residual under 1e-4 of |b| (both packages add 1e-8 to each
    denominator, which slows the last digits)."""
    rng = np.random.RandomState(6)
    a = rng.randn(8, 8)
    m, b = (a @ a.T + 8 * np.eye(8)).astype(np.float32), rng.randn(8).astype(np.float32)
    want = jax.jit(lambda b: jtrpo.conjugate_gradient(lambda v: jnp.asarray(m) @ v, b, 10))(jnp.asarray(b))
    got = ttrpo.conjugate_gradient(lambda v: torch.from_numpy(m) @ v, torch.from_numpy(b), 10)
    _close(got, want, 1e-5, "conjugate_gradient")
    assert float((torch.from_numpy(m) @ got - torch.from_numpy(b)).abs().max()) <= 1e-4 * float(np.abs(b).max())


def test_zfilter_matches_jax_and_batch_stats():
    rng = np.random.RandomState(3)
    chunks = [(rng.randn(20, 5) * 3 + 1).astype(np.float32) for _ in range(4)]
    ts, js = ttrpo.ZFilter.init(5), jtrpo.ZFilter.init(5)
    for c in chunks:
        ts, js = ttrpo.ZFilter.update(ts, torch.from_numpy(c)), jtrpo.ZFilter.update(js, jnp.asarray(c))
    for k in js:
        _close(ts[k], js[k], 1e-5, k)
    allx = np.concatenate(chunks)
    _close(ts["mean"], allx.mean(0), 1e-5, "mean")
    n = allx.shape[0]  # m2 starts at 1, as khrylib's and JAX's
    _close(torch.sqrt(ts["m2"] / ts["count"]), np.sqrt((allx.var(0) * n + 1.0) / n), 1e-4, "std")
    _close(ttrpo.ZFilter.apply(ts, torch.from_numpy(allx)), jtrpo.ZFilter.apply(js, jnp.asarray(allx)), 1e-5,
           "apply")


# -- policies through the converter --------------------------------------


@pytest.mark.parametrize("actor_type", ["gauss", "mcp"])
def test_policy_through_the_converter(actor_type):
    """JAX's make_policy with its init -> the port's by the converter: the
    same (mean, log_std); and back by the inverse, the same tree."""
    obs = np.random.RandomState(7).randn(6, 30).astype(np.float32)
    jpol = jppo.make_policy(8, HSIZE, actor_type, num_primitive=3)
    params = jax.jit(jpol.init)(jax.random.PRNGKey(2), jnp.asarray(obs))
    tpol = tppo.make_policy(30, 8, HSIZE, actor_type, num_primitive=3)
    tpol.load_state_dict(convert.policy_state_dict_from_jax(params))
    want = jax.jit(jpol.apply)(params, jnp.asarray(obs))
    got = tpol(torch.from_numpy(obs))
    _close(got[0].detach(), want[0], 1e-5, "mean")
    _close(got[1].detach(), want[1], 0, "log_std")
    back = convert.policy_params_from_state_dict(tpol.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jval = jppo.ValueNet(HSIZE)
    vparams = jax.jit(jval.init)(jax.random.PRNGKey(3), jnp.asarray(obs))
    tval = tppo.ValueNet(30, HSIZE)
    tval.load_state_dict(convert.value_state_dict_from_jax(vparams))
    _close(tval(torch.from_numpy(obs)).detach(), jax.jit(jval.apply)(vparams, jnp.asarray(obs)), 1e-5, "value")
    for a, b in zip(jax.tree.leaves(convert.value_params_from_state_dict(tval.state_dict())),
                    jax.tree.leaves(vparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    if actor_type == "mcp":  # the primitives' output layers start at 0.1 of flax's scale
        fresh = tppo.init_rl_module_(tppo.make_policy(30, 8, HSIZE, "mcp", 3), torch.Generator().manual_seed(0))
        scale = float(fresh.primitive_outs[0].weight.abs().max())
        assert 0 < scale <= 0.1 * np.sqrt(3.0 / HSIZE[-1])


# -- the CLI --------------------------------------------------------------


def test_train_agent_cli_two_iterations(setup, tmp_path):
    """train_agent for 2 iterations on the CPU: the expert windows JAX's
    make_expert_batch draws for the seed, finite metrics, iter-1.pt and
    iter-2.pt reloaded bit for bit."""
    from egoego_release_tpu.data.kinpoly import StateARDataset as JStateAR
    from egoego_release_tpu.rl import train_agent as jta
    from egoego_release_tpu_torch.rl import train_agent as tta

    expert = str(setup["root"] / "expert.p")
    cfg = tmp_path / "statear.yml"
    yaml.safe_dump({"fr_num": FR, "policy_specs": {"policy_hsize": list(HSIZE), "num_optim_epoch": 2,
                                                   "reward_id": "dynamic_supervision_v3",
                                                   "save_model_interval": 1}}, open(cfg, "w"))
    for seed in (0, 1):
        got = tta.make_expert_batch(StateARDataset(expert, fr_num=FR, seed=seed), 3, np.random.RandomState(seed))
        want = jta.make_expert_batch(JStateAR(expert, fr_num=FR, seed=seed), 3, np.random.RandomState(seed))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    res = tta.main(["--cfg", str(cfg), "--expert_path", expert, "--rest_offsets", str(setup["root"] / "rest.npy"),
                    "--iters", "2", "--num_envs", "2", "--save_dir", str(tmp_path / "agent"), "--device", "cpu"])
    assert len(res["history"]) == 2 and all(np.isfinite(v) for m in res["history"] for v in m.values())
    assert sorted(p.name for p in pathlib.Path(tmp_path / "agent").iterdir()) == ["iter-1.pt", "iter-2.pt"]
    policy, value = tta.load_agent(str(tmp_path / "agent" / "iter-2.pt"))
    for module, live in ((policy, res["state"]["policy"]), (value, res["state"]["value"])):
        for k, v in live.state_dict().items():
            assert torch.equal(module.state_dict()[k], v), k


def test_train_agent_needs_cuda_unless_cpu(setup, tmp_path, monkeypatch):
    """Without CUDA the CLI raises on its default device (the run on
    --device cpu is test_train_agent_cli_two_iterations)."""
    from egoego_release_tpu_torch.rl import train_agent as tta

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "statear.yml"
    yaml.safe_dump({"fr_num": FR}, open(cfg, "w"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tta.main(["--cfg", str(cfg), "--expert_path", str(setup["root"] / "expert.p"), "--rest_offsets",
                  str(setup["root"] / "rest.npy"), "--iters", "1", "--save_dir", str(tmp_path / "agent")])
