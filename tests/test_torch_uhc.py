"""The port's host-numpy physics-RL modules (rl/uhc_rewards.py,
rl/sim_rewards.py, rl/uhc_obs.py, rl/ar_obs.py) against the JAX package on
the CPU. Both are the same numpy code, so on the same MuJoCo state every
output must be equal, bit for bit: the expert attributes that
``expert_physics_attrs`` replays, the simulator-state extractors, every
entry of ``UHC_REWARD_FUNCS`` and ``SIM_REWARD_FUNCS``, the UHC
observations of obs_v 0/1/2 and the relive AR and cc observations.

The MJCF is ``chip_smoke.write_humanoid_xml(..., physics=True)`` (kinpoly's
24 bodies, nq 76, nv 75, nu 69); the reference's XML is not in this
checkout. MuJoCo runs on the host in both packages; each package's env is
put in the same state by ``reset`` (no control step: the control laws'
f32 rounding would differ).
"""

import numpy as np
import pytest

from egoego_release_tpu.rl import ar_obs as jao
from egoego_release_tpu.rl import sim_rewards as jsr
from egoego_release_tpu.rl import uhc_obs as juo
from egoego_release_tpu.rl import uhc_rewards as jur
from egoego_release_tpu.rl.mujoco_env import MujocoHumanoidEnv as JEnv
from egoego_release_tpu_torch.rl import ar_obs as tao
from egoego_release_tpu_torch.rl import sim_rewards as tsr
from egoego_release_tpu_torch.rl import uhc_obs as tuo
from egoego_release_tpu_torch.rl import uhc_rewards as tur
from egoego_release_tpu_torch.rl.mujoco_env import MujocoHumanoidEnv as TEnv
from test_torch_trajar import _chip_smoke

T = 8


def expert_qpos(rng, t=T):
    """A smooth standing motion: the root drifting and turning slowly, the
    joints moving a few degrees a frame."""
    q = np.zeros((t, 76))
    q[:, :3] = [0.0, 0.0, 0.95] + np.cumsum(rng.uniform(-0.01, 0.01, (t, 3)), 0)
    yaw = np.cumsum(rng.uniform(-0.02, 0.02, t))
    q[:, 3], q[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    q[:, 7:] = np.cumsum(rng.uniform(-0.03, 0.03, (t, 69)), 0)
    return q


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("uhc")
    rng = np.random.RandomState(0)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    rest[0] = 0.0
    xml = cs.write_humanoid_xml(str(root / "humanoid.xml"), cs.smpl_rest_to_mujoco(rest), physics=True)
    jenv, tenv = JEnv(xml), TEnv(xml, device="cpu")
    q = expert_qpos(rng)
    qvel = rng.randn(75) * 0.3
    jexp, texp = jur.expert_physics_attrs(jenv, q), tur.expert_physics_attrs(tenv, q)
    ind = 3
    state = q[ind] + np.concatenate([rng.randn(3) * 0.02, np.zeros(4), rng.randn(69) * 0.05])
    for env in (jenv, tenv):
        env.reset(state, qvel)
    return dict(jenv=jenv, tenv=tenv, q=q, jexp=jexp, texp=texp, ind=ind, rng=rng,
                action=rng.randn(75) * 0.2, old_action=rng.randn(75) * 0.2)


def _equal(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (float, int, bool, str)) or want is None:
        assert got == want, (what, got, want)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def _cur(U, env, prev_qpos):
    """PhysicsImitation._uhc_cur_state of each package's helpers, and the
    head poses the sim rewards read."""
    qaddr = U.body_qposaddr(env.model)
    qpos = env.get_qpos()
    return {
        "bquat": U.body_quat_local(qpos, qaddr, env.body_names),
        "prev_bquat": U.body_quat_local(prev_qpos, qaddr, env.body_names),
        "ee_wpos": U.env_ee_wpos(env), "com": U.env_com(env), "qpos": qpos, "prev_qpos": prev_qpos,
        "ee_pos": U.env_ee_local(env), "wbquat": U.env_wbquat(env), "wbpos": U.env_wbpos(env),
        "body_com": U.env_body_com(env), "head_pose": env.get_head_pose(),
        "prev_head_pose": env.get_head_pose() + 0.01,
    }


def test_expert_attrs_and_state_equal(world):
    _equal(world["texp"], world["jexp"], "expert_physics_attrs")
    prev = world["q"][world["ind"] - 1]
    _equal(_cur(tur, world["tenv"], prev), _cur(jur, world["jenv"], prev), "cur state")
    # the UHC body range: world + 24 humanoid bodies, the same count in both
    assert tur._lim(world["tenv"]) == jur._lim(world["jenv"]) == 25
    assert tur.body_qposaddr(world["tenv"].model) == jur.body_qposaddr(world["jenv"].model)


@pytest.mark.parametrize("name", sorted(jur.UHC_REWARD_FUNCS))
def test_uhc_rewards_equal(world, name):
    assert sorted(tur.UHC_REWARD_FUNCS) == sorted(jur.UHC_REWARD_FUNCS)
    prev = world["q"][world["ind"] - 1]
    outs = []
    for U, env, exp in ((jur, world["jenv"], world["jexp"]), (tur, world["tenv"], world["texp"])):
        outs.append(U.UHC_REWARD_FUNCS[name](_cur(U, env, prev), exp, world["ind"], world["action"],
                                             ws=None, vf_dim=env.vf_dim, dt=env.dt))
    assert np.isfinite(outs[0][0])
    _equal(outs[1][0], outs[0][0], f"{name} reward")
    _equal(outs[1][1], outs[0][1], f"{name} terms")


def _sim_call(SR, name, cur, expert, ind, action, old_action, env):
    """PhysicsImitation.step's dispatch of a sim reward (rl/imitation.py)."""
    kwargs = dict(ws=None, dt=env.dt)
    args = [cur, expert, ind, action]
    if name.startswith("fine_tune"):
        if name != "fine_tune_action_reward":
            kwargs["kin_bquat"] = expert["bquat"][ind][4:]
        if name != "fine_tune_reward":
            args.append(old_action)
    if name == "deep_mimic_reward_v2_vf":
        kwargs["vf_dim"] = env.vf_dim
    return SR.SIM_REWARD_FUNCS[name](*args, **kwargs)


@pytest.mark.parametrize("name", sorted(jsr.SIM_REWARD_FUNCS))
def test_sim_rewards_equal(world, name):
    assert sorted(tsr.SIM_REWARD_FUNCS) == sorted(jsr.SIM_REWARD_FUNCS)
    prev = world["q"][world["ind"] - 1]
    outs = [_sim_call(SR, name, _cur(U, env, prev), exp, world["ind"], world["action"], world["old_action"], env)
            for SR, U, env, exp in ((jsr, jur, world["jenv"], world["jexp"]),
                                    (tsr, tur, world["tenv"], world["texp"]))]
    assert np.isfinite(outs[0][0])
    _equal(outs[1][0], outs[0][0], f"{name} reward")
    _equal(outs[1][1], outs[0][1], f"{name} terms")


def _obs_cur(U, env):
    return {"qpos": env.get_qpos(), "qvel": env.get_qvel(), "wbpos": U.env_wbpos(env),
            "body_com": U.env_body_com(env), "wbquat": U.env_wbquat(env)}


@pytest.mark.parametrize("obs_v", [0, 1, 2])
@pytest.mark.parametrize("specs", [None, {"obs_vel": "full", "obs_heading": True, "root_deheading": True,
                                          "obs_phase": True}])
def test_uhc_observation_equal(world, obs_v, specs):
    assert tuo.DEFAULT_OBS_SPECS == juo.DEFAULT_OBS_SPECS
    want = juo.uhc_observation(_obs_cur(jur, world["jenv"]), world["jexp"], 2, start_ind=1, obs_v=obs_v, specs=specs)
    got = tuo.uhc_observation(_obs_cur(tur, world["tenv"]), world["texp"], 2, start_ind=1, obs_v=obs_v, specs=specs)
    assert want.ndim == 1 and np.isfinite(want).all()
    _equal(got, want, f"obs_v {obs_v}")


def _ar_context(rng, q):
    t = len(q)
    head = np.concatenate([rng.randn(t, 3) * 0.1 + [0, 0, 1.6], rng.randn(t, 4)], -1)
    head[:, 3:] /= np.linalg.norm(head[:, 3:], axis=-1, keepdims=True)
    return {"qpos": q, "head_pose": head, "head_vels": rng.randn(t, 6) * 0.2,
            "obj_head_relative_poses": rng.randn(t, 7), "action_one_hot": np.eye(4)[rng.randint(4, size=t)],
            "ar_qpos": q + 0.01, "context_feat_rnn": rng.randn(t, 256), "of": rng.randn(t, 32)}


@pytest.mark.parametrize("specs", [None, {"use_context": True, "use_of": True, "policy_v": 2},
                                   {"use_head": False, "use_vel": False}])
def test_ar_obs_equal(world, specs):
    ctx = _ar_context(np.random.RandomState(7), world["q"])
    head_idx = world["jenv"].body_names.index("Head")
    obj = np.array([0.3, -0.2, 0.8, 0.9, 0.1, 0.3, -0.2])
    for obj_qpos in (None, obj):
        want = jao.get_ar_obs_v1(_obs_cur(jur, world["jenv"]), ctx, 3, obj_qpos=obj_qpos, head_idx=head_idx,
                                 specs=specs)
        got = tao.get_ar_obs_v1(_obs_cur(tur, world["tenv"]), ctx, 3, obj_qpos=obj_qpos, head_idx=head_idx,
                                specs=specs)
        _equal(got, want, f"ar_obs {specs} {obj_qpos is not None}")
    assert tao.get_heading is tsr.get_heading and tao.DEFAULT_OBS_SPECS is tuo.DEFAULT_OBS_SPECS


@pytest.mark.parametrize("obs_v", [0, 1])
def test_cc_obs_equal(world, obs_v):
    """The control policy's observation against a kinematic target: the
    expert's next frame as the target dict (ARPhysicsSession._target_dict's
    keys)."""
    e, i = world["jexp"], world["ind"] + 1
    target = {"qpos": e["qpos"][i], "wbpos": e["wbpos"][i], "body_com": e["body_com"][i], "wbquat": e["wbquat"][i]}
    want = jao.get_cc_obs(_obs_cur(jur, world["jenv"]), target, obs_v=obs_v)
    got = tao.get_cc_obs(_obs_cur(tur, world["tenv"]), target, obs_v=obs_v)
    assert np.isfinite(want).all()
    _equal(got, want, f"cc_obs v{obs_v}")
