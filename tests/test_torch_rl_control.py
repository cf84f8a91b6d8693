"""The port's control laws (rl/control.py) against the JAX package's on the
CPU, at f32 on both sides: the humanoid's nv = 75 (ndof 69) and a small
nv = 18 (ndof 12), batched over leading dims, with targets offset by
multiples of 2 pi so that the wrap is exercised.

Tolerance: 1e-5 of each output's max |x| (the stable-PD solve's Cholesky
runs in another order in each package; everything else is elementwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from egoego_release_tpu.rl import control as jc
from egoego_release_tpu_torch.rl import control as tc

TOL = 1e-5


@pytest.fixture(scope="module")
def jitted():
    return {
        "torque": jax.jit(jc.compute_torque, static_argnames=("dt", "a_scale")),
        "rfc": jax.jit(jc.rfc_implicit_force, static_argnames=("residual_force_scale", "residual_force_lim")),
        "wrap": jax.jit(jc.wrap_to_pi),
        "base": jax.jit(jc.remove_base_rot),
    }


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= TOL * top, f"{what}: {err} > {TOL} x {top}"


def _state(rng, lead, ndof):
    nv = 6 + ndof
    n = int(np.prod(lead))
    quats = ScipyRot.random(n, random_state=rng).as_quat()[:, [3, 0, 1, 2]].reshape(lead + (4,))
    qpos = np.concatenate([rng.randn(*lead, 3), quats, rng.uniform(-np.pi, np.pi, lead + (ndof,))], -1)
    qvel = rng.randn(*lead, nv) * 0.5
    base = qpos[..., 7:] + rng.uniform(-0.5, 0.5, lead + (ndof,)) + rng.choice([-2 * np.pi, 0, 2 * np.pi],
                                                                             lead + (ndof,))
    a = rng.randn(*lead, nv, nv)
    M = a @ np.swapaxes(a, -1, -2) + nv * np.eye(nv)
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(ctrl=f32(rng.randn(*lead, ndof)), qpos=f32(qpos), qvel=f32(qvel), base_pos=f32(base), M=f32(M),
                C=f32(rng.randn(*lead, nv)), jkp=f32(rng.uniform(50, 500, ndof)),
                jkd=f32(rng.uniform(5, 50, ndof)))


@pytest.mark.parametrize("lead,ndof", [((3,), 12), ((2, 2), 12), ((4,), 69)])
def test_compute_torque_matches_jax(jitted, lead, ndof):
    s = _state(np.random.RandomState(ndof + len(lead)), lead, ndof)
    dt, a_scale = 1.0 / 450.0, 2.0
    want = jitted["torque"](*(jnp.asarray(s[k]) for k in s), dt=dt, a_scale=a_scale)
    got = tc.compute_torque(*(torch.from_numpy(s[k]) for k in s), dt=dt, a_scale=a_scale)
    _close(got, want, "compute_torque")


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_rfc_implicit_force_matches_jax(jitted, lead):
    rng = np.random.RandomState(len(lead))
    n = int(np.prod(lead))
    vf = (rng.randn(*lead, 6) * 2).astype(np.float32)
    q = ScipyRot.random(n, random_state=rng).as_quat()[:, [3, 0, 1, 2]].reshape(lead + (4,)).astype(np.float32)
    # scale 100 and limit 150: some entries clip, others do not
    want = jitted["rfc"](jnp.asarray(vf), jnp.asarray(q), residual_force_scale=100.0, residual_force_lim=150.0)
    got = tc.rfc_implicit_force(torch.from_numpy(vf), torch.from_numpy(q), 100.0, 150.0)
    assert (np.abs(np.asarray(want)) == 150.0).any() and (np.abs(np.asarray(want)) < 150.0).any()
    _close(got, want, "rfc_implicit_force")


def test_wrap_and_base_rot_match_jax(jitted):
    rng = np.random.RandomState(3)
    x = rng.uniform(-20, 20, (64,)).astype(np.float32)
    _close(tc.wrap_to_pi(torch.from_numpy(x)), jitted["wrap"](jnp.asarray(x)), "wrap_to_pi")
    got = tc.wrap_to_pi(torch.from_numpy(x))
    assert float(got.min()) >= -np.pi and float(got.max()) < np.pi
    q = ScipyRot.random(8, random_state=rng).as_quat()[:, [3, 0, 1, 2]].astype(np.float32)
    _close(tc.remove_base_rot(torch.from_numpy(q)), jitted["base"](jnp.asarray(q)), "remove_base_rot")


def test_stable_pd_solves_the_system():
    """(M + Kd dt) a = -C - Kp e - Kd de holds for the returned a, in float64."""
    rng = np.random.RandomState(5)
    nv = 75
    a = rng.randn(nv, nv)
    M = torch.from_numpy(a @ a.T + nv * np.eye(nv))
    C, e, de = (torch.from_numpy(rng.randn(nv)) for _ in range(3))
    kp, kd = torch.from_numpy(rng.uniform(50, 500, nv)), torch.from_numpy(rng.uniform(5, 50, nv))
    acc = tc.stable_pd_accel(M, C, e, de, kp, kd, 1.0 / 450.0)
    lhs = (M + torch.diag(kd) / 450.0) @ acc
    torch.testing.assert_close(lhs, -(C + kp * e + kd * de), rtol=0, atol=1e-9)
