"""The port's TrajARNet (models/trajar.py), its converter, ``train_trajar``
and ``eval_trajar`` against the JAX package on the CPU: the same expert
windows (``preprocess.qpos`` records of smooth synthetic motion) and the
same weights (JAX's init, converted by ``utils.convert``).

Tolerances: ``step_qpos`` / ``inverse_step_qpos`` / ``build_obs`` within 1e-5
of each output's max |x| (qvel divides by dt, so its rounding is 30 times
that of qpos: held to 3e-4 of its max); the rollout's qpos and qvel at each
step within 1e-4 of that step's max |x| (the random policy's feedback loop
amplifies f32 rounding step by step), the losses within 1e-5 (relative),
each gradient tensor within 1e-4 of its max |g|; the training CLI's losses
within 1e-4 (relative) over its first three Adam steps; the eval means
within 1e-4 (relative) or 1e-4 absolute. The JAX side is jitted wherever the
test calls it directly: eager JAX compiles each op anew.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egoego_release_tpu.data.kinpoly import StateARDataset as JStateAR
from egoego_release_tpu.models import trajar as jt
from egoego_release_tpu.ops.mujoco_xml import load_mujoco_skeleton as j_load_skeleton
from egoego_release_tpu_torch.data import formats as tformats
from egoego_release_tpu_torch.data.kinpoly import StateARDataset
from egoego_release_tpu_torch.models import trajar as tt
from egoego_release_tpu_torch.ops.mujoco_xml import load_mujoco_skeleton
from egoego_release_tpu_torch.utils.convert import trajar_state_dict_from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
FR, B, HDIM, MLP = 6, 2, 16, (32, 16)


class JittedTrajARNet(jt.TrajARNet):
    """JAX's TrajARNet with ``apply`` compiled as one program: eager apply
    traces and compiles the rollout's scan anew at every call (~4 s)."""

    def apply(self, params, *args, **kwargs):
        if self not in _JITTED:
            _JITTED[self] = jax.jit(super().apply)
        return _JITTED[self](params, *args, **kwargs)


_JITTED = {}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * max(top, 1e-30), f"{what}: {err} > {tol} x {top}"


def calm(params):
    """JAX's init with the action head's kernel scaled by 0.02 and its bias
    drawn from U(-1, 1): a random policy's actions of O(1) per unit of its
    state feed qvel (O(1) / dt) back into that state, and the rollout grows
    by orders of magnitude a step, where the gradient is ill-conditioned;
    this one stays O(1). Its joint rotations, and the root's (the fixture's
    root turns about all three axes), stay away from 0 about any axis, where
    JAX's gradient is NaN (test_port_gradient_finite_where_jax_is_nan)."""
    params = jax.tree.map(lambda x: x, params)
    fc = params["params"]["ar"]["action_fc"]
    fc["kernel"] = fc["kernel"] * 0.02
    fc["bias"] = jnp.asarray(np.random.RandomState(9).uniform(-1, 1, fc["bias"].shape).astype(np.float32))
    return params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Rest offsets, an expert pickle written by the port's qpos CLI from a
    smooth motion pickle, a batch of windows, and the JAX model with its
    init and the port's with the converted weights."""
    from egoego_release_tpu_torch.preprocess.qpos import convert_motion_pickle

    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("trajar")
    rng = np.random.RandomState(0)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    rest[0] = 0.0
    np.save(root / "rest.npy", rest)
    cs.smooth_motion_pickle(str(root / "motion.p"), rng, 3)
    motion = tformats.load_pickle(str(root / "motion.p"))
    for rec in motion.values():  # a root that turns about y too: see calm()
        rec["root_orient"][:, 1] = 0.05 + 0.1 * np.sin(np.arange(len(rec["root_orient"])) / 20.0)
    tformats.save_pickle(motion, str(root / "motion.p"))
    convert_motion_pickle(str(root / "motion.p"), str(root / "expert.p"), rest, device="cpu")
    batch = next(StateARDataset(str(root / "expert.p"), fr_num=FR, train=True, seed=3).batch_iterator(B))
    data = {k: batch[k] for k in tt.STEP_KEYS}
    jmodel = jt.TrajARNet(rnn_hdim=HDIM, mlp_hsize=MLP, rest_offsets=tuple(map(tuple, rest.tolist())))
    jinit = jax.jit(jmodel.init)
    params = calm(jinit(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in data.items()}))
    tmodel = tt.TrajARNet(rnn_hdim=HDIM, mlp_hsize=MLP, rest_offsets=rest)
    tmodel.load_state_dict(trajar_state_dict_from_jax(params))
    return dict(root=root, rest=rest, batch=batch, data=data, jmodel=jmodel, jinit=jinit, params=params,
                tmodel=tmodel, cs=cs)


def _qpos_batch(rng, b=8):
    q = rng.uniform(-0.4, 0.4, (b, 76)).astype(np.float32)
    q[:, 3:7] = rng.randn(b, 4)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    return q


def test_step_qpos_and_inverse_match_jax():
    rng = np.random.RandomState(1)
    qpos, nxt = _qpos_batch(rng), _qpos_batch(rng)
    nxt[:, :3] = qpos[:, :3] + rng.uniform(-0.05, 0.05, (8, 3))
    action = rng.randn(8, tt.ACTION_DIM).astype(np.float32) * 0.3
    jq, jv = jax.jit(jt.step_qpos)(jnp.asarray(qpos), jnp.asarray(action))
    tq, tv = tt.step_qpos(torch.from_numpy(qpos), torch.from_numpy(action))
    _rel_close(tq, jq, 1e-5, "step_qpos qpos")
    _rel_close(tv, jv, 3e-4, "step_qpos qvel")
    ja = jax.jit(jt.inverse_step_qpos)(jnp.asarray(qpos), jnp.asarray(nxt))
    ta = tt.inverse_step_qpos(torch.from_numpy(qpos), torch.from_numpy(nxt))
    _rel_close(ta, ja, 3e-4, "inverse_step_qpos")
    # the round trip lands on next_qpos (up to the quaternion's sign, standardized by both)
    back, _ = tt.step_qpos(torch.from_numpy(qpos), ta)
    sign = torch.sign((back[:, 3:7] * torch.from_numpy(nxt[:, 3:7])).sum(-1, keepdim=True))
    back[:, 3:7] *= sign
    _rel_close(back, nxt, 1e-5, "step_qpos(inverse_step_qpos)")


@pytest.mark.parametrize("backend", ["smpl", "xml"])
def test_build_obs_matches_jax(setup, backend, tmp_path):
    rng = np.random.RandomState(2)
    qpos = _qpos_batch(rng, B)
    qvel = rng.randn(B, 75).astype(np.float32)
    ctx = rng.randn(B, HDIM).astype(np.float32)
    data_t = {k: v[:, 2] for k, v in setup["data"].items()}
    kw_j, kw_t = {}, {}
    if backend == "xml":
        cs = setup["cs"]
        xml = cs.write_humanoid_xml(str(tmp_path / "humanoid.xml"), cs.smpl_rest_to_mujoco(setup["rest"]))
        sk_j, sk_t = j_load_skeleton(xml), load_mujoco_skeleton(xml)
        kw_j, kw_t = dict(skeleton=sk_j, head_idx=sk_j.head_idx), dict(skeleton=sk_t, head_idx=sk_t.head_idx)
    obs = jax.jit(lambda *a: jt.build_obs(*a, **kw_j))
    want = obs(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctx), {k: jnp.asarray(v) for k, v in data_t.items()},
               jnp.asarray(setup["rest"]))
    got = tt.build_obs(torch.from_numpy(qpos), torch.from_numpy(qvel), torch.from_numpy(ctx),
                       {k: torch.from_numpy(v) for k, v in data_t.items()}, torch.from_numpy(setup["rest"]), **kw_t)
    assert got.shape == (B, tt.obs_dim(HDIM))
    _rel_close(got, want, 1e-5, f"build_obs {backend}")


def _jax_loss_and_grads(setup):
    """JAX's rollout from the GT's first qpos, trajar_loss and its
    gradients, jitted once for the module (the CLI's loss_fn)."""
    if "jax_vg" not in setup:
        m, rest = setup["jmodel"], jnp.asarray(setup["rest"])

        def loss_fn(p, data, gt):
            out = m.apply(p, data, init_qpos=gt[:, 0])
            return jt.trajar_loss(out, gt, rest), out

        setup["jax_vg"] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return setup["jax_vg"]


def _port_grads(model):
    """Each parameter's gradient; zero for those the loss does not reach (the
    context head's, when the rollout starts from the GT), as JAX gives."""
    return {n: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            for n, p in model.named_parameters()}


def test_trajarnet_rollout_losses_and_gradients_match_jax(setup):
    data, gt = setup["data"], setup["batch"]["qpos"]
    (loss_j, out_j), g_j = _jax_loss_and_grads(setup)(setup["params"], {k: jnp.asarray(v) for k, v in data.items()},
                                                      jnp.asarray(gt))
    model = setup["tmodel"]
    model.zero_grad()
    out_t = model({k: torch.from_numpy(v) for k, v in data.items()}, init_qpos=torch.from_numpy(gt[:, 0]))
    loss_t = tt.trajar_loss(out_t, torch.from_numpy(gt), model.rest_offsets)
    loss_t.backward()
    for key in ("qpos", "qvel"):
        for i in range(FR):
            _rel_close(out_t[key][:, i].detach(), np.asarray(out_j[key])[:, i], 1e-4, f"{key} step {i}")
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    g_t = _port_grads(model)
    for name, g in trajar_state_dict_from_jax(g_j).items():
        _rel_close(g_t[name], g, 1e-4, f"grad {name}")
    # the init_qpos=None path: z from the context head
    want = setup["jmodel"].apply(setup["params"], {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    for i in range(FR):
        _rel_close(got["qpos"][:, i], np.asarray(want["qpos"])[:, i], 1e-4, f"no init_qpos, step {i}")


def test_port_gradient_finite_where_jax_is_nan():
    """A rotation with no component about one axis: JAX's matrix_to_quat
    takes sqrt(max(x, 0)) of that axis's candidate at x <= 0, whose infinite
    slope times the zero gradient of an unchosen candidate is NaN, so its
    FK's gradient (and TrajARNet's, whenever a predicted joint or the root
    turns about fewer than three axes) is NaN. The port's candidates get a
    zero gradient there; the values agree."""
    from egoego_release_tpu.ops import fk as jfk
    from egoego_release_tpu_torch.ops import fk as tfk

    rest = np.random.RandomState(5).uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    aa = np.random.RandomState(6).uniform(-0.5, 0.5, (3, 22, 3)).astype(np.float32)
    aa[:, 4, 1:] = 0.0  # a knee bending about x alone
    fk_j = jax.jit(lambda a: jfk.fk_smpl(jnp.zeros((3, 3)), a, jnp.asarray(rest))[1])
    g_j = np.asarray(jax.jit(jax.grad(lambda a: fk_j(a).sum()))(jnp.asarray(aa)))
    a_t = torch.tensor(aa, requires_grad=True)
    _, p_t = tfk.fk_smpl(torch.zeros(3, 3), a_t, torch.from_numpy(rest))
    p_t.sum().backward()
    assert np.isnan(g_j).any() and torch.isfinite(a_t.grad).all()
    _rel_close(p_t.detach(), fk_j(jnp.asarray(aa)), 1e-6, "fk")
    finite = ~np.isnan(g_j).any(axis=-1)
    _rel_close(a_t.grad.numpy()[finite], g_j[finite], 1e-4, "fk gradient where JAX's is finite")


def test_trajar_reference_loss_and_gradients_match_jax():
    rng = np.random.RandomState(4)
    b, t, j = 2, 5, 24
    q = lambda *s: (lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True))(rng.randn(*s, 4)).astype(np.float32)
    pred = {"qpos": np.concatenate([rng.randn(b, t, 3), q(b, t), rng.randn(b, t, 69)], -1).astype(np.float32),
            "qvel": rng.randn(b, t, 75).astype(np.float32), "wbpos": rng.randn(b, t, j * 3).astype(np.float32),
            "obj_2_head": np.concatenate([rng.randn(b, t, 3), q(b, t)], -1).astype(np.float32)}
    data = {k: rng.randn(*v.shape).astype(np.float32) for k, v in pred.items() if k != "obj_2_head"}
    data["qpos"][..., 3:7] = q(b, t)
    data["obj_head_relative_poses"] = np.concatenate([rng.randn(b, t, 3), q(b, t)], -1).astype(np.float32)
    specs = {"w_rp": 30, "w_ee": 2}

    def jloss(p):
        return jt.trajar_reference_loss(p, {k: jnp.asarray(v) for k, v in data.items()}, specs)

    (lj, terms_j), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))({k: jnp.asarray(v) for k, v in pred.items()})
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in pred.items()}
    lt, terms_t = tt.trajar_reference_loss(pt, {k: torch.from_numpy(v) for k, v in data.items()}, specs)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    for a, b_ in zip(terms_t, terms_j):
        assert abs(float(a.detach()) - float(b_)) <= 1e-5 * abs(float(b_))
    for k in pred:
        _rel_close(pt[k].grad, gj[k], 1e-5, f"grad {k}")


def test_train_trajar_losses_match_jax(setup, tmp_path):
    """The port's CLI (three epochs of one step, batch 2, from JAX's init)
    against the JAX CLI's step: its dataset and batch order (the first
    batch drawn for the init), its loss (the jitted value_and_grad above,
    which is make_train_step's loss_fn) and its optax chain
    (clip_by_global_norm(1.0), adam(lr)); make_train_step itself would
    compile the same rollout again."""
    import optax

    from egoego_release_tpu_torch.training import train_trajar

    expert, lr, steps = str(setup["root"] / "expert.p"), 5e-4, 3
    ds = JStateAR(expert, fr_num=FR, train=True, seed=0)
    batches = ds.batch_iterator(B)
    first = next(batches)
    data0 = {k: jnp.asarray(v) for k, v in first.items() if k in tt.STEP_KEYS}
    params = calm(setup["jinit"](jax.random.PRNGKey(0), data0))
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    opt_state, vg, p, want = opt.init(params), _jax_loss_and_grads(setup), params, []
    update = jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(*opt.update(g, st, p)))
    for _ in range(steps):
        b = next(batches)
        (loss, _), g = vg(p, {k: jnp.asarray(b[k]) for k in tt.STEP_KEYS}, jnp.asarray(b["qpos"]))
        p, opt_state = update(g, opt_state, p)
        want.append(float(loss))
    assert len(ds) // B == 1  # one step an epoch in the port's run
    model, got = train_trajar.run(expert, setup["rest"], epochs=steps, fr_num=FR, batch_size=B, lr=lr,
                                  rnn_hdim=HDIM, mlp_hsize=MLP, save_dir=str(tmp_path), seed=0, device="cpu",
                                  state_dict=trajar_state_dict_from_jax(params))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    reloaded = train_trajar.load_trajar(str(tmp_path / "final.pt"), setup["rest"])
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in reloaded.state_dict().items())
    for name, w in trajar_state_dict_from_jax(p).items():
        _rel_close(model.state_dict()[name], w, 1e-4, f"param {name} after {steps} steps")


def test_train_trajar_cli_runs_from_seed(setup, tmp_path):
    from egoego_release_tpu_torch.training import train_trajar

    model, losses = train_trajar.main(["--expert_path", str(setup["root"] / "expert.p"), "--rest_offsets",
                                       str(setup["root"] / "rest.npy"), "--epochs", "2", "--fr_num", str(FR),
                                       "--batch_size", str(B), "--save_dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses)) and model.rnn_hdim == 512
    assert (tmp_path / "final.pt").exists()


def test_cli_init_keeps_a_90_frame_rollout_finite(setup):
    """flax's init alone (the JAX CLI's scheme) overflows a 90-frame rollout
    at the CLI's widths; the port's (the action head scaled down) stays
    finite."""
    from egoego_release_tpu_torch.models.init import flax_init_

    batch = next(StateARDataset(str(setup["root"] / "expert.p"), fr_num=90, train=True, seed=0).batch_iterator(2))
    data = {k: torch.from_numpy(batch[k]) for k in tt.STEP_KEYS}
    final = {}
    for name, init in (("flax", flax_init_), ("port", tt.init_trajar_)):
        model = init(tt.TrajARNet(rest_offsets=setup["rest"]), torch.Generator().manual_seed(0))
        with torch.no_grad():
            final[name] = model(data, init_qpos=torch.from_numpy(batch["qpos"][:, 0]))["qpos"]
    assert not torch.isfinite(final["flax"]).all()
    assert torch.isfinite(final["port"]).all() and float(final["port"].abs().max()) < 100


def test_eval_trajar_matches_jax(setup, tmp_path, monkeypatch):
    """Both CLIs with --mujoco_xml over the first expert record (its first FR
    frames), on the same weights: the JAX CLI's orbax checkpointer handed
    them in memory, its model's apply and eval_record's functions jitted,
    the port's CLI reading a .pt (the CLIs' MLP is (1024, 512))."""
    import json

    import orbax.checkpoint as ocp

    from egoego_release_tpu.eval import eval_trajar as je
    from egoego_release_tpu.eval import qpos_metrics as jqm
    from egoego_release_tpu_torch.eval import eval_trajar as te

    cs, rest = setup["cs"], setup["rest"]
    data = {k: jnp.asarray(v[:1]) for k, v in setup["data"].items()}
    jm = jt.TrajARNet(rnn_hdim=HDIM, mlp_hsize=(1024, 512), rest_offsets=tuple(map(tuple, rest.tolist())))
    params = calm(jax.jit(jm.init)(jax.random.PRNGKey(1), data))
    monkeypatch.setattr(ocp, "PyTreeCheckpointer", lambda: type("Restore", (), {"restore": lambda self, path: params})())
    monkeypatch.setattr(je, "TrajARNet", JittedTrajARNet)
    for mod, name in ((je.fk_mod, "fk_smpl"), (je.geometry, "qpos_to_smpl"),
                      (je.metrics_mod, "compute_metrics_for_smpl")):  # eval_record's JAX functions, as one program each
        monkeypatch.setattr(mod, name, jax.jit(getattr(mod, name)))
    qpos_fk, fk_jit = jqm.qpos_fk, {}
    monkeypatch.setattr(jqm, "qpos_fk", lambda sk, q: fk_jit.setdefault(id(sk), jax.jit(lambda q: qpos_fk(sk, q)))(q))
    (tmp_path / "jax_ckpt").mkdir()
    torch.save({"model": trajar_state_dict_from_jax(params), "rnn_hdim": HDIM, "mlp_hsize": [1024, 512]},
               tmp_path / "final.pt")
    xml = cs.write_humanoid_xml(str(tmp_path / "humanoid.xml"), cs.smpl_rest_to_mujoco(rest))
    argv = ["--expert_path", str(setup["root"] / "expert.p"), "--rest_offsets", str(setup["root"] / "rest.npy"),
            "--fr_num", str(FR), "--rnn_hdim", str(HDIM), "--mujoco_xml", xml, "--max_seqs", "1"]
    want = je.run(je.parse_opt(argv + ["--ckpt", str(tmp_path / "jax_ckpt"), "--out_dir", str(tmp_path / "j")]))
    got = te.run(te.parse_opt(argv + ["--ckpt", str(tmp_path / "final.pt"), "--out_dir", str(tmp_path / "t"),
                                      "--device", "cpu"]))
    assert sorted(got) == sorted(want) and "mpjpe" in got and want["diverged"] == 0.0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    res_j = json.load(open(tmp_path / "j" / "trajar_baseline_res.json"))
    res_t = json.load(open(tmp_path / "t" / "trajar_baseline_res.json"))
    assert sorted(res_t["qpos_metrics"]) == sorted(res_j["qpos_metrics"])
    for k, v in res_j["qpos_metrics"].items():
        assert abs(res_t["qpos_metrics"][k] - v) <= 1e-4 * max(1.0, abs(v)), (k, res_t["qpos_metrics"][k], v)


def test_eval_trajar_physics_metrics_raises_and_random_init_warns(setup, tmp_path, capsys):
    """--physics_metrics without --mujoco_xml adds nothing, as in JAX (the
    suite runs over the qpos records that --mujoco_xml keeps; the flag
    itself is held against JAX in tests/test_torch_physics.py)."""
    import json

    from egoego_release_tpu_torch.eval import eval_trajar as te

    argv = ["--expert_path", str(setup["root"] / "expert.p"), "--rest_offsets", str(setup["root"] / "rest.npy"),
            "--fr_num", str(FR), "--rnn_hdim", str(HDIM), "--out_dir", str(tmp_path), "--device", "cpu"]
    te.run(te.parse_opt(argv + ["--physics_metrics", "--max_seqs", "1"]))
    assert "physics_metrics" not in json.load(open(tmp_path / "trajar_baseline_res.json"))
    res = te.run(te.parse_opt(argv + ["--max_seqs", "1"]))
    assert "WARNING: no TrajARNet checkpoint" in capsys.readouterr().out
    assert set(res) >= {"diverged"}
