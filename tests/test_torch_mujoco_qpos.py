"""The port's MuJoCo-skeleton FK, the kinpoly qpos metric suites and
``eval_egoego --mujoco_xml`` against the JAX package on the CPU.

The humanoid XML of the reference (kinpoly's humanoid_smpl_neutral_mesh.xml)
is not in the repo, so each test writes one with kinpoly's 24 bodies in
their order (``chip_smoke.write_humanoid_xml``). Tolerances: parsing is
exact; FK 1e-5 (f32 rounding through 8 tree levels); transform_vec 1e-6;
the metrics 1e-5, relative where a metric is large (mm over many frames);
the CLIs' metrics 1e-3 (f32 through the whole pipeline).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chain import JaxChainNoise, _rest
from test_torch_eval_egoego import make_kinpoly_fixture

import chip_smoke
from egoego_release_tpu.eval import eval_egoego as jegoego
from egoego_release_tpu.eval import metrics as jmetrics
from egoego_release_tpu.eval import qpos_metrics as jqm
from egoego_release_tpu.ops import geometry as jgeo
from egoego_release_tpu.ops import mujoco_xml as jmx
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import DiffusionConfig, new_denoiser
from egoego_release_tpu_torch.eval import eval_egoego
from egoego_release_tpu_torch.eval import metrics as tmetrics
from egoego_release_tpu_torch.eval import qpos_metrics as tqm
from egoego_release_tpu_torch.models.denoiser import init_weights_
from egoego_release_tpu_torch.models.gravitynet import HeadNormalFormer
from egoego_release_tpu_torch.models.headnet import HeadFormer
from egoego_release_tpu_torch.ops import fk as tfk
from egoego_release_tpu_torch.ops import geometry as tgeo
from egoego_release_tpu_torch.ops import mujoco_xml as tmx

T = 40


def _xml(tmp_path, rest):
    return chip_smoke.write_humanoid_xml(str(tmp_path / "humanoid.xml"), chip_smoke.smpl_rest_to_mujoco(rest))


def _qpos(rng, t=T):
    """A kinpoly qpos record (t, 76): a walk at pelvis height, a unit root
    quaternion turning slowly, joint Euler angles in +-0.3."""
    q = np.zeros((t, 76), np.float32)
    q[:, :2] = np.cumsum(rng.uniform(-0.02, 0.02, (t, 2)), 0)
    q[:, 2] = 0.9 + 0.02 * rng.randn(t)
    q[:, 3:7] = chip_smoke.smooth_quats(rng, t)
    q[:, 7:] = rng.uniform(-0.3, 0.3, (t, 69))
    return q


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol, rtol=rtol)


@pytest.fixture()
def skeletons(tmp_path):
    rest = _rest(np.random.RandomState(0))
    path = _xml(tmp_path, rest)
    return tmx.load_mujoco_skeleton(path), jmx.load_mujoco_skeleton(path), rest


def test_load_mujoco_skeleton_matches_jax(skeletons):
    ts, js, _ = skeletons
    assert ts.body_names == js.body_names == chip_smoke.MUJOCO_BODIES
    assert ts.head_idx == js.head_idx == 13
    np.testing.assert_array_equal(ts.parents, js.parents)
    np.testing.assert_array_equal(ts.offsets.numpy(), np.asarray(js.offsets))
    np.testing.assert_array_equal(ts.rest_pos.numpy(), np.asarray(js.rest_pos))


def test_fk_generic_matches_jax(skeletons):
    ts, js, _ = skeletons
    rng = np.random.RandomState(1)
    q = rng.randn(3, 5, 24, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    root = rng.randn(3, 5, 3).astype(np.float32)
    got = tfk.fk_from_local_quat(torch.from_numpy(q), ts.offsets, torch.from_numpy(root), parents=ts.parents)
    want = jmx.fk_generic(jnp.asarray(q), js.offsets, js.parents, jnp.asarray(root))
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-5)


def test_qpos_fk_matches_jax(skeletons):
    ts, js, _ = skeletons
    qpos = _qpos(np.random.RandomState(2))
    for a, b in zip(tmx.qpos_fk(ts, torch.from_numpy(qpos)), jmx.qpos_fk(js, jnp.asarray(qpos))):
        assert a.shape == b.shape
        _close(a.numpy(), b, 1e-5)


def test_qpos_fk_in_smpl_order_is_the_codec_fk(skeletons):
    """On a skeleton built from the SMPL rest offsets, the bodies of
    MUJOCO2SMPL_JOINT_IDX[:22] are the SMPL joints: qpos_fk there equals
    qpos_to_smpl + fk_smpl, which is what eval_egoego --mujoco_xml relies
    on. (The JAX CLI indexes with argsort(MUJOCO2SMPL_JOINT_IDX), the
    inverse permutation, which picks other bodies; ROADMAP C.)"""
    ts, _, rest = skeletons
    qpos = torch.from_numpy(_qpos(np.random.RandomState(3)))
    mq, mp = tmx.qpos_fk(ts, qpos)
    trans, aa = tgeo.qpos_to_smpl(qpos)
    gq, gp = tfk.fk_smpl(trans, aa[:, :22], torch.from_numpy(rest))
    order = tgeo.MUJOCO2SMPL_JOINT_IDX[:22]
    _close(mp[:, order].numpy(), gp.numpy(), 1e-5)
    _close(mq[:, order].numpy(), gq.numpy(), 1e-5)
    assert not np.array_equal(np.argsort(tgeo.MUJOCO2SMPL_JOINT_IDX)[:22], order)


@pytest.mark.parametrize("mode", ["heading", "root"])
def test_transform_vec_matches_jax(mode):
    rng = np.random.RandomState(4)
    v = rng.randn(6, 7, 3).astype(np.float32)
    q = chip_smoke.smooth_quats(rng, 42).reshape(6, 7, 4)
    _close(tgeo.transform_vec(torch.from_numpy(v), torch.from_numpy(q), mode).numpy(),
           jgeo.transform_vec(jnp.asarray(v), jnp.asarray(q), mode), 1e-6)


def test_transform_vec_refuses_other_modes():
    with pytest.raises(ValueError):
        tgeo.transform_vec(torch.zeros(3), torch.tensor([1.0, 0, 0, 0]), "world")


def _records(rng, n=2, t=T):
    gts = [_qpos(rng, t) for _ in range(n)]
    preds = [g + np.concatenate([rng.randn(t, 3) * 0.02, np.zeros((t, 4)), rng.randn(t, 69) * 0.05], -1)
             .astype(np.float32) for g in gts]
    for p in preds:  # near-unit root quaternions, as a model's output
        p[:, 3:7] *= 1.0 + 0.01 * rng.randn(t, 1)
    heads = [np.concatenate([g[:, :3] + [0, 0, 0.6], g[:, 3:7]], -1) for g in gts]
    return {f"take{i}": {"qpos": p, "qpos_gt": g, "head_pose_gt": h}
            for i, (p, g, h) in enumerate(zip(preds, gts, heads))}


@pytest.mark.parametrize("name", ["norm_qpos", "trans_to_velocity", "velocity_to_trans", "qvel_fd_heading",
                                  "qpos_foot_sliding", "_pose_mat4", "_frob", "_fk_take"])
def test_qpos_metric_function_matches_jax(name, skeletons):
    ts, js, _ = skeletons
    rng = np.random.RandomState(5)
    rec = _records(rng, n=1)["take0"]
    qpos, gt = rec["qpos"].astype(np.float64), rec["qpos_gt"].astype(np.float64)
    args = {
        "norm_qpos": (qpos,),
        "trans_to_velocity": (qpos[:, :3],),
        "velocity_to_trans": (qpos[0, :3], np.diff(qpos[:, :3], axis=0)),
        "qvel_fd_heading": (qpos, 1.0 / 30.0),
        # a foot near the floor while the root is up, so the sliding sum is not empty
        "qpos_foot_sliding": (np.concatenate([qpos[:, :2], 0.02 * np.abs(rng.randn(T, 1))], -1), qpos),
        "_pose_mat4": (qpos[:, :3], qpos[:, 3:7]),
        "_frob": (jqm._pose_mat4(qpos[:, :3], qpos[:, 3:7]), jqm._pose_mat4(gt[:, :3], gt[:, 3:7])),
    }.get(name)
    if name == "_fk_take":
        got, want = tqm._fk_take(ts, qpos), jqm._fk_take(js, qpos)
    else:
        got, want = getattr(tqm, name)(*args), getattr(jqm, name)(*args)
    if name == "qpos_foot_sliding":
        assert want > 0
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        _close(a, b, 1e-5, 1e-6)


def test_compute_metrics_for_qpos_records_matches_jax(skeletons):
    ts, js, _ = skeletons
    results = _records(np.random.RandomState(6))
    got, want = tqm.compute_metrics_for_qpos_records(results, ts), jqm.compute_metrics_for_qpos_records(results, js)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], 1e-5, 1e-5)


def test_compute_metrics_for_qpos_matches_jax():
    rng = np.random.RandomState(7)
    rec = _records(rng, n=1)["take0"]
    rest = _rest(rng)
    got = tmetrics.compute_metrics_for_qpos(torch.from_numpy(rec["qpos_gt"]), torch.from_numpy(rec["qpos"]),
                                            torch.from_numpy(rest), 0.01, -0.02)
    want = jmetrics.compute_metrics_for_qpos(jnp.asarray(rec["qpos_gt"]), jnp.asarray(rec["qpos"]),
                                             jnp.asarray(rest), 0.01, -0.02)
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], 1e-5, 1e-5)


# -- the CLIs on the same weights and noise --------------------------------

def write_release_checkpoints(tmp_path, seed=0) -> dict:
    """Random release-width stage-2, HeadNet and GravityNet weights, saved
    in the released .pt layouts that both packages' build_pipeline read."""
    g = torch.Generator().manual_seed(seed)
    den = init_weights_(new_denoiser(DiffusionConfig()), g)
    paths = {k: str(tmp_path / f"{k}.pt") for k in ("diffusion", "headnet", "gravitynet")}
    torch.save({"step": 0, "ema": {"ema_model.denoise_fn." + k: v for k, v in den.state_dict().items()}},
               paths["diffusion"])
    for kind, model in (("headnet", HeadFormer(window=60)), ("gravitynet", HeadNormalFormer(window=120))):
        torch.save({"epoch": 0, "transformer_encoder_state_dict": init_weights_(model, g).state_dict()},
                   paths[kind])
    return paths


class JaxCliNoise:
    """The JAX CLIs' key stream: key = PRNGKey(seed), then per sequence
    ``key, sk = split(key)`` and the chain's windows replayed from sk
    (test_torch_chain.JaxChainNoise). ``windows``: windows per sequence."""

    def __init__(self, seed, windows):
        self.key, self.windows, self.left = jax.random.PRNGKey(seed), windows, 0

    def window(self):
        if not self.left:
            self.key, sk = jax.random.split(self.key)
            self.chain, self.left = JaxChainNoise(sk), self.windows
        self.left -= 1
        return self.chain.window()


def chain_windows(frames, window, overlap=10):
    """Windows of the chained sampler over ``frames``."""
    return len([t for t in range(0, frames, window - overlap) if min(window, frames - t) > overlap])


def cli_argv(fx, ckpts, out_dir, *extra):
    return ["--data_root_folder", fx["root"], "--full_body_gt_path", fx["gt"], "--stats_path", fx["stats"],
            "--rest_offsets", fx["rest"], "--diffusion_ckpt", ckpts["diffusion"], "--headnet_ckpt",
            ckpts["headnet"], "--gravitynet_ckpt", ckpts["gravitynet"], "--window", "16", "--timesteps", "3",
            "--out_dir", str(out_dir), *extra]


def test_eval_egoego_mujoco_xml_matches_jax_cli(tmp_path, monkeypatch):
    """The port's ``eval_egoego --mujoco_xml --save_html_vis`` on the kinpoly
    fixture, with an XML built from the fixture's rest offsets, against the
    JAX CLI with ``--save_html_vis`` on the same weights, noise and
    fixture: every metric within 1e-3, and each sequence's HTML data as
    test_torch_smpl_vis compares it. The JAX side runs without
    --mujoco_xml: its reorder of the bodies is the inverse permutation
    (ROADMAP C), and on this skeleton the codec's GT is the XML's
    (test_qpos_fk_in_smpl_order_is_the_codec_fk)."""
    from test_torch_smpl_vis import same_html_data

    fx = make_kinpoly_fixture(tmp_path)
    ckpts = write_release_checkpoints(tmp_path)
    xml = _xml(tmp_path, np.load(fx["rest"]))
    n_win = chain_windows(20, 16)
    monkeypatch.setattr(eval_egoego, "TorchNoise", lambda device, seed: JaxCliNoise(seed, n_win))
    got = eval_egoego.run(eval_egoego.parse_opt(cli_argv(fx, ckpts, tmp_path / "t", "--mujoco_xml", xml,
                                                         "--save_html_vis", "--device", "cpu")))
    want = jegoego.run(jegoego.parse_opt(cli_argv(fx, ckpts, tmp_path / "j", "--save_html_vis")))
    assert got["num_seqs"] == want["num_seqs"] == 2
    for name in want["per_seq"]:
        assert set(got["per_seq"][name]) == set(want["per_seq"][name])
        for k, v in want["per_seq"][name].items():
            assert abs(got["per_seq"][name][k] - v) <= 1e-3 * max(1.0, abs(v)), (name, k)
        same_html_data(*(chip_smoke.html_data(tmp_path / d / f"{name}.html") for d in ("t", "j")))
    assert json.load(open(tmp_path / "t" / "egoego_pipeline_res_on_kinpoly.json"))["num_seqs"] == 2
