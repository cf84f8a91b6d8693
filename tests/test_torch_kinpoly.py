"""The port's StateARDataset (data/kinpoly.py), KinpolyConfig
(utils/config.py) and ``eval_sweep`` against the JAX package on the CPU.

Tolerances: the dataset's windows and orders exactly (the same
``random.Random(seed)`` draws); the config's views exactly; the sweep's
per-config means within 1e-4 (relative, or 1e-4 absolute) on the same
TrajARNet weights (JAX's init, converted).
"""

import json

import joblib
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from egoego_release_tpu.data.kinpoly import StateARDataset as JStateAR
from egoego_release_tpu.eval import eval_sweep as jsweep
from egoego_release_tpu.models import trajar as jt
from egoego_release_tpu.utils.config import KinpolyConfig as JKinpolyConfig
from egoego_release_tpu_torch.data.formats import save_pickle
from egoego_release_tpu_torch.data.kinpoly import StateARDataset
from egoego_release_tpu_torch.eval import eval_sweep as tsweep
from egoego_release_tpu_torch.models import trajar as tt
from egoego_release_tpu_torch.utils.config import KinpolyConfig
from egoego_release_tpu_torch.utils.convert import trajar_state_dict_from_jax

TAKES = ("s1-take1", "s1-take2", "s2-take1", "s2-take2")
FR, HDIM, MLP = 6, 16, (32, 16)


class JittedTrajARNet(jt.TrajARNet):
    """JAX's TrajARNet with ``apply`` compiled as one program: eager apply
    traces and compiles the rollout's scan anew at every call (~4 s)."""

    def apply(self, params, *args, **kwargs):
        if self not in _JITTED:
            _JITTED[self] = jax.jit(super().apply)
        return _JITTED[self](params, *args, **kwargs)


_JITTED = {}


def _records(rng, lengths):
    data = {}
    for name, t in zip(TAKES, lengths):
        quat = rng.randn(t, 4)
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        qpos = np.zeros((t, 76), np.float32)
        qpos[:, :3] = np.cumsum(rng.uniform(-0.01, 0.01, (t, 3)), 0) + [0, 0, 0.9]
        qpos[:, 3:7] = [0.7071, 0.7071 * np.cos(0.3), 0.7071 * np.sin(0.3), 0.0]  # a root turned about all axes
        qpos[:, 7:] = rng.uniform(-0.6, 0.6, (t, 69))
        data[name] = {
            "qpos": qpos, "qvel": (rng.randn(t - 1, 75) * 0.01).astype(np.float32),
            "head_pose": np.concatenate([rng.randn(t, 3) * 0.1 + [0, 0, 1.5], quat], -1).astype(np.float32),
            "head_vels": (rng.randn(t, 6) * 0.01).astype(np.float32),
            "obj_pose": np.concatenate([rng.randn(t, 3), np.tile([1.0, 0, 0, 0], (t, 1))], -1).astype(np.float32),
            "obj_head_relative_poses": (rng.randn(t, 7) * 0.1).astype(np.float32), "seq_name": name}
    return data


@pytest.mark.parametrize("writer", ["port", "joblib"])
def test_statear_dataset_matches_jax(tmp_path, writer):
    data = _records(np.random.RandomState(0), (30, 9, 14, 5))  # the last is shorter than a window
    path = str(tmp_path / "expert.p")
    save_pickle(data, path) if writer == "port" else joblib.dump(data, path)
    for kw in (dict(train=True, seed=3), dict(train=False), dict(train=True, seed=1, takes=["s1-take2", "s2-take1"])):
        got, want = StateARDataset(path, fr_num=FR, **kw), JStateAR(path, fr_num=FR, **kw)
        assert len(got) == len(want) and got.names == want.names
        draws = [(got.sample_seq(), want.sample_seq()) for _ in range(12)]
        draws += [(got.sample_seq(i), want.sample_seq(i)) for i in range(len(want))]
        for g, w in draws:
            assert sorted(g) == sorted(w) and g["seq_name"] == w["seq_name"]
            for k in w:
                if k != "seq_name":
                    np.testing.assert_array_equal(g[k], w[k])
            assert g["qvel"].shape == (FR, 75)
        for g, w in zip(*(ds.batch_iterator(3) for ds in (got, want))):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
            break
    eval_item = StateARDataset(path, fr_num=9, train=False).sample_seq(1)  # 9 frames, 8 qvel rows: padded
    np.testing.assert_array_equal(eval_item["qvel"][-1], eval_item["qvel"][-2])
    np.testing.assert_array_equal(eval_item["qpos"], data["s1-take2"]["qpos"])


def _sweep_fixture(tmp_path):
    """An expert pickle, two meta YAMLs with different test takes and two
    statear YAMLs, one on each."""
    save_pickle(_records(np.random.RandomState(1), (24, 20, 16, 12)), str(tmp_path / "mocap_annotations.p"))
    (tmp_path / "meta").mkdir()
    cfgs = []
    for i, test in enumerate((["s1-take2", "s2-take1"], ["s2-take2", "s1-take1"])):
        meta = {"train": [t for t in TAKES if t not in test], "test": test,
                "action_type": {t: "sit" for t in TAKES}, "object": {"sit": "chair"}}
        yaml.safe_dump(meta, open(tmp_path / "meta" / f"meta_v{i}.yml", "w"))
        cfg = {"dataset_path": str(tmp_path), "meta_id": f"meta_v{i}", "data_file": "mocap_annotations",
               "fr_num": FR, "model_specs": {"rnn_hdim": HDIM, "mlp_hsize": list(MLP)},
               "policy_specs": {"reward_id": "dynamic_supervision_v3"}, "w_rp": 50}
        path = str(tmp_path / f"exp_v{i}.yml")
        yaml.safe_dump(cfg, open(path, "w"))
        cfgs.append(path)
    return cfgs


def test_kinpoly_config_matches_jax(tmp_path):
    cfgs = _sweep_fixture(tmp_path)
    for path in cfgs:
        got, want = KinpolyConfig(path), JKinpolyConfig(path)
        assert got.as_dict() == want.as_dict() and got.model_specs == want.model_specs
        assert got.policy_specs == want.policy_specs and got.fr_num == want.fr_num == FR
        assert got.get("missing", 7) == want.get("missing", 7) == 7
        for wild in (False, True):
            assert got.data_file(wild) == want.data_file(wild) and got.meta_id(wild) == want.meta_id(wild)
        meta = got.load_meta(data_dir=str(tmp_path))
        assert meta == want.load_meta(data_dir=str(tmp_path))
        assert KinpolyConfig.resolve_takes(meta) == JKinpolyConfig.resolve_takes(meta)
        with pytest.raises(AttributeError):
            got.missing_key
    assert KinpolyConfig({"fr_num": 3}).fr_num == 3


def test_eval_sweep_matches_jax(tmp_path):
    """eval_config on both YAMLs (the first test take of each), the same
    weights (JAX's model with its apply jitted); then the port's CLI over
    both with a .pt per config, which must report what eval_config did."""
    cfgs = _sweep_fixture(tmp_path)
    rng = np.random.RandomState(2)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    rest[0] = 0.0
    np.save(tmp_path / "rest.npy", rest)
    jm = JittedTrajARNet(rnn_hdim=HDIM, mlp_hsize=MLP, rest_offsets=tuple(map(tuple, rest.tolist())))
    rec = JStateAR(str(tmp_path / "mocap_annotations.p"), fr_num=FR, train=False).sample_seq(0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), {k: jnp.asarray(rec[k][None]) for k in tt.STEP_KEYS})
    fc = params["params"]["ar"]["action_fc"]  # a policy of small actions (see test_torch_trajar.calm)
    fc["kernel"], fc["bias"] = fc["kernel"] * 0.02, jnp.asarray(rng.uniform(-1, 1, fc["bias"].shape), jnp.float32)
    model = tt.TrajARNet(rnn_hdim=HDIM, mlp_hsize=MLP, rest_offsets=rest)
    model.load_state_dict(trajar_state_dict_from_jax(params))
    tmpl = "{data_dir}/{data_file}.p"
    results = {}
    for path in cfgs:
        want = jsweep.eval_config(path, tmpl, rest, split="test", max_takes=1, params=params, model=jm)
        got = tsweep.eval_config(path, tmpl, rest, split="test", max_takes=1, model=model.eval(), device="cpu")
        assert got["num_takes"] == want["num_takes"] == 1 and list(got["per_take"]) == list(want["per_take"])
        assert sorted(got["mean"]) == sorted(want["mean"]) and want["mean"]["diverged"] == 0.0
        for k, v in want["mean"].items():
            assert abs(got["mean"][k] - v) <= 1e-4 * max(1.0, abs(v)), (path, k, got["mean"][k], v)
        results[got["config"]] = got
        torch.save({"model": model.state_dict(), "rnn_hdim": HDIM, "mlp_hsize": list(MLP)},
                   tmp_path / f"{got['config']}.pt")
    out = tsweep.main(["--configs", *cfgs, "--expert_path", tmpl, "--ckpt_pattern", str(tmp_path / "{cfg}.pt"),
                       "--rest_offsets", str(tmp_path / "rest.npy"), "--max_takes", "1", "--out",
                       str(tmp_path / "sweep.json"), "--device", "cpu"])
    saved = json.load(open(tmp_path / "sweep.json"))
    assert sorted(out) == sorted(saved) == ["exp_v0", "exp_v1"]
    for name, res in results.items():
        assert saved[name]["per_take"] == json.loads(json.dumps(res["per_take"]))
