"""The port's VideoRegNet (models/posereg.py), its converter and
``train_posereg`` against the JAX package on the CPU: the same seeded
numpy features and weights (JAX's init, converted by ``utils.convert``).

Tolerances: the network's output within 1e-5 of its max |x| and each
gradient tensor within 1e-4 of its max |g| (LSTM in both directions and
causal, TCN causal and not), the ResNet path's output within 1e-4 of its
max; the training CLI's epoch losses within what the JAX CLI prints (5
decimals) plus 1e-5 relative, with a window of NaN features skipped alike.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egoego_release_tpu.models import posereg as jp
from egoego_release_tpu.training import train_posereg as jtrain
from egoego_release_tpu_torch.data.formats import save_pickle
from egoego_release_tpu_torch.models import posereg as tp
from egoego_release_tpu_torch.training import train_posereg as ttrain
from egoego_release_tpu_torch.utils.convert import posereg_state_dict_from_jax

MODES = {"lstm": dict(v_net_type="lstm"), "lstm_causal": dict(v_net_type="lstm", causal=True),
         "tcn": dict(v_net_type="tcn"), "tcn_causal": dict(v_net_type="tcn", causal=True)}


def _rel_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * max(top, 1e-30), f"{what}: {err} > {tol} x {top}"


@pytest.mark.parametrize("mode", list(MODES))
def test_videoregnet_and_gradients_match_jax(mode):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 12).astype(np.float32)
    y = rng.randn(2, 7, 5).astype(np.float32)
    net_j = jp.VideoRegNet(out_dim=5, v_hdim=8, **MODES[mode])
    params = jax.jit(net_j.init)(jax.random.PRNGKey(1), jnp.asarray(x))

    def loss_fn(p):
        out = net_j.apply(p, jnp.asarray(x))
        return jp.posereg_loss(out, jnp.asarray(y)), out

    (loss_j, out_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    net_t = tp.VideoRegNet(out_dim=5, v_hdim=8, cnn_fdim=12, **MODES[mode])
    net_t.load_state_dict(posereg_state_dict_from_jax(params))
    net_t.train()  # flax's deterministic default: no dropout in train mode either
    out_t = net_t(torch.from_numpy(x))
    loss_t = tp.posereg_loss(out_t, torch.from_numpy(y))
    loss_t.backward()
    _rel_close(out_t.detach(), out_j, 1e-5, f"{mode} output")
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    grads = {n: p.grad for n, p in net_t.named_parameters()}
    for name, g in posereg_state_dict_from_jax(g_j).items():
        _rel_close(grads[name], g, 1e-4, f"{mode} grad {name}")


def test_videoregnet_resnet_path_matches_jax():
    """no_cnn=False: raw flow through the ResNet-18 on its stored statistics."""
    rng = np.random.RandomState(1)
    flow = (rng.randn(1, 2, 32, 32, 2) * 3).astype(np.float32)
    net_j = jp.VideoRegNet(out_dim=5, v_hdim=8, cnn_fdim=16, no_cnn=False)
    variables = jax.jit(net_j.init)(jax.random.PRNGKey(2), jnp.asarray(flow))
    stats = jax.tree.map(lambda a: a + jnp.asarray(rng.uniform(0.1, 0.5, a.shape).astype(np.float32)),
                         variables["batch_stats"])  # stored statistics away from 0 / 1
    variables = {"params": variables["params"], "batch_stats": stats}
    want = jax.jit(net_j.apply)(variables, jnp.asarray(flow))
    net_t = tp.VideoRegNet(out_dim=5, v_hdim=8, cnn_fdim=16, no_cnn=False)
    net_t.load_state_dict(posereg_state_dict_from_jax(variables))
    with torch.no_grad():
        got = net_t.train()(torch.from_numpy(flow))
    assert not net_t.cnn.training
    _rel_close(got, want, 1e-4, "resnet path")


def _write_data(tmp_path, nan_take=False):
    rng = np.random.RandomState(3)
    expert, feats = {}, {}
    for i in range(3):
        name = f"subj-take{i}"
        expert[name] = {"seq_name": name, "qpos": (rng.randn(20, 76) * 0.3).astype(np.float32)}
        feats[name] = rng.randn(22, 12).astype(np.float32)
    if nan_take:
        feats["subj-take1"][7] = np.nan  # poisons one of the take's 4 windows
    save_pickle(expert, str(tmp_path / "expert.p"))
    save_pickle(feats, str(tmp_path / "feats.p"))


@pytest.mark.parametrize("mode", ["lstm", "tcn_causal"])
def test_train_posereg_matches_jax_cli(mode, tmp_path, capsys):
    nan = mode == "lstm"
    _write_data(tmp_path, nan_take=nan)
    argv = ["--expert_path", str(tmp_path / "expert.p"), "--of_feats_path", str(tmp_path / "feats.p"),
            "--fr_num", "5", "--v_hdim", "8", "--epochs", "2", "--batch_size", "4", "--seed", "4",
            "--v_net_type", MODES[mode]["v_net_type"]] + (["--causal"] if MODES[mode].get("causal") else [])
    jtrain.run(jtrain.parse_opt(argv))
    printed = capsys.readouterr().out
    want = [float(v) for v in re.findall(r"epoch \d+: loss ([-\d.na]+)", printed)]
    assert len(want) == 2 and ("NaN loss, batch skipped" in printed) == nan

    of, _ = ttrain.load_windows(str(tmp_path / "expert.p"), str(tmp_path / "feats.p"), 5)
    net_j = jp.VideoRegNet(out_dim=76, v_hdim=8, cnn_fdim=12, **MODES[mode])
    params = jax.jit(net_j.init)(jax.random.PRNGKey(4), jnp.asarray(of[:1]))
    res = ttrain.train(ttrain.parse_opt(argv + ["--device", "cpu"]), state_dict=posereg_state_dict_from_jax(params))
    steps = len(res["losses"]) // 2
    assert steps == 3 and len(of) == 12
    for epoch, w in enumerate(want):
        losses = [v for v in res["losses"][epoch * steps:(epoch + 1) * steps] if np.isfinite(v)]
        assert abs(np.mean(losses) - w) <= 5e-6 + 1e-5 * abs(w), (epoch, np.mean(losses), w)
    assert (not all(np.isfinite(res["losses"]))) == nan
    assert abs(res["last"] - want[-1]) <= 5e-6 + 1e-5 * abs(want[-1])


def test_train_posereg_nan_batch_leaves_state_untouched(tmp_path):
    """A non-finite loss skips the step whole: the parameters and AdamW's
    state (step count, moments) stay as they were."""
    rng = np.random.RandomState(5)
    net = tp.VideoRegNet(out_dim=76, v_hdim=8, cnn_fdim=12, v_net_type="tcn")
    opt = torch.optim.AdamW(net.parameters(), lr=1e-3, weight_decay=1e-4)
    of, q = torch.from_numpy(rng.randn(2, 5, 12).astype(np.float32)), torch.from_numpy(rng.randn(2, 5, 76).astype(
        np.float32))
    assert np.isfinite(ttrain.train_step(net, opt, of, q))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    state = {id(p): {k: v.clone() for k, v in s.items()} for p, s in opt.state.items()}
    of[0, 2, 3] = float("nan")
    assert np.isnan(ttrain.train_step(net, opt, of, q))
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    for p, s in opt.state.items():
        assert all(torch.equal(v, state[id(p)][k]) for k, v in s.items())


def test_train_posereg_cfg_and_checkpoints(tmp_path):
    import yaml

    _write_data(tmp_path)
    with open(tmp_path / "cfg.yml", "w") as f:
        yaml.safe_dump({"fr_num": 5, "model_specs": {"rnn_hdim": 6}}, f)
    last = ttrain.main(["--expert_path", str(tmp_path / "expert.p"), "--of_feats_path", str(tmp_path / "feats.p"),
                        "--cfg", str(tmp_path / "cfg.yml"), "--epochs", "2", "--save_dir", str(tmp_path / "ck"),
                        "--save_interval", "1", "--device", "cpu"])
    assert np.isfinite(last)
    ckpt = torch.load(tmp_path / "ck" / "epoch_2.pt", weights_only=False)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["epoch_1.pt", "epoch_2.pt"]
    assert ckpt["settings"]["v_hdim"] == 6 and ckpt["settings"]["feat_dim"] == 12
    net = tp.VideoRegNet(**ckpt["settings"])
    net.load_state_dict(ckpt["model"])
