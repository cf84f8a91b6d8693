"""The port's ResNet-18 optical-flow encoder and the ``of_feats`` CLI against
the JAX package on the CPU, on the same weights (``resnet18_state_dict_from_jax``
or one torchvision-layout state_dict given to both) and numpy inputs.

Tolerances: f32 convolutions summed in other orders. On JAX's variables
(outputs O(1)) within 1e-4 absolute; on a torchvision-layout state_dict,
whose features reach O(100), within 1e-4 of the features' max abs, the
bound chip_smoke.py holds the card's ``of_feats`` to. The host resize and
the channel padding bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egoego_release_tpu.models import resnet as jr
from egoego_release_tpu.preprocess import of_feats as jof
from egoego_release_tpu_torch.models import resnet as tr
from egoego_release_tpu_torch.preprocess import of_feats as tof
from egoego_release_tpu_torch.utils.convert import resnet18_state_dict_from_jax

ATOL = 1e-4


def _close_to_scale(got, want, what=""):
    np.testing.assert_allclose(got, want, atol=ATOL * float(np.abs(want).max()), rtol=0, err_msg=what)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _jax_variables(seed=0, hw=64):
    """JAX ResNet18 variables with BatchNorm parameters and statistics moved
    off their init (scale 1, bias 0, mean 0, var 1), so both modes count."""
    variables = jr.ResNet18().init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3)))
    rng = np.random.RandomState(seed + 1)
    draw = {"var": lambda s: 1 + 0.2 * rng.rand(*s), "mean": lambda s: 0.1 * rng.randn(*s),
            "scale": lambda s: 1 + 0.1 * rng.randn(*s), "bias": lambda s: 0.1 * rng.randn(*s)}

    def perturb(path, a):
        key = getattr(path[-1], "key", None)
        return draw[key](a.shape).astype(np.float32) if key in draw and "fc" not in str(path) else np.asarray(a)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def torchvision_state_dict(seed=0, fc_out=1000):
    """A random state_dict in torchvision resnet18's layout (the classifier
    fc has ``fc_out`` outputs)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.05
    sd = {"conv1.weight": r(64, 3, 7, 7)}

    def bn(key, c):
        sd.update({key + ".weight": 1 + r(c), key + ".bias": r(c), key + ".running_mean": r(c),
                   key + ".running_var": 1 + r(c).abs(), key + ".num_batches_tracked": torch.tensor(7)})

    bn("bn1", 64)
    in_c = 64
    for stage, (c, stride) in enumerate(tr.STAGES, start=1):
        for blk in range(2):
            p, cin = f"layer{stage}.{blk}", in_c if blk == 0 else c
            sd[f"{p}.conv1.weight"] = r(c, cin, 3, 3)
            bn(f"{p}.bn1", c)
            sd[f"{p}.conv2.weight"] = r(c, c, 3, 3)
            bn(f"{p}.bn2", c)
            if blk == 0 and (cin != c or stride != 1):
                sd[f"{p}.downsample.0.weight"] = r(c, cin, 1, 1)
                bn(f"{p}.downsample.1", c)
        in_c = c
    sd["fc.weight"], sd["fc.bias"] = r(fc_out, 512), r(fc_out)
    return sd


@pytest.mark.parametrize("running_stats", [True, False], ids=["stored_stats", "batch_stats"])
def test_resnet18_matches_jax(running_stats):
    """ResNet18 on JAX's converted variables, a 2 x 64 x 64 x 3 input: stored
    statistics (JAX train=False) and batch statistics (JAX train=True with
    mutable batch_stats, the HeadFormerWithCNN mode) in eval() and train()."""
    variables = _jax_variables()
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    if running_stats:
        want = jr.ResNet18().apply(variables, jnp.asarray(x))
    else:
        want, _ = jr.ResNet18().apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = tr.ResNet18(running_stats=running_stats)
    model.load_state_dict(resnet18_state_dict_from_jax(variables, running_stats=running_stats))
    modes = ("eval",) if running_stats else ("eval", "train")
    for mode in modes:
        getattr(model, mode)()
        with torch.no_grad():
            got = model(_nchw(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=mode)
    assert all("running" not in k for k in model.state_dict()) == (not running_stats)


def test_flow_to_input_matches_jax():
    """(B, H, W, 2) -> (B, 3, H, W): JAX's (B, H, W, 3) channels first, the
    third channel zero, bit for bit."""
    flow = np.random.RandomState(3).randn(2, 9, 11, 2).astype(np.float32)
    got = tr.flow_to_input(torch.from_numpy(flow)).numpy()
    want = np.asarray(jr.flow_to_input(jnp.asarray(flow))).transpose(0, 3, 1, 2)
    assert got.shape == (2, 3, 9, 11) and not got[:, 2].any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fc_out", [1000, 512], ids=["classifier_replaced", "fc_kept"])
def test_convert_torchvision_resnet18_matches_jax(fc_out):
    """A torchvision-layout state_dict through both converters: the port's
    model (load_state_dict, strict) against JAX's converted one, stored
    statistics; torchvision's 1000-way fc is replaced by JAX's RandomState(0)
    draw, a 512-way one kept."""
    sd = torchvision_state_dict(seed=4, fc_out=fc_out)
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    variables = jr.convert_torchvision_resnet18({k: v.numpy() for k, v in sd.items()})
    want = np.asarray(jr.ResNet18().apply(variables, jnp.asarray(x)))
    port_sd = tr.convert_torchvision_resnet18(sd)
    model = tr.ResNet18()
    model.load_state_dict(port_sd)
    with torch.no_grad():
        got = model.eval()(_nchw(x)).numpy()
    _close_to_scale(got, want)
    np.testing.assert_array_equal(port_sd["fc.weight"].numpy().T, np.asarray(variables["params"]["fc"]["kernel"]))
    np.testing.assert_array_equal(port_sd["fc.bias"].numpy(), np.asarray(variables["params"]["fc"]["bias"]))


@pytest.mark.parametrize("hw", [(100, 120), (224, 224), (360, 480)])
def test_resize_flow_matches_jax(hw):
    flow = np.random.RandomState(6).randn(*hw, 2).astype(np.float32)
    got = tof.resize_flow(flow)
    np.testing.assert_array_equal(got, jof.resize_flow(flow))
    assert got.shape == (224, 224, 2)


def _flow_tree(root, rng, n=5, hw=(100, 120)):
    d = root / "seq" / "raft_flows"
    d.mkdir(parents=True)
    for i in range(n):
        np.save(d / f"{i:05d}.npy", rng.randn(*hw, 2).astype(np.float32))
    return d


def test_of_feats_cli_matches_jax(tmp_path):
    """The CLI on the CPU (--device cpu, batch 2, five non-224 flows) writes
    one 512-d feature npy per flow under raft_of_feats, within 1e-4 of JAX's
    extract_folder on the same torchvision weights (one .pth given to both),
    of the features' max abs."""
    sd = torchvision_state_dict(seed=7)
    pth = tmp_path / "resnet18.pth"
    torch.save(sd, pth)
    _flow_tree(tmp_path / "port", np.random.RandomState(8))
    jax_dir = _flow_tree(tmp_path / "jax", np.random.RandomState(8))
    n = tof.main(["--flow_root", str(tmp_path / "port"), "--torch_resnet", str(pth), "--batch", "2",
                  "--device", "cpu"])
    assert n == 5 == jof.extract_folder(str(jax_dir), jof.build_encoder(str(pth)), batch=2)
    for i in range(5):
        got = np.load(tmp_path / "port" / "seq" / "raft_of_feats" / f"{i:05d}.npy")
        want = np.load(tmp_path / "jax" / "seq" / "raft_of_feats" / f"{i:05d}.npy")
        assert got.shape == (512,) and got.dtype == np.float32
        _close_to_scale(got, want, f"frame {i}")


def test_of_feats_random_encoder_is_seeded(tmp_path, capsys):
    """Without weights the encoder is random from seed 0 (and says so): two
    builds agree bit for bit; the BatchNorm runs on stored statistics."""
    a, b = tof.build_encoder(None, device="cpu"), tof.build_encoder(None, device="cpu")
    assert "random-init" in capsys.readouterr().out
    flows = np.random.RandomState(9).randn(3, 64, 64, 2).astype(np.float32)
    np.testing.assert_array_equal(a(flows), b(flows))
    assert not a.model.training and "bn1.running_mean" in a.model.state_dict()


def test_of_feats_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    _flow_tree(tmp_path, np.random.RandomState(10), n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tof.main(["--flow_root", str(tmp_path)])
