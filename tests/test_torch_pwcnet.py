"""The port's PWC-DC network against the JAX package on the CPU, on JAX's
``init_pwcnet`` weights through ``pwcnet_state_dict_from_jax`` and the same
numpy images. These stand in for what tests/test_pwcnet.py's two cases
against the reference's own module cannot check where the reference
checkout is missing.

Tolerances: the cost volume within 1e-6 (a mean of f32 products); the warp
within 2e-6, JAX's own bound against torch's grid_sample, the 0.9999 mask
included; the network's flows within 5e-4, the bound JAX's test holds
PWC-Net to.
"""

import numpy as np
import pytest
import torch

import jax

from egoego_release_tpu.models import pwcnet as jp
from egoego_release_tpu_torch.models import pwcnet as tp
from egoego_release_tpu_torch.utils.convert import pwcnet_state_dict_from_jax


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def nets():
    """JAX's random PWC-Net params and the port's network on them."""
    params = jax.tree_util.tree_map(np.asarray, jp.init_pwcnet(jax.random.PRNGKey(0)))
    net = tp.PWCDCNet()
    net.load_state_dict(pwcnet_state_dict_from_jax(params))
    return params, net


@pytest.mark.parametrize("md", [4, 2])
def test_correlation_matches_jax(md):
    rng = np.random.RandomState(0)
    x1, x2 = (rng.randn(2, 6, 7, 5).astype(np.float32) for _ in range(2))
    got = tp.correlation(_nchw(x1), _nchw(x2), md=md)
    assert got.shape == (2, (2 * md + 1) ** 2, 6, 7)
    np.testing.assert_allclose(_nhwc(got), np.asarray(jp.correlation(x1, x2, md=md)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scale", [0.5, 2.0, 6.0])
def test_warp_matches_jax(scale):
    """Flows of a few pixels put samples past the border: the all-ones
    mask's < 0.9999 zeroing acts (a share of the output is zero) and
    matches JAX's."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 10, 3).astype(np.float32)
    flo = (rng.randn(2, 8, 10, 2) * scale).astype(np.float32)
    want = np.asarray(jp.warp(x, flo))
    got = _nhwc(tp.warp(_nchw(x), _nchw(flo)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)
    if scale >= 2.0:
        assert (want == 0).all(-1).mean() > 0.1


def test_pwcnet_forward_matches_jax(nets):
    """flow2 of a 1 x 64 x 64 pair (B, 2, 16, 16), in eval() through the
    reference's (B, 6, H, W) forward too."""
    params, net = nets
    im = np.random.RandomState(2).rand(1, 64, 64, 6).astype(np.float32)
    want = np.asarray(jp.pwcnet_forward(params, im[..., :3], im[..., 3:]))
    with torch.no_grad():
        got = tp.pwcnet_forward(net, _nchw(im[..., :3]), _nchw(im[..., 3:]))
        via_module = net.eval()(_nchw(im))
    assert got.shape == (1, 2, 16, 16)
    np.testing.assert_allclose(_nhwc(got), want, atol=5e-4, rtol=0)
    np.testing.assert_array_equal(via_module.numpy(), got.numpy())


def test_pwcnet_training_pyramid_matches_jax(nets):
    """The five flows of training=True (and of train() mode), strides 4 to 64."""
    params, net = nets
    im = np.random.RandomState(3).rand(1, 64, 64, 6).astype(np.float32)
    want = jp.pwcnet_forward(params, im[..., :3], im[..., 3:], training=True)
    with torch.no_grad():
        got = tp.pwcnet_forward(net, _nchw(im[..., :3]), _nchw(im[..., 3:]), training=True)
        via_module = net.train()(_nchw(im))
    net.eval()
    assert len(got) == len(want) == len(via_module) == 5
    for lvl, (g, w, m) in enumerate(zip(got, want, via_module)):
        assert g.shape[-1] == 64 // 4 // 2 ** lvl
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=5e-4, rtol=0, err_msg=f"flow{lvl + 2}")
        np.testing.assert_array_equal(m.numpy(), g.numpy())


def test_converter_round_trip(nets):
    """pwcnet_state_dict_from_jax gives every key of the module (the
    reference's names: conv + LeakyReLU blocks under .0, the bare ones
    not), and JAX's convert_pwcnet of that state_dict gives JAX's params
    back bit for bit."""
    params, net = nets
    sd = pwcnet_state_dict_from_jax(params)
    assert set(sd) == set(net.state_dict())
    assert {"conv6aa.0.weight", "predict_flow6.weight", "deconv6.weight", "upfeat6.weight", "dc_conv7.weight",
            "dc_conv6.0.weight"} <= set(sd) and "deconv2.weight" not in sd
    assert tuple(sd["upfeat6.weight"].shape) == (81 + 448, 2, 4, 4)  # ConvTranspose2d: (in, out, kh, kw)
    back = jp.convert_pwcnet({k: v.numpy() for k, v in sd.items()})
    assert set(back) == set(params)
    for name in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(back[name][leaf]), params[name][leaf], err_msg=name)


def test_init_pwcnet_is_seeded_kaiming():
    """init_pwcnet_: one generator seed, one set of weights; zero biases;
    each convolution's std near sqrt(2 / fan_in)."""
    a = tp.init_pwcnet_(tp.PWCDCNet(), torch.Generator().manual_seed(5))
    b = tp.init_pwcnet_(tp.PWCDCNet(), torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.conv2_0[0].weight.detach()
    assert abs(float(w.std()) / (2.0 / (w.shape[1] * 9)) ** 0.5 - 1) < 0.05
    assert all(not m.bias.any() for m in a.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)))
