"""The port's VPoser v1 decoder and GIMO pose extraction against the JAX
package on the CPU, on one random snapshot (written by the tests as the
reference's torch state_dict) and the same numpy latents.

Tolerance: 1e-5 on rotation matrices and axis-angle, times each joint's
conditioning (``chip_smoke.vposer_error_scale``, 1 for a well-posed joint):
the three f32 products of width 512 round their 6D output at ~1e-7 of its
max, and the Gram-Schmidt divides that by the length of a column (or of
the second column's part orthogonal to the first), which random weights
make short now and then. The network's 6D outputs themselves within 1e-5
of their max.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egoego_release_tpu.models import vposer as jv
from egoego_release_tpu.preprocess import gimo_pose as jg
from egoego_release_tpu_torch.models import vposer as tv
from egoego_release_tpu_torch.preprocess import gimo_pose as tg

ATOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close_conditioned(got, want, model, latent, output_type, what=""):
    """|got - want| <= 1e-5 x vposer_error_scale per joint."""
    with torch.no_grad():
        d6 = model.rot6d(torch.as_tensor(latent)).numpy()
    scale = _chip_smoke().vposer_error_scale(d6, want if output_type == "aa" else None)
    err = np.abs(got - want).reshape(scale.shape + (-1,)).max(-1)
    assert (err <= ATOL * scale).all(), f"{what}: {float((err / scale).max())} > {ATOL} of the joint's scale"


def snapshot(seed=0, with_encoder=True):
    """A VPoser v1 state_dict with random decoder weights (torch's Linear
    init from a seeded generator) and, like a released snapshot, encoder
    keys that the decoder does not read."""
    g = torch.Generator().manual_seed(seed)

    def lin(n_in, n_out):
        bound = 1.0 / n_in ** 0.5
        return (torch.rand(n_out, n_in, generator=g) * 2 - 1) * bound, (torch.rand(n_out, generator=g) * 2 - 1) * bound

    sd = {}
    for name, n_in, n_out in (("fc1", tv.LATENT_D, tv.NUM_NEURONS), ("fc2", tv.NUM_NEURONS, tv.NUM_NEURONS),
                              ("out", tv.NUM_NEURONS, tv.NUM_JOINTS * 6)):
        sd[f"bodyprior_dec_{name}.weight"], sd[f"bodyprior_dec_{name}.bias"] = lin(n_in, n_out)
    if with_encoder:
        sd["bodyprior_enc_fc1.weight"], sd["bodyprior_enc_fc1.bias"] = lin(63, tv.NUM_NEURONS)
    return sd


def _jax_rot6d(params, latent):
    """JAX's vposer_decode up to its Gram-Schmidt (its network's output)."""
    leaky = lambda y: jnp.maximum(y, 0.2 * y)
    x = leaky(latent @ params["fc1_w"] + params["fc1_b"])
    x = leaky(x @ params["fc2_w"] + params["fc2_b"])
    return np.asarray(x @ params["out_w"] + params["out_b"])


@pytest.mark.parametrize("output_type", ["aa", "matrot"])
def test_vposer_decode_matches_jax(output_type):
    sd = snapshot()
    model = tv.VPoserDecoder()
    model.load_state_dict({k: v for k, v in sd.items() if k.startswith("bodyprior_dec_")})
    latent = np.random.RandomState(1).randn(40, 3, tv.LATENT_D).astype(np.float32)
    params = jv.convert_vposer_state_dict(sd)
    want = np.asarray(jv.vposer_decode(params, jnp.asarray(latent), output_type))
    got = tv.vposer_decode(model, torch.from_numpy(latent), output_type).numpy()
    assert got.shape == ((40, 3, 21, 3) if output_type == "aa" else (40, 3, 21, 3, 3))
    _close_conditioned(got, want, model, latent, output_type)
    with torch.no_grad():  # the network's 6D output, before the Gram-Schmidt
        d6 = model.rot6d(torch.from_numpy(latent)).numpy()
    want6 = _jax_rot6d(params, jnp.asarray(latent)).reshape(d6.shape)
    np.testing.assert_allclose(d6, want6, atol=ATOL * float(np.abs(want6).max()), rtol=0)


def test_cont_rot_repr_decode_is_column_convention():
    """Two COLUMNS, Gram-Schmidt: the first column is a1's direction, and
    the result is a proper rotation; JAX's within 1e-6."""
    d6 = np.random.RandomState(2).randn(50, 6).astype(np.float32)
    m = tv.cont_rot_repr_decode(torch.from_numpy(d6)).numpy()
    a1 = d6.reshape(50, 3, 2)[..., 0]
    np.testing.assert_allclose(m[..., 0], a1 / np.linalg.norm(a1, axis=-1, keepdims=True), atol=1e-6)
    np.testing.assert_allclose(m @ m.transpose(0, 2, 1), np.broadcast_to(np.eye(3), m.shape), atol=1e-5)
    assert (np.linalg.det(m) > 0.999).all()
    np.testing.assert_allclose(m, np.asarray(jv.cont_rot_repr_decode(jnp.asarray(d6))), atol=1e-6)


@pytest.mark.parametrize("nested", [False, True])
def test_load_vposer_ckpt(tmp_path, nested):
    """A snapshot the test writes (a state_dict, or {"state_dict": ...}) loads
    into the decoder in eval(), the encoder's keys left out; its decode
    matches JAX's load_vposer_ckpt of the same file."""
    sd = snapshot(seed=3)
    path = tmp_path / "snapshot.pt"
    torch.save({"state_dict": sd} if nested else sd, path)
    model = tv.load_vposer_ckpt(str(path))
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    latent = np.random.RandomState(4).randn(5, tv.LATENT_D).astype(np.float32)
    want = np.asarray(jv.vposer_decode(jv.load_vposer_ckpt(str(path)), jnp.asarray(latent)))
    _close_conditioned(tv.vposer_decode(model, torch.from_numpy(latent)).numpy(), want, model, latent, "aa")


def test_gimo_extract_all_matches_jax(tmp_path):
    """extract_all (and the CLI, --device cpu) on a 3-sequence fixture: the
    same npzs as JAX's, poses within 1e-5 (of each joint's scale), the rest
    bit for bit."""
    torch.save({"state_dict": snapshot(seed=5)}, tmp_path / "vposer.pt")
    latents = _chip_smoke().write_gimo_fixture(str(tmp_path / "root"), np.random.RandomState(6))
    model = tv.load_vposer_ckpt(str(tmp_path / "vposer.pt"))
    n = tg.main(["--root", str(tmp_path / "root"), "--dest", str(tmp_path / "port"), "--vposer_ckpt",
                 str(tmp_path / "vposer.pt"), "--device", "cpu"])
    assert n == 3 == jg.extract_all(str(tmp_path / "root"), str(tmp_path / "jax"), str(tmp_path / "vposer.pt"))
    for scene, seq, frames in (("sceneA", "seq1", 4), ("sceneA", "seq2", 3), ("sceneB", "seq0", 5)):
        got = np.load(tmp_path / "port" / scene / f"{seq}.npz")
        want = np.load(tmp_path / "jax" / scene / f"{seq}.npz")
        assert set(got.files) == set(want.files) == {"poses", "root_trans", "root_orient", "beta"}
        assert got["poses"].shape == (frames, 21, 3)
        _close_conditioned(got["poses"], want["poses"], model, latents[scene, seq], "aa", f"{scene}/{seq}")
        for k in ("root_trans", "root_orient", "beta"):
            np.testing.assert_array_equal(got[k], want[k])


def test_gimo_extract_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    torch.save(snapshot(), tmp_path / "vposer.pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.extract_all(str(tmp_path), str(tmp_path / "out"), str(tmp_path / "vposer.pt"))
