"""The port's raw-flow HeadNet against the JAX package on the CPU:
``HeadFormerWithCNN`` (ResNet-18 with batch-statistics BatchNorm in front of
HeadFormer), its loss, gradients and AdamW step with the CNN frozen
(``freeze_subtrees``) or trained, and the raw-flow data path
(``augment_flow``, ``load_raw_flows``, ``HeadPoseSequenceDataset(
input_of_feats=False)``), on the same weights (``stage1_state_from_jax(...,
"headnet_cnn")``) and numpy inputs, at narrow widths (d_model 16, 1 layer,
2 heads, cnn_fdim 32, 2 x 4 flow frames of 64 x 64).

Tolerances: the forward within 1e-4 (f32 convolutions and products in
other orders). The loss, its gradients and the AdamW step are compared with
JAX under ``jax.enable_x64`` (its ResNet and BatchNorm then run in float64;
its transformer keeps the f32 dtype its modules name) and the port in
float64 (``chip_smoke.float64_mode``), at the bounds
tests/test_torch_stage1_training.py holds the feature path to: the loss
within 1e-6 relative, gradients within 1e-5 of each tensor's max, moments
and parameters as ``_check_step``. In f32 the two differ by more than
that, and JAX is the one that drifts: its batch-statistics BatchNorm takes
the variance as E[x^2] - E[x]^2, and its f32 gradients of a trained CNN lie
up to 10% of a tensor's max from its x64 ones, where the port's lie within
1e-5. So in f32 the port's loss and gradients are held to lie as close to
JAX's x64 ones as JAX's f32 ones do, or within those bounds. Frozen
parameters, the augmentation and the loaders bit for bit.
"""

import contextlib
import pickle
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from egoego_release_tpu.data import formats as jformats
from egoego_release_tpu.data import headpose as jhp
from egoego_release_tpu.models import headnet as jhn
from egoego_release_tpu.training import trainer_stage1 as jts
from egoego_release_tpu_torch.data import formats as tformats
from egoego_release_tpu_torch.data import headpose as thp
from egoego_release_tpu_torch.models import headnet as thn
from egoego_release_tpu_torch.models.transformer import set_dropout_rate
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.training import trainer_stage1 as tts
from egoego_release_tpu_torch.utils.convert import headformer_cnn_state_dict_from_jax, stage1_state_from_jax
from egoego_release_tpu_torch.utils.convert import load_denoiser_weights
from test_torch_stage1_training import _check_step, _chip_smoke, _close, _quats, _zero_grad

HEAD = dict(d_model=16, n_layers=1, n_head=2, d_k=8, d_v=8, window=4, cnn_fdim=32, mlp_hsize=(8,))
B, T, HW = 2, 4, 64


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"of": rng.randn(B, T, HW, HW, 2).astype(np.float32),
            "head_pose": np.concatenate([np.cumsum(rng.randn(B, T + 1, 3) * 0.05, 1), _quats(rng, B, T + 1)],
                                        -1).astype(np.float32),
            "head_vels": (rng.randn(B, T, 6) * 0.5).astype(np.float32),
            "seq_len": np.asarray([T, T - 1], np.int64)}


def _jax_model(freeze_cnn):
    model = jhn.HeadFormerWithCNN(headformer=jhn.HeadFormer(**HEAD), freeze_cnn=freeze_cnn)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, T, HW, HW, 2)), jnp.ones((1, T)))
    return model, params


def _jax_loss(model, params, batch, key):
    """jts.headnet_cnn_loss_fn with dropout off."""
    mask = jhn.padding_mask_from_len(batch["seq_len"].astype(jnp.float32), model.headformer.window)
    (va, dist), _ = model.apply(params, batch["of"], mask, deterministic=True, mutable=["batch_stats"])
    hp = batch["head_pose"]
    loss, (ol, vl, dl) = jhn.headformer_loss(va, dist, hp[:, 0, 3:], batch["head_vels"][:, :, 3:], hp[:, :, 3:],
                                             hp[:, :, :3])
    return loss, {"orient": ol, "va": vl, "dist": dl}


def _port_model(params, freeze_cnn):
    model = thn.HeadFormerWithCNN(**HEAD, freeze_cnn=freeze_cnn)
    load_denoiser_weights(model, headformer_cnn_state_dict_from_jax(params))
    return set_dropout_rate(model, 0.0)


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() if k == "seq_len" else torch.as_tensor(v).float() for k, v in batch.items()}


def test_headformer_with_cnn_matches_jax():
    """The forward (va, dist) on 2 x 4 frames of 64 x 64, BatchNorm over all
    8 frames, in eval() and train() (dropout off) alike; the keys are
    HeadFormer's and the ResNet's under cnn., with no running buffers."""
    model, params = _jax_model(True)
    batch = _batch(1)
    mask = np.asarray([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
    (va_j, dist_j), _ = model.apply(params, jnp.asarray(batch["of"]), jnp.asarray(mask), mutable=["batch_stats"])
    port = _port_model(params, True)
    sd = port.state_dict()
    assert "cnn.layer2.0.downsample.0.weight" in sd and "action_transformer.start_conv.weight" in sd
    assert not any("running" in k for k in sd)
    for mode in ("eval", "train"):
        getattr(port, mode)()
        with torch.no_grad():
            va, dist = port(torch.from_numpy(batch["of"]), torch.from_numpy(mask))
        np.testing.assert_allclose(va.numpy(), np.asarray(va_j), atol=1e-4, rtol=0, err_msg=mode)
        np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), atol=1e-4, rtol=0, err_msg=mode)


def _f64(tree):  # a tree cast to float64 (under jax.enable_x64)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def _jax_loss_grads(model, params, batch, x64):
    """JAX's loss and gradients (as the port's state_dict, float64), in f32
    or, with ``x64``, from float64 parameters and inputs."""
    with jax.enable_x64(x64):
        cast = _f64 if x64 else (lambda t: t)
        b = {k: jnp.asarray(v) if k == "seq_len" else cast(jnp.asarray(v)) for k, v in batch.items()}
        (loss, _), g = jax.jit(jax.value_and_grad(lambda p: _jax_loss(model, p, b, None), has_aux=True))(cast(params))
        g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g)
    return float(loss), {k: v.double() for k, v in headformer_cnn_state_dict_from_jax(g).items()}


def _port_loss_grads(params, batch, freeze_cnn, x64):
    """The port's loss and parameter gradients (None where frozen), in f32
    or in float64 throughout."""
    port = _port_model(params, freeze_cnn).train()
    tb = _torch_batch(batch)
    with _chip_smoke().float64_mode() if x64 else contextlib.nullcontext():
        if x64:
            port, tb = port.double(), {k: v if k == "seq_len" else v.double() for k, v in tb.items()}
        loss, _ = tts.headnet_cnn_loss_fn(port, tb)
        loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in port.named_parameters()}


def _grad_err(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("freeze_cnn", [True, False], ids=["frozen_cnn", "trained_cnn"])
def test_headnet_cnn_loss_and_grads_match_jax(freeze_cnn):
    """headnet_cnn_loss_fn and the gradient of every parameter against JAX's
    (value_and_grad through the mutable apply): in float64 within the
    feature path's bounds; in f32 at least as close to JAX's float64 as
    JAX's f32. With the CNN frozen JAX's CNN gradients are zero
    (stop_gradient) and the port computes none (the ResNet runs under
    no_grad)."""
    model, params = _jax_model(freeze_cnn)
    batch = _batch(2)
    l64, g64 = _jax_loss_grads(model, params, batch, x64=True)
    l32, g32 = _jax_loss_grads(model, params, batch, x64=False)
    lt64, gt64 = _port_loss_grads(params, batch, freeze_cnn, x64=True)
    lt32, gt32 = _port_loss_grads(params, batch, freeze_cnn, x64=False)
    assert abs(lt64 - l64) <= 1e-6 * abs(l64)
    assert abs(lt32 - l64) <= max(1e-6 * abs(l64), abs(l32 - l64))
    top = max(float(v.abs().max()) for v in g64.values())
    for name, grad in gt64.items():
        if freeze_cnn and name.startswith("cnn."):
            assert grad is None and gt32[name] is None and not g64[name].any() and not g32[name].any(), name
        elif _zero_grad(name):
            for got in (grad, gt32[name]):
                assert float((got.double() - g64[name]).abs().max()) <= 1e-6 * top, name
        else:
            _close(grad.numpy(), g64[name].numpy(), 1e-5, name)
            assert _grad_err(gt32[name], g64[name]) <= max(1e-5, _grad_err(g32[name], g64[name])), name


@pytest.mark.parametrize("freeze_cnn", [True, False], ids=["frozen_cnn", "trained_cnn"])
def test_optimizer_steps_match_optax_freeze_subtrees(freeze_cnn):
    """One AdamW step (lr 1e-2, weight decay 0.1: a decay of 1e-3 of each
    parameter, far above the checks' 1e-5) against JAX's trainer under
    freeze_subtrees, JAX under x64 and the port in float64, from one state:
    the loss, the moments and the parameters of the trained set
    (_check_step), and AdamW over that set alone. Frozen, the CNN keeps its
    weights bit for bit, on both sides: no update and no weight decay.
    Trained, every CNN parameter moves. (A second step would start from
    states that JAX's f32 transformer and the port's float64 one have
    rounded apart, which a trained CNN's batch statistics amplify.)"""
    model, params = _jax_model(freeze_cnn)
    frozen = ("cnn", "batch_stats") if freeze_cnn else ("batch_stats",)
    trainer = tts.Stage1Trainer(tts.headnet_cnn_loss_fn, tts.make_optimizer(1e-2, 2, 0.3, 1, weight_decay=0.1))
    cnn0 = {k: v.clone() for k, v in headformer_cnn_state_dict_from_jax(params).items() if k.startswith("cnn.")}
    batch = {k: v if k == "seq_len" else v.astype(np.float64) for k, v in _batch(3).items()}
    with jax.enable_x64(True):
        optimizer = optax.chain(optax.clip_by_global_norm(1.0),
                                optax.adamw(optax.exponential_decay(1e-2, 2, 0.3, staircase=True), weight_decay=0.1))
        jt = jts.Stage1Trainer(model, _jax_loss, jts.freeze_subtrees(optimizer, frozen))
        jstate = jt.init_state(_f64(params))
        port = thn.HeadFormerWithCNN(**HEAD, freeze_cnn=freeze_cnn).double()
        tts.freeze_subtrees(port, ("cnn",) if freeze_cnn else ())
        tstate = trainer.state_from_dict(port, stage1_state_from_jax(jstate, "headnet_cnn"))
        set_dropout_rate(tstate.model, 0.0)
        trained = {p for g in tstate.optimizer.param_groups for p in g["params"]}
        assert trained == {p for n, p in port.named_parameters() if not (freeze_cnn and n.startswith("cnn."))}
        jstate, jl, _ = jt.train_step(jstate, batch, jax.random.PRNGKey(0))
        with _chip_smoke().float64_mode():
            tstate, tl, _ = trainer.train_step(tstate, batch, TorchNoise("cpu", 0))
        assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
        _check_step(jstate, tstate, "headnet_cnn", lr=trainer.optimizer.learning_rate(0))
        after = headformer_cnn_state_dict_from_jax(jstate.params)
    params_t = dict(tstate.model.named_parameters())
    for k, v in cnn0.items():
        moved_t, moved_j = not torch.equal(params_t[k].detach().float(), v), not torch.equal(after[k], v)
        assert moved_t == moved_j == (not freeze_cnn), k


@pytest.mark.parametrize("seed,hw", [(0, (240, 240)), (1, (256, 320)), (2, (100, 120))])
def test_augment_flow_matches_jax(seed, hw):
    """The same draws from the same RandomState, in the same order: bit for
    bit, float64, 224 x 224 x 2, and both states left at the same place."""
    flow = np.random.RandomState(10 + seed).randn(*hw, 2).astype(np.float32)
    rs_t, rs_j = np.random.RandomState(seed), np.random.RandomState(seed)
    got, want = thp.augment_flow(flow, rs_t), jhp.augment_flow(flow, rs_j)
    assert got.shape == (224, 224, 2) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert rs_t.randint(1 << 30) == rs_j.randint(1 << 30)


def _flow_files(tmp_path, n=5, hw=(240, 256), seed=4):
    rng = np.random.RandomState(seed)
    d = tmp_path / "seq" / "raft_flows"
    d.mkdir(parents=True)
    for i in range(n):
        np.save(d / f"{i:05d}.npy", (rng.randn(*hw, 2) * 3).astype(np.float32))
    return [f"/authors/seq/raft_flows/{i:05d}.npy" for i in range(n)]


@pytest.mark.parametrize("augment", [False, True])
def test_load_raw_flows_matches_jax(tmp_path, augment):
    """load_raw_flows with the authors' paths rewritten: (T, H, W, 2) f32,
    bit for bit, with and without a per-frame augment_flow."""
    files = _flow_files(tmp_path)
    rewrite = ("/authors", str(tmp_path))
    aug = (lambda rs: (lambda f: thp.augment_flow(f, rs))) if augment else (lambda rs: None)
    jaug = (lambda rs: (lambda f: jhp.augment_flow(f, rs))) if augment else (lambda rs: None)
    got = tformats.load_raw_flows(files, rewrite, augment=aug(np.random.RandomState(5)))
    want = jformats.load_raw_flows(files, rewrite, augment=jaug(np.random.RandomState(5)))
    assert got.dtype == np.float32 and got.shape == ((5, 224, 224, 2) if augment else (5, 240, 256, 2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_raw_flow_dataset_items_match_jax(tmp_path, train):
    """HeadPoseSequenceDataset(input_of_feats=False): when training, window
    crops (the port's random.Random(seed) against JAX's global random
    seeded alike) of raw flows augmented from the dataset's RandomState(seed),
    item after item; in eval, whole sequences at the stored resolution, not
    augmented. Every field bit for bit."""
    files = _flow_files(tmp_path, n=7)
    rng = np.random.RandomState(6)
    recs = {i: {"seq_name": f"s{i}", "head_qpos": rng.randn(8, 7).astype(np.float32),
                "head_vels": rng.randn(8, 6).astype(np.float32), "of_files": files} for i in range(2)}
    path = tmp_path / "motion.p"
    with open(path, "wb") as fh:
        pickle.dump(recs, fh)
    kw = dict(of_rewrite=("/authors", str(tmp_path)), window=3, train=train, for_eval=not train,
              input_of_feats=False, augment=True, seed=7)
    port, ref = thp.HeadPoseSequenceDataset(str(path), **kw), jhp.HeadPoseSequenceDataset(str(path), **kw)
    random.seed(7)
    for i in (0, 1, 0):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys()
        assert a["of"].shape == ((3, 224, 224, 2) if train else (7, 240, 256, 2))
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
