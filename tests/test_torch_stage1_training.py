"""The port's stage-1 training (HeadNet and GravityNet) against the JAX
package on the CPU, on the same weights (``stage1_state_from_jax``) and
numpy inputs.

Tolerances: losses within 1e-6 relative and their gradients within 1e-5
of each tensor's max (f32 re-association only: the two packages sum in
other orders). After a trainer step, AdamW's moments within 1e-5 of each
tensor's max, and the parameters through the moments, as
tests/test_torch_training.py holds the stage-2 trainer (``_check_step``):
Adam divides by sqrt(v) + 1e-8, so a rounding of a gradient entry near 1e-8
moves that entry by up to lr. The key bias ``w_k.bias`` has a gradient of
rounding noise (the softmax cancels it): held below 1e-6 of the largest
gradient, its moments not compared. Data and schedule values are held
exactly.
"""

import importlib.util
import json
import os
import pathlib
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egoego_release_tpu.data import amass_headpose as jah
from egoego_release_tpu.data.native_loader import load_npy_batch as jload_npy_batch
from egoego_release_tpu.models import gravitynet as jgn
from egoego_release_tpu.models import headnet as jhn
from egoego_release_tpu.training import trainer_stage1 as jts
from egoego_release_tpu_torch.data import amass_headpose as tah
from egoego_release_tpu_torch.data import formats, native_loader
from egoego_release_tpu_torch.eval.build import build_pipeline
from egoego_release_tpu_torch.models import gravitynet as tgn
from egoego_release_tpu_torch.models import headnet as thn
from egoego_release_tpu_torch.models.denoiser import init_weights_
from egoego_release_tpu_torch.models.transformer import set_dropout_rate
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.training import train_stage1
from egoego_release_tpu_torch.training import trainer_stage1 as tts
from egoego_release_tpu_torch.utils.convert import load_stage1_ckpt, stage1_state_from_jax

HEAD = dict(d_model=32, n_layers=1, n_head=2, d_k=16, d_v=16, window=8, cnn_fdim=24, mlp_hsize=(16,))
GRAV = dict(d_model=32, n_layers=1, n_head=2, d_k=16, d_v=16, window=16, mlp_hsize=(16,))
# the CLIs' small widths (Stage1ModelConfig fields) and a small batch
CLI_SETS = ["headnet.d_model=32", "headnet.n_dec_layers=2", "headnet.n_head=2", "headnet.d_k=16", "headnet.d_v=16",
            "headnet.window=8", "gravitynet.d_model=32", "gravitynet.n_dec_layers=2", "gravitynet.n_head=2",
            "gravitynet.d_k=16", "gravitynet.d_v=16", "gravitynet.window=16", "data.batch_size=2", "data.prefetch=2",
            "logging.log_every=1"]


def _chip_smoke():
    """chip_smoke.py as a module (its phases run only under __main__): its
    fixture writers and train_step_agreement."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


def _quats(rng, *shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    q[..., 0] = np.abs(q[..., 0]) + 1.0  # rotations well inside w > 0
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _headnet_batch(rng, b=3, t=8, feat=24):
    return {"of": rng.randn(b, t, feat).astype(np.float32),
            "head_pose": np.concatenate([np.cumsum(rng.randn(b, t + 1, 3) * 0.05, 1), _quats(rng, b, t + 1)],
                                        -1).astype(np.float32),
            "head_vels": (rng.randn(b, t, 6) * 0.5).astype(np.float32),
            "seq_len": np.asarray([t, t - 3, t], np.int64)[:b]}


def synth_head_data(n_seqs=5, t=40, seed=0):
    """{name: {"head_pose": (T, 7)}}: three training sequences (CMU, KIT,
    ACCAD), one held out (HumanEva), one too short (CMU, 20 frames)."""
    rng = np.random.RandomState(seed)
    names = ["CMU-a", "KIT-b", "HumanEva-c", "ACCAD-d", "CMU-short"]
    data = {}
    for i in range(n_seqs):
        n = 20 if names[i].endswith("short") else t + 7 * i
        data[names[i]] = {"head_pose": np.concatenate([np.cumsum(rng.randn(n, 3) * 0.02, 0), _quats(rng, n)],
                                                      -1).astype(np.float32)}
    return data


# -- losses ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_headformer_loss_and_grads_match_jax(seed):
    """headformer_loss (va2rot under autograd) and its gradients in va and
    dist against JAX's (lax.scan)."""
    rng = np.random.RandomState(seed)
    b, t = 3, 12
    va = (rng.randn(b, t, 3) * 0.8).astype(np.float32)
    dist = rng.randn(b, t, 1).astype(np.float32)
    hp = np.concatenate([np.cumsum(rng.randn(b, t + 1, 3) * 0.05, 1), _quats(rng, b, t + 1)], -1).astype(np.float32)
    gv = (rng.randn(b, t, 3) * 0.5).astype(np.float32)
    args = lambda f, a, d: (a, d, f(hp[:, 0, 3:]), f(gv), f(hp[:, :, 3:]), f(hp[:, :, :3]))
    (lj, parts_j), (gva_j, gd_j) = jax.value_and_grad(lambda a, d: jhn.headformer_loss(
        *args(jnp.asarray, a, d)), argnums=(0, 1), has_aux=True)(jnp.asarray(va), jnp.asarray(dist))
    va_t, d_t = torch.tensor(va, requires_grad=True), torch.tensor(dist, requires_grad=True)
    lt, parts_t = thn.headformer_loss(*args(torch.from_numpy, va_t, d_t))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    for a, b_ in zip(parts_t, parts_j):
        assert abs(float(a.detach()) - float(b_)) <= 1e-6 * abs(float(b_)) + 1e-12
    _close(va_t.grad.numpy(), gva_j, 1e-5, "d loss / d va")
    _close(d_t.grad.numpy(), gd_j, 1e-5, "d loss / d dist")


def test_gravitynet_loss_and_grads_match_jax():
    rng = np.random.RandomState(2)
    pred, gt = rng.randn(6, 3).astype(np.float32), rng.randn(6, 3).astype(np.float32)
    lj, gj = jax.value_and_grad(jgn.gravitynet_loss)(jnp.asarray(pred), jnp.asarray(gt))
    p = torch.tensor(pred, requires_grad=True)
    lt = tgn.gravitynet_loss(p, torch.from_numpy(gt))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    _close(p.grad.numpy(), gj, 1e-5, "d loss / d normal")


def test_gravitynet_eval_upper_bound_matches_jax():
    rng = np.random.RandomState(3)
    t = 30
    rot = np.asarray(jnp.asarray(jax.random.orthogonal(jax.random.PRNGKey(0), 3)), np.float32)
    slam_rot = np.asarray(jhn.rot.quat_to_matrix(jnp.asarray(_quats(rng, t))), np.float32)
    slam_trans = np.cumsum(rng.randn(t, 3) * 0.05, 0).astype(np.float32)
    trans0 = rng.randn(3).astype(np.float32)
    want = jgn.gravitynet_eval_upper_bound(jnp.asarray(rot), jnp.asarray(slam_rot), jnp.asarray(slam_trans),
                                           jnp.float32(0.7), jnp.asarray(trans0))
    got = tgn.gravitynet_eval_upper_bound(*(torch.tensor(a) for a in (rot, slam_rot, slam_trans)), 0.7,
                                          torch.from_numpy(trans0))
    for k in ("head_trans", "head_rot_mat", "head_pose"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)


# -- trainers ------------------------------------------------------------------


def _jax_headnet(deterministic_loss):
    model = jhn.HeadFormer(**HEAD)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24)), jnp.ones((1, 8)))

    def loss_fn(model, params, batch, key):  # jts.headnet_loss_fn with dropout off
        mask = jhn.padding_mask_from_len(batch["seq_len"].astype(jnp.float32), model.window)
        va, dist = model.apply(params, batch["of"], mask, deterministic=True)
        hp = batch["head_pose"]
        loss, (ol, vl, dl) = jhn.headformer_loss(va, dist, hp[:, 0, 3:], batch["head_vels"][:, :, 3:],
                                                 hp[:, :, 3:], hp[:, :, :3])
        return loss, {"orient": ol, "va": vl, "dist": dl}

    return model, params, loss_fn if deterministic_loss else jts.headnet_loss_fn


def _jax_gravitynet():
    model = jgn.HeadNormalFormer(**GRAV)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 18)), jnp.ones((1, 16)))

    def loss_fn(model, params, batch, key):  # jts.gravitynet_loss_fn with dropout off
        feats = jgn.slam_traj_features(batch["head_rot_mat"], batch["head_trans"])
        t = feats.shape[1]
        if t < model.window:
            feats = jnp.pad(feats, ((0, 0), (0, model.window - t), (0, 0)))
        mask = (jnp.arange(model.window)[None, :] < (batch["seq_len"] - 1)[:, None]).astype(jnp.float32)
        loss = jgn.gravitynet_loss(model.apply(params, feats, mask, deterministic=True), batch["floor_normal"])
        return loss, {"normal": loss}

    return model, params, loss_fn


def _zero_grad(name):
    return name.endswith("self_attn.w_k.bias")


def _adamw_update(m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    return lr * (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + eps)


def _check_step(jstate, tstate, kind, lr, rel=1e-5):
    """The port's state after a step against JAX's: AdamW moments within
    ``rel`` of each tensor's max; the parameters' difference is the
    difference of the steps each side's moments imply (the weight decay
    term is the same on both sides: they start from one state)."""
    want = stage1_state_from_jax(jstate, kind)
    step = want["adam"]["step"]
    assert tstate.step == step
    for name, p in tstate.model.named_parameters():
        st = tstate.optimizer.state[p]
        assert int(st["step"]) == step
        mt, vt = st["exp_avg"].double(), st["exp_avg_sq"].double()
        mj, vj = want["adam"]["exp_avg"][name].double(), want["adam"]["exp_avg_sq"][name].double()
        if not _zero_grad(name):
            _close(mt, mj, rel, f"mu {name}")
            _close(vt, vj, rel, f"nu {name}")
        d = p.detach().double() - want["model"][name].double()
        implied = _adamw_update(mj, vj, step, lr) - _adamw_update(mt, vt, step, lr)
        err = float((d - implied).abs().max())
        assert err <= rel * float(want["model"][name].abs().max()), f"param {name}: {err}"


def _gravity_batch(seed=0, bs=3):
    ds = tah.AMASSHeadPoseDataset(synth_head_data(seed=seed), train=True, window=16, seed=seed)
    random.seed(seed)
    return next(ds.batch_iterator(bs))


def _trainer_steps(kind, jax_optimizer, optimizer, steps=3):
    """``steps`` steps of Stage1Trainer against JAX's with dropout off, each
    from JAX's state before it (stage1_state_from_jax): loss, AdamW moments
    and parameters. Returns the gradients' global norms."""
    if kind == "headnet":
        model, params, jloss = _jax_headnet(True)
        tmodel = lambda: thn.HeadFormer(**HEAD)
        tloss = tts.headnet_loss_fn
        batch = _headnet_batch(np.random.RandomState(4))
    else:
        model, params, jloss = _jax_gravitynet()
        tmodel = lambda: tgn.HeadNormalFormer(**GRAV)
        tloss = tts.gravitynet_loss_fn
        batch = {k: v.astype(np.int64 if k == "seq_len" else np.float32) for k, v in _gravity_batch().items()}
    jt = jts.Stage1Trainer(model, jloss, jax_optimizer)
    jstate = jt.init_state(params)
    trainer = tts.Stage1Trainer(tloss, optimizer)
    norms = []
    for i in range(steps):
        tstate = trainer.state_from_dict(tmodel(), stage1_state_from_jax(jstate, kind))
        set_dropout_rate(tstate.model, 0.0)
        grads = jax.grad(lambda p: jloss(model, p, {k: jnp.asarray(v) for k, v in batch.items()}, None)[0])(
            jstate.params)
        norms.append(float(optax.global_norm(grads)))
        jstate, jl, _ = jt.train_step(jstate, batch, jax.random.PRNGKey(i))
        tstate, tl, aux = trainer.train_step(tstate, batch, TorchNoise("cpu", i))
        assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
        _check_step(jstate, tstate, kind, lr=trainer.optimizer.learning_rate(i))
    return norms


@pytest.mark.parametrize("kind", ["headnet", "gravitynet"])
def test_trainer_steps_match_jax(kind):
    """Stage1Trainer against JAX's, three steps with dropout off. The
    schedule decays at step 2 (2 epochs of 1 step) and the gradients are
    clipped (their global norm exceeds 1)."""
    norms = _trainer_steps(kind, jts.make_optimizer(1e-3, 2, 0.3, 1), tts.make_optimizer(1e-3, 2, 0.3, 1))
    assert max(norms) > 1.0, norms  # the clip acted


def _optax_stage1(lr, transition_steps, gamma, weight_decay):
    """JAX's make_optimizer with another weight decay than optax's default."""
    schedule = optax.exponential_decay(init_value=lr, transition_steps=transition_steps, decay_rate=gamma,
                                       staircase=True)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule, weight_decay=weight_decay))


@pytest.mark.parametrize("kind", ["headnet", "gravitynet"])
def test_trainer_weight_decay_matches_optax(kind):
    """Two steps at a weight decay of 0.1 and lr 1e-2: decoupled decay moves
    a parameter by 1e-3 of itself a step, a hundred times the parameter
    check's 1e-5 of each tensor's max, so a decay missing, coupled into
    the gradient or taken at another rate than optax's fails it."""
    _trainer_steps(kind, _optax_stage1(1e-2, 2, 0.3, 0.1), tts.make_optimizer(1e-2, 2, 0.3, 1, weight_decay=0.1),
                   steps=2)


@pytest.mark.parametrize("kind", ["headnet", "gravitynet"])
def test_loss_fn_gradients_match_jax(kind):
    """The trainers' loss closures (dropout off) and their parameter
    gradients against JAX's on one state."""
    if kind == "headnet":
        model, params, jloss = _jax_headnet(True)
        tm, tloss, batch = thn.HeadFormer(**HEAD), tts.headnet_loss_fn, _headnet_batch(np.random.RandomState(5))
    else:
        model, params, jloss = _jax_gravitynet()
        tm, tloss, batch = tgn.HeadNormalFormer(**GRAV), tts.gravitynet_loss_fn, _gravity_batch(seed=1)
    (lj, _), gj = jax.value_and_grad(lambda p: jloss(model, p, {k: jnp.asarray(v) for k, v in batch.items()}, None),
                                     has_aux=True)(params)
    state = tts.Stage1Trainer(tloss, tts.make_optimizer(1e-3, 1)).state_from_dict(
        tm, stage1_state_from_jax(jts.Stage1State(params, jts.make_optimizer(1e-3, 1).init(params), 0), kind))
    set_dropout_rate(state.model, 0.0)
    tb = {k: torch.as_tensor(v).long() if k == "seq_len" else torch.as_tensor(v).float() for k, v in batch.items()}
    lt, _ = tloss(state.model.train(), tb)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    want = stage1_state_from_jax(jts.Stage1State(gj, jts.make_optimizer(1e-3, 1).init(params), 0), kind)["model"]
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in state.model.named_parameters():
        if _zero_grad(name):
            assert float((p.grad - want[name]).abs().max()) <= 1e-6 * top, name
        else:
            _close(p.grad.numpy(), want[name].numpy(), 1e-5, name)


@pytest.mark.parametrize("count", [0, 1, 9, 10, 11, 29, 30, 31, 45])
def test_learning_rate_matches_optax_schedule(count):
    """make_optimizer's rate at optimizer step ``count`` (steps_per_epoch 5,
    StepLR step 2 epochs: a decay every 10 steps) against optax's."""
    sched = optax.exponential_decay(1e-3, transition_steps=10, decay_rate=0.3, staircase=True)
    lr = tts.make_optimizer(1e-3, 2, 0.3, steps_per_epoch=5).learning_rate(count)
    assert abs(lr - float(sched(count))) <= 1e-6 * float(sched(count))


@pytest.mark.parametrize("scale", [0.01, 0.5, 3.0, 100.0])
def test_clip_matches_optax(scale):
    """The global-norm clip against optax.clip_by_global_norm(1.0): below
    the norm the gradients stay as they are, bit for bit; above it they are
    scaled to norm 1."""
    rng = np.random.RandomState(6)
    grads = [(rng.randn(*s) * scale).astype(np.float32) for s in ((4, 5), (7,), (2, 3, 3))]
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tts.make_optimizer(1e-3, 1).clip_(got)
    assert abs(float(norm) - float(optax.global_norm([jnp.asarray(g) for g in grads]))) <= 1e-6 * float(norm)
    for g, w, g0 in zip(got, want, grads):
        if float(norm) < 1.0:
            np.testing.assert_array_equal(g.numpy(), g0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7, atol=0)


def test_adamw_weight_decay_is_optax_default():
    opt = tts.make_optimizer(1e-3, 1).init([torch.nn.Parameter(torch.zeros(3))])
    assert opt.param_groups[0]["weight_decay"] == 1e-4


# -- data --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_augment_head_traj_matches_jax(seed):
    pose = synth_head_data()["KIT-b"]["head_pose"]
    a = tah.augment_head_traj(pose, np.random.RandomState(seed))
    b = jah.augment_head_traj(pose, np.random.RandomState(seed))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("train,window", [(True, 16), (True, 40), (False, 40)])
def test_amass_headpose_batches_match_jax(train, window):
    """AMASSHeadPoseDataset: the same split, items and batches as JAX's
    from the same seeds (the crop from Python's random, the rest from the
    dataset's RandomState), element for element; at window 16 every
    sequence is cropped, at window 40 the 40-frame one is padded."""
    data = synth_head_data()
    a = tah.AMASSHeadPoseDataset(data, train=train, window=window, seed=2)
    b = jah.AMASSHeadPoseDataset(data, train=train, window=window, seed=2)
    assert a.names == b.names and len(a) == (3 if train else 1)
    its = a.batch_iterator(2 if train else 1), b.batch_iterator(2 if train else 1)
    for _ in range(4):
        random.seed(5)
        ba = next(its[0])
        random.seed(5)
        bb = next(its[1])
        assert ba.keys() == bb.keys() and "seq_name" not in ba
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k], err_msg=k)
    assert ba["head_trans"].shape[1:] == (window + 1, 3)
    if window == 40 and train:
        item = a[a.names.index("CMU-a")]
        assert item["seq_len"] == 40 and not item["head_trans"][40:].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_load_npy_batch_matches_np_load(tmp_path, dtype):
    """The native loader reads f4 and f8 npy files as np.load does (f8 to
    f32), through the library it built, not numpy."""
    rng = np.random.RandomState(7)
    paths = []
    for i in range(11):
        p = tmp_path / f"{i}.npy"
        np.save(p, rng.randn(2, 256).astype(dtype))
        paths.append(str(p))
    native_loader.counts.clear()
    got = native_loader.load_npy_batch(paths, 512, n_threads=3)
    want = np.stack([np.load(p).reshape(-1).astype(np.float32) for p in paths])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jload_npy_batch(paths, 512))
    assert dict(native_loader.counts) == {"native": 1}
    assert native_loader.LIBRARY.exists() and native_loader.LIBRARY.parent.name == "native"


def test_load_npy_batch_missing_file_raises_as_jax(tmp_path):
    """A missing file raises numpy's FileNotFoundError, as in JAX (the
    native loader reports the file and numpy reads the batch again)."""
    p = tmp_path / "0.npy"
    np.save(p, np.zeros(512, np.float32))
    paths = [str(p), str(tmp_path / "missing.npy")]
    with pytest.raises(FileNotFoundError) as port_err:
        native_loader.load_npy_batch(paths, 512)
    with pytest.raises(FileNotFoundError) as jax_err:
        jload_npy_batch(paths, 512)
    assert "missing.npy" in str(port_err.value) and "missing.npy" in str(jax_err.value)


def test_load_of_feats_reads_through_the_native_loader(tmp_path):
    """formats.load_of_feats rewrites the stored paths (raft_flows ->
    raft_of_feats, the data root) and reads them through the native loader."""
    feat_dir = tmp_path / "seq" / "raft_of_feats"
    feat_dir.mkdir(parents=True)
    rng = np.random.RandomState(8)
    feats = rng.randn(5, 512).astype(np.float32)
    for i in range(5):
        np.save(feat_dir / f"{i}.npy", feats[i])
    native_loader.counts.clear()
    got = formats.load_of_feats([f"/authors/seq/raft_flows/{i}.npy" for i in range(5)],
                                rewrite=("/authors", str(tmp_path)))
    np.testing.assert_array_equal(got, feats)
    assert native_loader.counts["native"] == 1


# -- the CLIs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """An ARES-layout root (6 sequences of 11 OF frames) and a head-motion
    pickle (6 tracks), written by chip_smoke's writers."""
    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("stage1")
    ares = root / "ares_root"
    cs.write_ares_fixture(str(ares), np.random.RandomState(0), 6, 11, feat_dim=512)
    motion = root / "head_motion.p"
    cs.write_head_motion(str(motion), np.random.RandomState(1), 6, lengths=(31, 45))
    stats = root / "stats.p"
    with open(stats, "wb") as fh:
        pickle.dump({"global_jpos_min": np.full((22, 3), -1.5, np.float32),
                     "global_jpos_max": np.full((22, 3), 1.5, np.float32)}, fh)
    rest = root / "rest.npy"
    np.save(rest, np.random.RandomState(2).uniform(-0.2, 0.2, (22, 3)).astype(np.float32))
    return cs, root, ares, motion, stats, rest


@pytest.fixture(scope="module")
def trained(fixtures):
    """Both CLIs on the CPU for two epochs on the fixtures (prefetch thread
    on, the OF features counted by loader path): {kind: (state, weights
    dir)}, and the loader's counts during the HeadNet run."""
    _, root, ares, motion, _, _ = fixtures
    save = root / "runs"
    runs = {}
    native_loader.counts.clear()
    for kind, argv in (("headnet", ["headnet", "--dataset", "ares", "--data_root_folder", str(ares)]),
                       ("gravitynet", ["gravitynet", "--motion_path", str(motion)])):
        state = train_stage1.main(argv + ["--epochs", "2", "--device", "cpu", "--set", *CLI_SETS,
                                          f"logging.save_dir={save}", f"logging.exp_name={kind}"])
        runs[kind] = (state, save / kind)
        if kind == "headnet":
            runs["loader"] = dict(native_loader.counts)
    return runs


@pytest.mark.parametrize("kind", ["headnet", "gravitynet"])
def test_train_stage1_cli_on_cpu(trained, kind):
    """train_stage1 on the fixtures, two epochs of 3 steps (6 sequences,
    batch 2): finite losses logged every step, epoch-0.pt and epoch-1.pt in
    the reference's layout, which load_stage1_ckpt reads back as the trained
    weights; HeadNet's OF features through the native loader."""
    state, run = trained[kind]
    assert state.epoch == 2 and state.step == 6
    logged = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert len(logged) == 6 and all(np.isfinite(r["loss"]) for r in logged)
    assert sorted(os.listdir(run / "weights")) == ["epoch-0.pt", "epoch-1.pt"]
    ckpt = torch.load(run / "weights" / "epoch-1.pt", weights_only=True)
    assert set(ckpt) == {"transformer_encoder_state_dict", "optimizer_state_dict", "epoch"} and ckpt["epoch"] == 1
    sd = load_stage1_ckpt(str(run / "weights" / "epoch-1.pt"), kind, 2, d_model=32, n_head=2, d_k=16, d_v=16)
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    if kind == "headnet":
        assert trained["loader"]["native"] >= 6 and "numpy" not in trained["loader"]


def test_trained_checkpoints_load_into_the_eval_pipeline(fixtures, trained):
    """The CLIs' epoch-<n>.pt are what build_pipeline (eval_egoego
    --headnet_ckpt / --gravitynet_ckpt) loads, as they are."""
    _, _, _, _, stats, rest = fixtures
    ckpt = {kind: trained[kind][1] / "weights" / "epoch-1.pt" for kind in ("headnet", "gravitynet")}
    pipe = build_pipeline(stats_path=str(stats), rest_offsets_path=str(rest), device="cpu",
                          headnet_ckpt=str(ckpt["headnet"]), gravitynet_ckpt=str(ckpt["gravitynet"]),
                          headnet_window=8, headnet_d_model=32, gravitynet_d_model=32, n_head=2, d_k=16, d_v=16,
                          timesteps=2)
    for kind, model in (("headnet", pipe.headnet), ("gravitynet", pipe.gravitynet)):
        want = torch.load(ckpt[kind], weights_only=True)["transformer_encoder_state_dict"]
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (kind, k)


def test_raw_flow_raises_not_implemented(fixtures):
    _, root, ares, _, _, _ = fixtures
    with pytest.raises(NotImplementedError, match="A.7"):
        train_stage1.main(["headnet", "--dataset", "ares", "--data_root_folder", str(ares), "--raw_flow",
                           "--device", "cpu", "--set", f"logging.save_dir={root / 'raw'}"])


def test_stage1_cli_needs_cuda_unless_cpu(fixtures, monkeypatch):
    """The CLIs run on the card by default and raise without one."""
    _, root, _, motion, _, _ = fixtures
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_stage1.main(["gravitynet", "--motion_path", str(motion), "--epochs", "1", "--set", *CLI_SETS,
                           f"logging.save_dir={root / 'nocuda'}"])


@pytest.mark.parametrize("kind", ["headnet", "gravitynet"])
def test_train_step_agreement_holds_a_stage1_trainer(fixtures, kind):
    """chip_smoke.train_step_agreement (phase 13's card/CPU check) on a
    stage-1 trainer, CPU against CPU: every bounded measure holds, and two
    sides that are one computation agree exactly."""
    cs = fixtures[0]
    if kind == "headnet":
        batch = _headnet_batch(np.random.RandomState(9), feat=24)
        new = lambda: thn.HeadFormer(**HEAD)
        loss_fn, lr_step = tts.headnet_loss_fn, 1000
    else:
        batch = _gravity_batch(seed=2)
        new = lambda: tgn.HeadNormalFormer(**GRAV)
        loss_fn, lr_step = tts.gravitynet_loss_fn, 2000

    def make_state(where):
        trainer = tts.Stage1Trainer(loss_fn, tts.make_optimizer(1e-4, lr_step, 0.3, 10))
        state = trainer.init_state(init_weights_(new(), torch.Generator().manual_seed(0)).to(where))
        set_dropout_rate(state.model, 0.0)
        return trainer, state

    m = cs.train_step_agreement(make_state, batch, 1, torch.device("cpu"), gradients64=cs.stage1_gradients64,
                                adam=lambda tr: (tr.optimizer.learning_rate(0), tr.optimizer.weight_decay))
    assert all(m[k] <= cs.STEP_BOUNDS[k] for k in cs.STEP_BOUNDS), m
    assert m["flips"] == m["forced"] == 0 and m["loss"] == m["grad"] == m["param"] == 0
    assert m["grad64"] == m["grad64_cpu"] > 0
