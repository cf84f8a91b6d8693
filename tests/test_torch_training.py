"""The port's stage-2 training against the JAX package on the CPU, on the
same weights (``denoiser_state_dict_from_jax``) and numpy inputs, with the
JAX key stream replayed through the port's noise-source calls.

Tolerances: the loss within 1e-6 relative; gradients and, after a
trainer step, Adam's moments within 1e-5 of each tensor's max (f32
re-association only: the two packages sum in other orders). Parameters
after a step are held through the moments (``_check_step``): Adam divides
by sqrt(v) + 1e-8, so a rounding of a gradient entry near 1e-8 moves that
entry by up to lr. Checkpoint resume is held bit for bit.

One tensor is held otherwise: the key bias ``w_k.bias``. Its gradient is
zero in exact arithmetic (it adds q.b to every score of a query, which the
softmax cancels), so both packages' gradients are rounding noise, held
below 1e-6 of the largest gradient, and its moments are not compared.
"""

import json
import os
import pickle
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from egoego_release_tpu.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion as JDiffusion,
    DiffusionConfig as JConfig,
    head_condition_mask as jhead_mask,
)
from egoego_release_tpu.training.ema import ema_update as jema_update
from egoego_release_tpu.training.trainer_diffusion import DiffusionTrainer as JTrainer
from egoego_release_tpu.utils import config as jconfig
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    head_condition_mask,
    new_denoiser,
)
from egoego_release_tpu_torch.eval import eval_stage2
from egoego_release_tpu_torch.models.transformer import set_dropout_rate
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.training import train_diffusion
from egoego_release_tpu_torch.training.ema import ema_update
from egoego_release_tpu_torch.training.trainer_diffusion import (
    DiffusionTrainer,
    load_checkpoint,
    restore_state,
    save_checkpoint,
)
from egoego_release_tpu_torch.utils import config as tconfig
from egoego_release_tpu_torch.utils.convert import (
    denoiser_state_dict_from_jax,
    load_denoiser_weights,
    load_stage2_diffusion_ckpt,
    trainer_state_from_jax,
)
from egoego_release_tpu_torch.utils.logging import MetricLogger, profile_trace, save_run_config

SMALL = dict(d_feats=198, d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=12, timesteps=8)


def _np(a):
    return torch.from_numpy(np.array(a, np.float32))


class LossKeys:
    """One p_losses call's draws from a JAX key: split(key, 4) -> t, noise,
    condition noise, dropout (diffusion/gaussian_diffusion.py:195)."""

    def __init__(self, key):
        self.k = jax.random.split(key, 4)

    def randint(self, n, high):
        return torch.from_numpy(np.asarray(jax.random.randint(self.k[0], (n,), 0, high)).astype(np.int64))

    def step(self, shape):
        return _np(jax.random.normal(self.k[1], tuple(shape), jnp.float32))

    def cond(self, shape):
        return _np(jax.random.normal(self.k[2], tuple(shape), jnp.float32))

    def dropout_seed(self):
        return 0


class StepKeys:
    """One optimizer step's key: split(key, grad_accum), one per micro-batch
    (training/trainer_diffusion.py:89)."""

    def __init__(self, key):
        self.key = key

    def split(self, k):
        return [LossKeys(sk) for sk in jax.random.split(self.key, k)]


class DeviceStepKeys(StepKeys):
    """The device-resident step's key: split(key) -> the window indices'
    key (randint straight from it) and the step's (trainer_diffusion.py:154)."""

    def split(self, k):
        k_idx, k_step = jax.random.split(self.key)
        idx = StepKeys(k_idx)
        idx.randint = lambda n, high: torch.from_numpy(
            np.asarray(jax.random.randint(k_idx, (n,), 0, high)).astype(np.int64))
        return [idx, StepKeys(k_step)]


def _pair(**kw):
    """The JAX diffusion with its params and the port's, same weights."""
    jdiff = JDiffusion(JConfig(**SMALL, **kw))
    params = jdiff.init_params(jax.random.PRNGKey(0))
    tdiff = CondGaussianDiffusion(DiffusionConfig(**SMALL, **kw, compute_dtype="float32"), device="cpu")
    model = load_denoiser_weights(new_denoiser(tdiff.cfg), denoiser_state_dict_from_jax(params))
    return jdiff, params, tdiff, model


def _batch(bs=4, t=12, seed=0, seq_len=None):
    rng = np.random.RandomState(seed)
    motion = rng.uniform(-1, 1, (bs, t, 198)).astype(np.float32)
    seq_len = np.full((bs,), t, np.int32) if seq_len is None else np.asarray(seq_len, np.int32)
    for i, n in enumerate(seq_len):
        motion[i, n:] = 0.0  # padded frames are zero, as the dataset writes them
    return {"motion": motion, "seq_len": seq_len}


def _pad(seq_len, t):
    return (np.arange(t + 1)[None, :] < (np.asarray(seq_len) + 1)[:, None]).astype(np.float32)[:, None, :]


def _zero_grad(key):
    return key.endswith("self_attn.w_k.bias")


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("objective", ["pred_x0", "pred_noise"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses_and_grads_match_jax(loss_type, objective, padded):
    """train=False: loss within 1e-6 relative, every gradient (by state_dict
    key, the JAX gradient tree through the same converter) within 1e-5 of
    its max|g|."""
    jdiff, params, tdiff, model = _pair(objective=objective, loss_type=loss_type)
    b = _batch(seq_len=[12, 7, 12, 3] if padded else None)
    pad = _pad(b["seq_len"], 12) if padded else None
    key = jax.random.PRNGKey(3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jdiff.p_losses(p, key, jnp.asarray(b["motion"]), jhead_mask(4, 12),
                                 None if pad is None else jnp.asarray(pad)))(params)
    tloss = tdiff.p_losses(model, torch.from_numpy(b["motion"]), head_condition_mask(4, 12),
                           None if pad is None else torch.from_numpy(pad), noise=LossKeys(key))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = denoiser_state_dict_from_jax(jgrads)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    g_max = max(float(v.abs().max()) for v in want.values())
    for k in want:
        if _zero_grad(k):
            assert max(float(got[k].abs().max()), float(want[k].abs().max())) < 1e-6 * g_max, k
        else:
            _close(got[k], want[k], 1e-5, k)


def test_dropout_only_in_train_mode():
    """Rate 0: train mode equals eval mode exactly. Rate 0.1: train mode
    differs, and repeats from one noise seed (the dropout seed comes from
    the source's generator)."""
    _, _, tdiff, model = _pair()
    x = torch.from_numpy(_batch()["motion"])
    mask = head_condition_mask(4, 12)
    loss = lambda train, seed: float(tdiff.p_losses(model, x, mask, noise=TorchNoise("cpu", seed), train=train))
    with torch.no_grad():
        set_dropout_rate(model, 0.0)
        assert loss(True, 5) == loss(False, 5)
        set_dropout_rate(model, 0.1)
        assert loss(True, 5) != loss(False, 5)
        assert loss(True, 5) == loss(True, 5)
        assert loss(True, 6) != loss(True, 5)
        assert model.training
        loss(False, 5)
    assert not model.training


def test_modules_built_in_eval_mode_stay_deterministic():
    """A freshly built model (nn.Module starts in train mode) computes as
    in eval mode: its dropouts are off until model.train()."""
    model = new_denoiser(DiffusionConfig(**SMALL))
    src, t = torch.randn(2, 12, 2 * 198), torch.tensor([1, 5])
    with torch.no_grad():
        a, b = model(src, t), model(src, t)
        model.train()
        c = model(src, t)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("train", [False, True])
def test_remat_keeps_loss_and_grads(train):
    """Decoder(remat=True) recomputes each layer in the backward pass; loss
    and gradients equal remat off, with dropout on too (the recompute
    replays the forward's RNG state)."""
    _, _, tdiff, model = _pair()
    x = torch.from_numpy(_batch()["motion"])
    out = []
    for remat in (False, True):
        model.motion_transformer.remat = remat
        model.zero_grad()
        loss = tdiff.p_losses(model, x, head_condition_mask(4, 12), noise=TorchNoise("cpu", 2), train=train)
        loss.backward()
        out.append((loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=1e-6, atol=1e-7, msg=k)


def _jax_trainer(jdiff, **kw):
    """The JAX trainer with its loss at train=False (dropout off), patched
    on the instance before the step is first traced."""
    jt = JTrainer(jdiff, **kw)
    jt._loss = lambda params, key, motion, pad: jdiff.p_losses(
        params, key, motion, jhead_mask(motion.shape[0], motion.shape[1]), pad, train=False)
    return jt


def _adam_update(m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The step Adam takes from moments m, v at count ``step``, in float64."""
    return lr * (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + eps)


def _check_step(jstate, tstate, lr, rel=1e-5):
    """The port's state after a step against JAX's. Adam moments within
    ``rel`` of each tensor's max. The parameters: their difference is the
    difference of the steps each side's own moments imply (Adam divides by
    sqrt(v) + 1e-8, so a rounding dg of a gradient entry near 1e-8 moves
    that entry by up to lr dg / 1e-8, far past ``rel``), within ``rel`` of
    max|p|. The EMA, a convex combination of its old value (the same on
    both sides) and the parameters, differs by no more than they do."""
    want = trainer_state_from_jax(jstate)
    step = want["adam"]["step"]
    params = {k[len("denoise_fn."):]: v.double() for k, v in want["model"].items()}
    emas = {k[len("ema_model.denoise_fn."):]: v.double() for k, v in want["ema"].items()}
    got_ema = dict(tstate.ema.named_parameters())
    for name, p in tstate.model.named_parameters():
        st = tstate.optimizer.state[p]
        assert int(st["step"]) == step
        mt, vt = st["exp_avg"].double(), st["exp_avg_sq"].double()
        mj, vj = want["adam"]["exp_avg"][name].double(), want["adam"]["exp_avg_sq"][name].double()
        if not _zero_grad(name):
            _close(mt, mj, rel, f"mu {name}")
            _close(vt, vj, rel, f"nu {name}")
        d = p.detach().double() - params[name]
        implied = _adam_update(mj, vj, step, lr) - _adam_update(mt, vt, step, lr)
        err = float((d - implied).abs().max())
        assert err <= rel * float(params[name].abs().max()), f"param {name}: {err}"
        de = (got_ema[name].detach().double() - emas[name]).abs()
        assert bool((de <= d.abs() + rel * float(emas[name].abs().max())).all()), f"ema {name}"
    assert tstate.step == want["step"] and int(tstate.nan_count) == want["nan_count"]


def test_trainer_steps_match_jax():
    """DiffusionTrainer on trainer_state_from_jax, 4 steps with JAX's keys
    replayed (grad-accum 2, padded windows; the EMA skips steps 1 and 3,
    copies at step 2 and blends at step 4). Each step starts from JAX's state before
    it, so each is held alone (``_check_step``): Adam feeds any difference
    back into the next step's gradients."""
    jdiff, _, tdiff, _ = _pair()
    kw = dict(lr=1e-3, grad_accum=2, ema_update_every=2, ema_step_start=3)
    jt = _jax_trainer(jdiff, **kw)
    jstate = jt.init_state(jax.random.PRNGKey(0))
    trainer = DiffusionTrainer(tdiff, **kw)
    b = _batch(seq_len=[12, 9, 5, 12])
    for i in range(4):
        key = jax.random.PRNGKey(10 + i)
        tstate = trainer.state_from_dict(trainer_state_from_jax(jstate))
        set_dropout_rate(tstate.model, 0.0)
        jstate, jloss = jt.train_step(jstate, b, key)
        tstate, tloss = trainer.train_step(tstate, b, StepKeys(key))
        assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
        _check_step(jstate, tstate, lr=1e-3)


def test_device_resident_step_matches_jax_and_host_path():
    """_train_step_device gathers the batch from the bank with indices drawn
    from the key's first half (JAX's split), and equals the host step on
    the batch those indices pick."""
    jdiff, _, tdiff, _ = _pair()
    jt = _jax_trainer(jdiff, lr=1e-3)
    rng = np.random.RandomState(1)
    data = rng.uniform(-1, 1, (10, 12, 198)).astype(np.float32)
    seq_lens = rng.randint(5, 13, 10).astype(np.int32)
    key = jax.random.PRNGKey(5)
    jstate = jt.init_state(jax.random.PRNGKey(0))
    trainer = DiffusionTrainer(tdiff, lr=1e-3)
    ckpt = trainer_state_from_jax(jstate)
    jstate, _ = jt._train_step_device(jstate, jnp.asarray(data), jnp.asarray(seq_lens), key, 4)

    tstate = trainer.state_from_dict(ckpt)
    set_dropout_rate(tstate.model, 0.0)
    tstate, loss_d = trainer._train_step_device(tstate, torch.from_numpy(data), torch.from_numpy(seq_lens).long(),
                                                DeviceStepKeys(key), 4)
    _check_step(jstate, tstate, lr=1e-3)

    k_idx, k_step = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_idx, (4,), 0, 10))
    hstate = trainer.state_from_dict(ckpt)
    set_dropout_rate(hstate.model, 0.0)
    hstate, loss_h = trainer.train_step(hstate, {"motion": data[idx], "seq_len": seq_lens[idx]}, StepKeys(k_step))
    assert float(loss_h) == float(loss_d)
    for (k, a), b in zip(hstate.model.state_dict().items(), tstate.model.state_dict().values()):
        assert torch.equal(a, b), k


def _nan_trainer(**kw):
    _, _, tdiff, model = _pair()
    trainer = DiffusionTrainer(tdiff, lr=1e-3, **kw)
    return trainer, trainer.state_from_dict({
        "step": 0, "model": {"denoise_fn." + k: v for k, v in model.state_dict().items()},
        "ema": {"ema_model.denoise_fn." + k: v for k, v in model.state_dict().items()},
        "adam": {"step": 0, "exp_avg": {k: torch.zeros_like(v) for k, v in model.state_dict().items()},
                 "exp_avg_sq": {k: torch.zeros_like(v) for k, v in model.state_dict().items()}},
        "nan_count": 0})


def test_nan_batch_skipped_to_jax_letter():
    """A non-finite batch after a good step: params and the Adam state
    (moments and its own step count) stay; step and nan_count advance; the
    EMA update still runs at the new step (here a blend toward the
    unchanged params)."""
    trainer, state = _nan_trainer(ema_update_every=1, ema_step_start=0)
    state, _ = trainer.train_step(state, _batch(), TorchNoise("cpu", 1))
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    ema = [e.clone() for e in state.ema.parameters()]
    adam = {k: {n: t.clone() for n, t in state.optimizer.state[p].items()}
            for k, p in state.model.named_parameters()}
    bad = _batch()
    bad["motion"][0, 0, 0] = np.nan
    state, loss = trainer.train_step(state, bad, TorchNoise("cpu", 2))
    assert not np.isfinite(float(loss))
    assert state.step == 2 and int(state.nan_count) == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, p in state.model.named_parameters():
        for n, t in state.optimizer.state[p].items():
            assert torch.equal(t, adam[k][n]), (k, n)
    ema_update(ema, [params[k] for k, _ in state.model.named_parameters()], 2, 0.995, 1, 0)
    for got, want in zip(state.ema.parameters(), ema):
        assert torch.equal(got, want)
    # the next good step updates again, from the kept state
    state, loss = trainer.train_step(state, _batch(), TorchNoise("cpu", 3))
    assert np.isfinite(float(loss)) and int(state.optimizer.state[next(state.model.parameters())]["step"]) == 2


@pytest.mark.parametrize("step,every,start", [(10, 10, 2000), (7, 10, 2000), (2000, 10, 2000),
                                              (2010, 10, 2000), (3, 1, 2)])
def test_ema_update_matches_jax(step, every, start):
    """Copy before step_start_ema, blend after it, nothing off the
    update_every grid."""
    rng = np.random.RandomState(step)
    e, p = rng.randn(2, 5, 3).astype(np.float32)
    want = jema_update({"a": jnp.asarray(e)}, {"a": jnp.asarray(p)}, jnp.int32(step), 0.995, every, start)["a"]
    got = [torch.from_numpy(e.copy())]
    ema_update(got, [torch.from_numpy(p)], step, 0.995, every, start)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-7)


def test_ema_is_copy_during_warmup():
    trainer, state = _nan_trainer(ema_step_start=1000, ema_update_every=1)
    state, _ = trainer.train_step(state, _batch(), TorchNoise("cpu", 3))
    for p, e in zip(state.model.parameters(), state.ema.parameters()):
        assert torch.equal(p, e)


def test_train_step_reduces_loss():
    trainer, state = _nan_trainer()
    noise = TorchNoise("cpu", 1)
    losses = []
    for _ in range(30):
        state, loss = trainer.train_step(state, _batch(), noise)
        losses.append(float(loss))
    assert state.step == 30 and int(state.nan_count) == 0 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_checkpoint_resume_is_exact(tmp_path):
    """3 steps, save, restore, 2 steps == 5 steps straight, bit for bit."""
    trainer, state = _nan_trainer(ema_update_every=1, ema_step_start=2)
    noises = [TorchNoise("cpu", 20 + i) for i in range(5)]
    for i in range(3):
        state, _ = trainer.train_step(state, _batch(seed=i), noises[i])
    path = save_checkpoint(str(tmp_path), state)
    assert path.endswith("model-3.pt") and load_checkpoint(path)["step"] == 3
    resumed = restore_state(path, trainer)
    for i in range(3, 5):
        state, l_cont = trainer.train_step(state, _batch(seed=i), noises[i])
        resumed, l_res = trainer.train_step(resumed, _batch(seed=i), TorchNoise("cpu", 20 + i))
        assert float(l_cont) == float(l_res)
    assert resumed.step == 5
    for a, b in zip(state.model.state_dict().values(), resumed.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(state.ema.state_dict().values(), resumed.ema.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(state.model.parameters(), resumed.model.parameters()):
        for n in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][n], resumed.optimizer.state[q][n])


def _amass(tmp_path, lengths=(50, 70), seed=0):
    rng = np.random.RandomState(seed)
    data = {}
    for i, t in enumerate(lengths):
        data[i] = {"trans": np.cumsum(rng.uniform(-0.01, 0.01, (t, 3)), 0).astype(np.float32),
                   "root_orient": rng.uniform(-0.1, 0.1, (t, 3)).astype(np.float32),
                   "body_pose": rng.uniform(-0.2, 0.2, (t, 63)).astype(np.float32),
                   "seq_name": f"HumanEva-s{i}"}
    paths = {k: str(tmp_path / k) for k in ("train.p", "rest.npy", "runs")}
    with open(paths["train.p"], "wb") as f:
        pickle.dump(data, f)
    np.save(paths["rest.npy"], np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32))
    return paths


def _cli_overrides(paths, exp="run", **extra):
    ov = {"stage2.d_model": 16, "stage2.n_dec_layers": 2, "stage2.d_k": 8, "stage2.d_v": 8,
          "stage2.timesteps": 4, "stage2.window": 40, "data.window": 40, "data.batch_size": 2,
          "data.prefetch": 0, "train.num_steps": 3, "train.grad_accum": 1, "train.save_every": 3,
          "train.ema_step_start": 0, "data.rest_offsets": paths["rest.npy"],
          "logging.save_dir": paths["runs"], "logging.exp_name": exp, "logging.log_every": 1}
    ov.update(extra)
    return [f"{k}={v}" for k, v in ov.items()]


def test_train_cli_auto_resume_on_cpu(tmp_path):
    """train_diffusion --device cpu writes model-3.pt, opt.yaml and the
    JSONL log; a second launch resumes at step 3 and stops at model-6.pt;
    --sample then draws from model-6's EMA weights."""
    paths = _amass(tmp_path)
    argv = ["--train_data_path", paths["train.p"], "--device", "cpu", "--set", *_cli_overrides(paths)]
    assert train_diffusion.main(argv).step == 3
    weights = os.path.join(paths["runs"], "run", "weights")
    assert train_diffusion.latest_checkpoint(weights).endswith("model-3.pt")
    state = train_diffusion.main(argv)
    assert state.step == 6 and train_diffusion.latest_checkpoint(weights).endswith("model-6.pt")
    log = [json.loads(line) for line in open(os.path.join(paths["runs"], "run", "metrics.jsonl"))]
    assert [r["step"] for r in log] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) and r["nan_count"] == 0 for r in log)
    assert tconfig.load_config(os.path.join(paths["runs"], "run", "opt.yaml")).stage2.d_model == 16
    out = train_diffusion.main(["--sample", "--device", "cpu", "--set", *_cli_overrides(paths)])
    assert out.shape == (4, 40, 198) and torch.isfinite(out).all()
    assert int(np.load(os.path.join(paths["runs"], "run", "samples.npz"))["step"]) == 6


def test_train_cli_iterator_path_and_stop_signal(tmp_path, monkeypatch):
    """data.device_resident=false with prefetch 2 trains from the host
    iterator; a SIGTERM mid-run checkpoints at that step and stops."""
    paths = _amass(tmp_path)
    cfg = tconfig.load_config(overrides=_cli_overrides(
        paths, exp="it", **{"data.device_resident": "false", "data.prefetch": 2, "train.num_steps": 10,
                            "train.save_every": 100}))
    real = DiffusionTrainer.train_step

    def step_then_signal(self, state, batch, noise):
        out = real(self, state, batch, noise)
        if out[0].step == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(DiffusionTrainer, "train_step", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    state = train_diffusion.run(cfg, paths["train.p"], device="cpu")
    assert state.step == 4 and signal.getsignal(signal.SIGTERM) is before
    assert os.listdir(os.path.join(paths["runs"], "it", "weights")) == ["model-4.pt"]


def test_train_cli_refuses_multi_gpu(tmp_path):
    """parallel.dp=2, parallel.tp=2 and both (they raised until the
    multi-GPU port; the name stays) train on their CPU ranks (dropout on)
    and rank 0 writes the checkpoint in the released full layout: the
    unsharded run's, entry by entry within JAX's 1e-4."""
    paths = _amass(tmp_path)
    argv = ["--train_data_path", paths["train.p"], "--device", "cpu", "--set"]
    train_diffusion.main(argv + _cli_overrides(paths, exp="ref"))
    ref = load_checkpoint(os.path.join(paths["runs"], "ref", "weights", "model-3.pt"))
    for i, ov in enumerate((["parallel.dp=2"], ["parallel.tp=2"], ["parallel.dp=2", "parallel.tp=2"])):
        assert train_diffusion.main(argv + _cli_overrides(paths, exp=f"mesh{i}") + ov) is None
        ckpt_dir = os.path.join(paths["runs"], f"mesh{i}", "weights")
        assert os.listdir(ckpt_dir) == ["model-3.pt"]
        got = load_checkpoint(os.path.join(ckpt_dir, "model-3.pt"))
        assert got["step"] == 3 and got["nan_count"] == 0
        for part in ("model", "ema"):
            assert set(got[part]) == set(ref[part])
            for k, v in ref[part].items():
                np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), atol=1e-4, rtol=0, err_msg=k)


def test_fit_device_bf16_bank_runs_and_logs(tmp_path, capsys):
    trainer, state = _nan_trainer()
    data = np.random.RandomState(2).uniform(-1, 1, (6, 12, 198)).astype(np.float32)
    state, losses = trainer.fit_device(state, data, np.full((6,), 12), num_steps=4, batch_size=2,
                                       noise=TorchNoise("cpu", 1), log_every=2, ckpt_dir=str(tmp_path),
                                       save_every=4, data_dtype=torch.bfloat16)
    assert state.step == 4 and len(losses) == 2 and np.isfinite(losses).all()
    assert os.listdir(tmp_path) == ["model-4.pt"] and "step 4: loss" in capsys.readouterr().out


def test_trained_checkpoint_loads_and_evaluates(tmp_path):
    """A release-width checkpoint from the trainer: load_stage2_diffusion_ckpt
    reads its EMA weights, and eval_stage2 --checkpoint --device cpu runs on
    it with those weights."""
    cfg = DiffusionConfig(window=16, timesteps=8, compute_dtype="float32")
    trainer = DiffusionTrainer(CondGaussianDiffusion(cfg, device="cpu"), ema_update_every=1, ema_step_start=0)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, _ = trainer.train_step(state, _batch(bs=2, t=16), TorchNoise("cpu", 0))
    path = save_checkpoint(str(tmp_path / "weights"), state)
    sd, step = load_stage2_diffusion_ckpt(path)
    assert step == 1 and set(sd) == set(state.ema.state_dict())
    for k, v in state.ema.state_dict().items():
        assert torch.equal(sd[k], v)

    rng = np.random.RandomState(1)
    motion = rng.uniform(-0.2, 0.2, (16, 69)).astype(np.float32)
    with open(tmp_path / "test.p", "wb") as f:
        pickle.dump({0: {"seq_name": "HumanEva-s0", "trans": np.cumsum(motion[:, :3] * 0.05, 0),
                         "root_orient": motion[:, 3:6], "body_pose": motion[:, 6:]}}, f)
    with open(tmp_path / "stats.p", "wb") as f:
        pickle.dump({"global_jpos_min": -np.ones((22, 3), np.float32),
                     "global_jpos_max": np.ones((22, 3), np.float32)}, f)
    np.save(tmp_path / "rest.npy", rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32))
    res = eval_stage2.run(eval_stage2.parse_opt([
        "--test_data_path", str(tmp_path / "test.p"), "--stats_path", str(tmp_path / "stats.p"),
        "--rest_offsets", str(tmp_path / "rest.npy"), "--checkpoint", path, "--window", "16",
        "--timesteps", "3", "--out_dir", str(tmp_path / "out"), "--device", "cpu"]))
    assert res["num_seqs"] == 1 and all(np.isfinite(v) for v in res["mean"].values())


def test_samplers_refuse_pred_noise():
    diff = CondGaussianDiffusion(DiffusionConfig(**SMALL, objective="pred_noise"), device="cpu")
    with pytest.raises(NotImplementedError, match="pred_x0"):
        diff.p_sample_loop(torch.zeros(1, 12, 198), head_condition_mask(1, 12), noise=TorchNoise("cpu"))


# -- config and logging ----------------------------------------------------

def test_config_defaults_match_jax():
    assert tconfig.to_dict(tconfig.ExperimentConfig()) == jconfig.to_dict(jconfig.ExperimentConfig())


def test_config_overrides_match_jax():
    base = {"stage2": {"d_model": 64}, "data": {"batch_size": 8}}
    ov = ["train.learning_rate=0.001", "data.window=32", "logging.use_wandb=true", "data.device_resident=False",
          "logging.exp_name=run1", "stage2.objective=pred_noise", "train.seed=7"]
    got = tconfig.to_dict(tconfig.load_config(dict(base), overrides=ov))
    assert got == jconfig.to_dict(jconfig.load_config(dict(base), overrides=ov))
    assert got["logging"]["use_wandb"] is True and got["train"]["learning_rate"] == 0.001


def test_save_yaml_matches_jax(tmp_path):
    cfg = tconfig.load_config(overrides=["stage2.d_model=64", "logging.profile_dir=/tmp/p"])
    tconfig.save_yaml(cfg, str(tmp_path / "t.yaml"))
    jconfig.save_yaml(jconfig.load_config(overrides=["stage2.d_model=64", "logging.profile_dir=/tmp/p"]),
                      str(tmp_path / "j.yaml"))
    got = yaml.safe_load(open(tmp_path / "t.yaml"))
    assert got == yaml.safe_load(open(tmp_path / "j.yaml"))
    assert tconfig.to_dict(tconfig.load_config(str(tmp_path / "j.yaml"))) == tconfig.to_dict(cfg)
    assert save_run_config(cfg, str(tmp_path / "run")).endswith("opt.yaml")


def test_metric_logger_and_profile_trace(tmp_path):
    lg = MetricLogger(str(tmp_path))
    lg.log(1, loss=0.5)
    lg.log(2, loss=torch.tensor(0.25), lr=1e-4)
    lg.close()
    lines = [json.loads(line) for line in open(lg.path)]
    assert lines[0]["step"] == 1 and lines[0]["loss"] == 0.5 and lines[1]["lr"] == 1e-4
    with profile_trace(""):
        pass
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]


def test_fit_on_host_batches_logs_and_checkpoints(tmp_path, capsys):
    """fit() over a host batch iterator, as fit_device over the bank."""
    trainer, state = _nan_trainer()
    batches = iter([_batch(seed=i) for i in range(4)])
    state, losses = trainer.fit(state, batches, num_steps=4, noise=TorchNoise("cpu", 1), log_every=2,
                                ckpt_dir=str(tmp_path), save_every=2)
    assert state.step == 4 and len(losses) == 2 and np.isfinite(losses).all()
    assert sorted(os.listdir(tmp_path)) == ["model-2.pt", "model-4.pt"]
    assert "step 4: loss" in capsys.readouterr().out


def _chip_smoke():
    """chip_smoke.py as a module (its phases run only under __main__)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flipped", [False, True])
def test_train_step_agreement_replays_the_first_sides_branches(flipped):
    """chip_smoke.train_step_agreement on the CPU against itself. With one
    ReLU unit of layer 0 at exactly 0 on every token, and +1e-7 on the first
    side only, the CPU's free run takes the other branch there and that
    unit's gradient row moves whole; replaying the first side's branches,
    every bounded measure holds (the float64 reference replays them too).
    Without the nudge the two sides are one computation: every comparison
    of them is 0, and both lie equally far from float64."""
    cs = _chip_smoke()
    sides = []

    def make_state(where):
        trainer = DiffusionTrainer(CondGaussianDiffusion(DiffusionConfig(**SMALL, compute_dtype="float32"),
                                                         device=where))
        state = trainer.init_state(torch.Generator().manual_seed(0))
        set_dropout_rate(state.model, 0.0)
        ffn = state.model.motion_transformer.layer_stack[0].pos_ffn
        with torch.no_grad():
            ffn.w_1.weight[3].zero_()
            ffn.w_1.bias[3] = 1e-7 if flipped and not sides else 0.0
        sides.append(where)
        return trainer, state

    batch = _batch(bs=4, seq_len=[12, 9, 12, 5])
    m = cs.train_step_agreement(make_state, batch, 1, torch.device("cpu"))
    assert len(sides) == 4 and m["branch_calls"] == 2 * (SMALL["n_dec_layers"] + 1)
    replayed = ("loss", "grad64_excess", "wk_bias", "param", "adam", "flip_input")
    assert all(m[k] <= cs.STEP_BOUNDS[k] for k in replayed), {k: m[k] for k in replayed}
    if flipped:
        assert m["flips"] == m["forced"] == 4 * (SMALL["window"] + 1)
        assert m["flip_calls"] == ["relu call 0", "relu call 3"]  # layer 0 of each micro-batch
        assert m["grad_free"] > 0.5 and m["grad_free_worst"].endswith("layer_stack.0.pos_ffn.w_1.bias")
        assert m["grad_l2"] > cs.STEP_BOUNDS["grad_l2"]
    else:
        assert m["flips"] == m["forced"] == 0 and m["flip_calls"] == []
        same = ("loss", "grad", "wk_bias", "param", "flip_input", "loss_free", "grad_free", "grad_l2", "grad_l2_all")
        assert all(m[k] == 0 for k in same), m  # "adam" is the f32 update against its float64 formula
        assert m["grad64"] == m["grad64_cpu"] > 0 and m["loss64"] == m["loss64_cpu"]
