"""What the spawned gloo CPU ranks of tests/test_torch_parallel.py and
tests/test_torch_serving_export.py run (the sharded runs at the TINY widths
of tests/test_inference_parallel.py; the dp serving artifact), imported by
name in each rank: this module imports no JAX, so a rank starts without
it."""

import numpy as np
import torch

from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    NormStats,
    new_denoiser,
)
from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline
from egoego_release_tpu_torch.ops import fused_layer as tfl
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.parallel import mesh as pm
from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer
from egoego_release_tpu_torch.utils.convert import load_denoiser_weights

TINY = dict(d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=8, timesteps=6, overlap_frames=2)
TRAIN = dict(d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=12, timesteps=8)
KW = dict(n_head=2, d_k=16, d_v=16)
MESHES = [(2, 1), (2, 2)]
BOUND = {1: 2e-4, 2: 2e-3}  # by tp


def chain_inputs(bs=8, t_total=20, seed=0):
    """tests/test_inference_parallel.py's chain_inputs."""
    rng = np.random.RandomState(seed)
    jpos = rng.uniform(-1, 1, (bs, t_total, 3)).astype(np.float32)
    q = rng.normal(size=(bs, t_total, 4)).astype(np.float32)
    rest = rng.uniform(-0.2, 0.2, (22, 3)).astype(np.float32)
    return jpos, q / np.linalg.norm(q, axis=-1, keepdims=True), rest


def stats():
    return NormStats(torch.full((22, 3), -2.0), torch.full((22, 3), 2.0))


def diffusion(sd, mesh=None, **kw):
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**TINY)), sd)
    diff = CondGaussianDiffusion(DiffusionConfig(**TINY, compute_dtype="float32", **kw), device="cpu", model=model)
    return diff if mesh is None else diff.shard(mesh)


def chain(diff, mesh=None, route_noise=7):
    jpos, q, rest = chain_inputs()
    return diff.sample_sliding_window_w_canonical(torch.from_numpy(jpos), torch.from_numpy(q), stats(),
                                                  torch.from_numpy(rest), noise=TorchNoise("cpu", route_noise),
                                                  mesh=mesh)


class ReplayNoise:
    """Replays recorded draws in order (a noise source another process
    recorded: JAX's keys, drawn where JAX is imported)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def window(self):
        return self

    def _next(self, shape):
        d = self.draws.pop(0)
        assert tuple(d.shape) == tuple(shape), (d.shape, shape)
        return d

    initial = cond = step = _next


class RecordingNoise:
    """Records every draw of ``src``."""

    def __init__(self, src):
        self.src, self.draws = src, []

    def window(self):
        self.src.window()
        return self

    def _rec(self, kind, shape):
        self.draws.append(getattr(self.src, kind)(shape))
        return self.draws[-1]

    def initial(self, shape):
        return self._rec("initial", shape)

    def cond(self, shape):
        return self._rec("cond", shape)

    def step(self, shape):
        return self._rec("step", shape)


def parallel_window(diff, noise, mesh=None):
    jpos, q, rest = chain_inputs(bs=2, t_total=22)  # 3 full windows x 2 sequences (a stack of 6) and a tail
    return diff.sample_sliding_window_parallel(torch.from_numpy(jpos), torch.from_numpy(q), stats(),
                                               torch.from_numpy(rest), noise=noise, mesh=mesh)


def layer_inputs(seed=3):
    rng = np.random.RandomState(seed)
    h = rng.randn(3, 9, TINY["d_model"]).astype(np.float32)
    mask = np.ones((3, 9), np.float32)
    mask[:, 6:] = 0.0
    return h, mask


def batch(bs=8, t=12, seed=0):
    rng = np.random.RandomState(seed)
    return {"motion": rng.uniform(-1, 1, (bs, t, 198)).astype(np.float32), "seq_len": np.full((bs,), t, np.int32)}


def bank():
    return np.random.RandomState(11).uniform(-1, 1, (10, 12, 198)).astype(np.float32), np.full((10,), 12)


def trainer_and_state(mesh=None):
    trainer = DiffusionTrainer(CondGaussianDiffusion(DiffusionConfig(**TRAIN), device="cpu"), lr=1e-3, mesh=mesh)
    return trainer, trainer.init_state(torch.Generator().manual_seed(0))


def full_params(state):
    model = state.model
    if getattr(model, "mesh", None) is None:
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
    return pm.gather_state_dict(model.state_dict(), model.mesh, model.full_shapes)


def rank_checks(mesh, sd, parallel_draws, out_path):
    """Every sharded run of tests/test_torch_parallel.py on one rank (the
    parallel sampler on the recorded draws of JAX's keys); rank 0 saves
    them."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    r = {}
    r["chain_step"] = chain(diffusion(sd, mesh), mesh)
    if mesh.tp == 1:  # the --fused route (bf16 layers) under dp
        r["chain_fused"] = chain(diffusion(sd, mesh, fused_transformer=True), mesh)
    r["parallel"] = parallel_window(diffusion(sd, mesh), ReplayNoise(parallel_draws), mesh)

    # pipeline.shard with 3 sequences: padded to a multiple of dp, sliced back
    jpos, q, rest = chain_inputs()
    pipe = EgoEgoPipeline(diffusion(sd), stats(), torch.from_numpy(rest)).shard(mesh)
    r["pipeline"] = pipe.stage2_generate_batched(np.concatenate([jpos[:3], q[:3]], -1), TorchNoise("cpu", 1))

    # the tp layer's plain pieces: this rank's shard of layer 1, f32 and bf16 compute
    h, mask = layer_inputs()
    layer = diffusion(sd, mesh).model.motion_transformer.layer_stack[1]
    r["layer"] = {bf16: tfl.decoder_layer_plain(torch.from_numpy(h), torch.from_numpy(mask),
                                                tfl.layer_params(layer, bf16), **KW) for bf16 in (False, True)}

    # training: one step, fit_device, an indivisible micro-batch
    trainer, state = trainer_and_state(mesh)
    state, loss = trainer.train_step(state, batch(), TorchNoise("cpu", 7))
    r["train"] = (float(loss), full_params(state))
    trainer, state = trainer_and_state(mesh)
    state, losses = trainer.fit_device(state, *bank(), num_steps=3, batch_size=8, noise=TorchNoise("cpu", 9),
                                       log_every=1)
    r["fit"] = (losses, full_params(state))
    try:
        trainer.fit_device(state, np.zeros((4, 12, 198), np.float32), np.full((4,), 12), num_steps=1,
                           batch_size=2, noise=TorchNoise("cpu", 0))
        r["indivisible"] = None
    except ValueError as e:
        r["indivisible"] = str(e)

    # shard_state_dict then gather_state_dict: the full state_dict bit for bit
    full = {k: torch.as_tensor(v) for k, v in sd.items()}
    back = pm.gather_state_dict(pm.shard_state_dict(full, mesh), mesh, {k: v.shape for k, v in full.items()})
    r["roundtrip"] = set(back) == set(full) and all(torch.equal(back[k], v) for k, v in full.items())
    if mesh.rank == 0:
        torch.save(r, out_path)


def call_sharded_rank(mesh, path, seed, jpos, jquat, out_path):
    """serving.export.call_sharded of the artifact at ``path``; rank 0 saves
    the gathered outputs."""
    from egoego_release_tpu_torch.serving import export as sx

    out = sx.call_sharded(sx.load_artifact(path), mesh, seed, jpos, jquat)
    if mesh.rank == 0:
        torch.save(out, out_path)
