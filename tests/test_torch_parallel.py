"""The port's multi-GPU paths (parallel/mesh.py) on gloo CPU ranks, held
against its unsharded runs and the JAX package's sharded runs
(tests/test_inference_parallel.py, tests/test_training_parallel.py) at
their TINY widths (d_model 32, 2 heads, d_k 16, window 8, 6 steps).

The ranks are spawned once per mesh (dp 2, and dp 2 x tp 2) by a
module-scoped fixture; every check runs inside them
(``torch_parallel_ranks.rank_checks``, a module without JAX, so that a
rank starts fast; JAX's draws for the parallel sampler are recorded here
and replayed there) and the tests read rank 0's results. Bounds are JAX's: the sharded chain
within 2e-4 of the unsharded one under dp and 2e-3 under tp (tp sums each
row-parallel product in another order), the training loss within rtol
1e-5 and the parameters within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chain import JaxChainNoise

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.diffusion.gaussian_diffusion import NormStats as JStats
from egoego_release_tpu.ops import fused_step as jfs
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu.ops.fused_layer import _PARAM_ORDER, _layer_body
from egoego_release_tpu.parallel.mesh import make_mesh as jmake_mesh
from egoego_release_tpu.parallel.mesh import shard_params as jshard_params
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import DiffusionConfig, new_denoiser
from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.ops.fused_step import TorchNoise
from egoego_release_tpu_torch.parallel import mesh as pm
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax
from torch_parallel_ranks import (
    BOUND,
    KW,
    MESHES,
    TINY,
    RecordingNoise,
    bank,
    batch,
    chain,
    chain_inputs,
    diffusion,
    full_params,
    layer_inputs,
    parallel_window,
    rank_checks,
    stats,
    trainer_and_state,
)

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = JDiffusion(JConfig(**TINY)).init_params(jax.random.PRNGKey(0))
    sd = denoiser_state_dict_from_jax(params)
    # JAX's draws for the parallel sampler, recorded on the unsharded port
    # run: its stack of 6 windows divides by dp 2, so the ranks draw the same
    # shapes, in the same order
    rec = RecordingNoise(JaxChainNoise(jax.random.PRNGKey(11)))
    parallel_window(diffusion(sd), rec)
    out = {}
    for dp, tp in MESHES:
        path = str(tmp_path_factory.mktemp("ranks") / f"dp{dp}_tp{tp}.pt")
        pm.spawn(rank_checks, (sd, rec.draws, path), dp, tp, ["cpu"] * (dp * tp))
        out[(dp, tp)] = torch.load(path, weights_only=False)
    return params, sd, out


def _mats(aa):
    # axis-angle flips representation at angle ~ pi under any rounding: compare rotations as matrices
    return trot.axis_angle_to_matrix(torch.as_tensor(np.asarray(aa))).numpy()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_sharded_chain_matches_unsharded(ranks, mesh):
    """The canonical chain on the step kernels' route (their plain versions
    here) under dp and dp x tp, against the unsharded chain."""
    _, sd, out = ranks
    aa0, root0 = chain(diffusion(sd))
    aa1, root1 = out[mesh]["chain_step"]
    assert aa1.shape == aa0.shape == (8, 20, 22, 3) and torch.isfinite(aa1).all()
    np.testing.assert_allclose(_mats(aa1), _mats(aa0), atol=BOUND[mesh[1]], rtol=0)
    np.testing.assert_allclose(root1.numpy(), root0.numpy(), atol=BOUND[mesh[1]], rtol=0)


def test_sharded_fused_route_matches_unsharded(ranks):
    """The --fused route (fused_decoder_layer per layer, bf16) under dp 2:
    each rank's rows are computed as in the unsharded batch. bf16 roundings
    flip with the order of a product's sums, so the unsharded run takes
    the ranks' one thread."""
    _, sd, out = ranks
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        aa0, root0 = chain(diffusion(sd, fused_transformer=True))
    finally:
        torch.set_num_threads(threads)
    aa1, root1 = out[(2, 1)]["chain_fused"]
    np.testing.assert_allclose(_mats(aa1), _mats(aa0), atol=2e-4, rtol=0)
    np.testing.assert_allclose(root1.numpy(), root0.numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_parallel_window_sharded_matches_jax(ranks, mesh):
    """sample_sliding_window_parallel(mesh=) against JAX's sharded run on
    its own mesh with its keys replayed: the stack of 6 windows padded to
    dp, each rank's rows of the padded stack's noise. 1e-4 (the port's
    bound against JAX at f32) under dp, 2e-3 under tp."""
    params, _, out = ranks
    jpos, q, rest = chain_inputs(bs=2, t_total=22)
    jmesh = jmake_mesh(dp=mesh[0], tp=mesh[1])
    jdiff = JDiffusion(JConfig(**TINY))
    with jmesh:
        aa_j, root_j = jdiff.sample_sliding_window_parallel(
            jshard_params(params, jmesh), jax.random.PRNGKey(11), jnp.asarray(jpos), jnp.asarray(q),
            JStats(jnp.full((22, 3), -2.0), jnp.full((22, 3), 2.0)), jnp.asarray(rest), mesh=jmesh)
    aa_t, root_t = out[mesh]["parallel"]
    bound = 1e-4 if mesh[1] == 1 else 2e-3
    assert aa_t.shape == (2, 22, 22, 3)
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=bound, rtol=0)
    np.testing.assert_allclose(_mats(aa_t), np.asarray(jrot.axis_angle_to_matrix(aa_j)), atol=bound, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_pipeline_shard_pads_and_slices(ranks, mesh):
    """EgoEgoPipeline.shard: 3 sequences over dp 2 are padded to 4 (the last
    row repeated) and sliced back; the rows are the unsharded run's on the
    padded batch (dp = N reproduces dp = 1 on the padded batch)."""
    _, sd, out = ranks
    jpos, q, rest = chain_inputs()
    hp = np.concatenate([jpos[:3], q[:3]], -1)
    padded = np.concatenate([hp, hp[-1:]])
    pipe = EgoEgoPipeline(diffusion(sd), stats(), torch.from_numpy(rest))
    aa0, root0 = pipe.stage2_generate_batched(padded, TorchNoise("cpu", 1))
    aa1, root1 = out[mesh]["pipeline"]
    assert aa1.shape == (3, 20, 22, 3) and root1.shape == (3, 20, 3) and torch.isfinite(aa1).all()
    np.testing.assert_allclose(_mats(aa1), _mats(aa0[:3]), atol=BOUND[mesh[1]], rtol=0)
    np.testing.assert_allclose(root1.numpy(), root0[:3].numpy(), atol=BOUND[mesh[1]], rtol=0)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_tp_layer_plain_matches_layer_body(ranks, mesh, bf16):
    """The layer's plain pieces on a rank's shard (its heads and hidden
    units; fc and w2 as partial products, the all-reduce over the tp group,
    then residual_layernorm_plain) against JAX's _layer_body on the whole
    layer: 5e-5 in f32 compute (summation order), 2e-2 in bf16."""
    params, _, out = ranks
    h, mask = layer_inputs()
    cdt = jnp.bfloat16 if bf16 else jnp.float32
    jlp = jfs.prepare_step_params(params, JConfig(**TINY), cdt, 256)["layers"][1]
    b, t, _ = h.shape
    want = np.asarray(_layer_body(jnp.asarray(h), jnp.asarray(mask).reshape(b * t, 1),
                                  *[jlp[n] for n in _PARAM_ORDER], t_real=t, scale=1.0 / TINY["d_k"] ** 0.5,
                                  cdt=cdt, **KW)).reshape(b, t, -1)
    got = out[mesh]["layer"][bf16]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2 if bf16 else 5e-5, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_sharded_training_step_matches_unsharded(ranks, mesh):
    """One optimizer step (dropout on) under dp and dp x tp: each rank's
    rows and its share of the micro-batch's noise and dropout masks, the
    gradients averaged over dp; the gathered parameters are the unsharded
    step's."""
    _, _, out = ranks
    trainer, state = trainer_and_state()
    state, loss = trainer.train_step(state, batch(), TorchNoise("cpu", 7))
    loss1, params1 = out[mesh]["train"]
    np.testing.assert_allclose(loss1, float(loss), rtol=1e-5)
    for k, v in full_params(state).items():
        np.testing.assert_allclose(params1[k].numpy(), v.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_fit_device_sharded_matches_unsharded(ranks, mesh):
    """fit_device under a mesh: the bank replicated, each step's gathered
    batch split over dp; three steps reproduce the unsharded trajectory."""
    _, _, out = ranks
    trainer, state = trainer_and_state()
    state, losses = trainer.fit_device(state, *bank(), num_steps=3, batch_size=8, noise=TorchNoise("cpu", 9),
                                       log_every=1)
    losses1, params1 = out[mesh]["fit"]
    assert len(losses1) == len(losses) == 3
    np.testing.assert_allclose(losses1, losses, rtol=1e-5)
    for k, v in full_params(state).items():
        np.testing.assert_allclose(params1[k].numpy(), v.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_fit_device_mesh_rejects_indivisible_microbatch(ranks, mesh):
    """A micro-batch (batch_size / grad_accum = 1) that does not split over
    dp 2 raises ValueError, as JAX's fit_device does."""
    assert "divisible by dp" in (ranks[2][mesh]["indivisible"] or "")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xtp{m[1]}")
def test_state_dict_shard_gather_roundtrip(ranks, mesh):
    assert ranks[2][mesh]["roundtrip"]


def test_pad_to_dp():
    x = torch.arange(6, dtype=torch.float32).reshape(6, 1)
    padded, b = pm.pad_to_dp(x, 4)
    assert b == 6 and padded.shape[0] == 8
    assert torch.equal(padded[6:], x[5:6].expand(2, 1))
    y, b2 = pm.pad_to_dp(torch.zeros(8, 1), 4)
    assert b2 == 8 and y.shape[0] == 8


@pytest.mark.parametrize("tp", [2, 4])
def test_release_dims_tp_sharding_counts(tp):
    """The release config (d_model 512, d_k = d_v = 256, 4 layers) splits
    exactly 10 entries a layer under tp (a guard against rule rot: a key
    that stops matching, or a dim that stops dividing, replicates
    silently); each rank's w_q is its (1024 / tp, 512) slice of heads."""
    sd = new_denoiser(DiffusionConfig()).state_dict()
    assert pm.count_tp_sharded(sd, tp) == pm.expected_tp_sharded(4) == 40
    for rank in range(tp):
        mesh = pm.Mesh(dp=1, tp=tp, rank=rank, device=torch.device("cpu"), dp_group=None, tp_group=None)
        local = pm.shard_state_dict(sd, mesh)
        wq = [k for k in local if k.endswith("self_attn.w_q.weight")]
        assert len(wq) == 4 and all(local[k].shape == (1024 // tp, 512) for k in wq)
        assert all(torch.equal(local[k], sd[k][rank * 1024 // tp:(rank + 1) * 1024 // tp]) for k in wq)
        fc = [k for k in local if k.endswith("self_attn.fc.weight")]
        assert all(local[k].shape == (512, 1024 // tp) for k in fc)
