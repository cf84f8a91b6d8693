"""The port's serving artifacts (serving/export.py): torch.export programs
saved, loaded and called against the live port on the CPU, where every
kernel's custom op runs its plain version; the counterpart of
tests/test_serving_export.py (its bound 2e-5). The exported chain also
holds against JAX's live chain on the same weights with JAX's keys
replayed (1e-4, the port's bound against JAX at f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chain import SMALL, JaxChainNoise

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.diffusion.gaussian_diffusion import NormStats as JStats
from egoego_release_tpu.ops import rotations as jrot
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import (
    CondGaussianDiffusion,
    DiffusionConfig,
    NormStats,
    new_denoiser,
)
from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline
from egoego_release_tpu_torch.models.denoiser import init_weights_
from egoego_release_tpu_torch.models.gravitynet import HeadNormalFormer
from egoego_release_tpu_torch.models.headnet import HeadFormer
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import rotations as trot
from egoego_release_tpu_torch.ops.fused_step import DefaultNoise
from egoego_release_tpu_torch.parallel import mesh as pm
from egoego_release_tpu_torch.serving import export as sx
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax, load_denoiser_weights
from torch_parallel_ranks import call_sharded_rank

CFG = dict(d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=12, timesteps=8, overlap_frames=4)
TOL = 2e-5


def make_pipeline(seed=0, with_stage1=False):
    """tests/test_serving_export.py's pipeline: random weights from a seed,
    stats -3 / 3; the stage-1 models at widths 32."""
    diff = CondGaussianDiffusion(DiffusionConfig(**CFG), device="cpu", seed=seed)
    rng = np.random.RandomState(seed)
    rest = torch.from_numpy(rng.randn(22, 3).astype(np.float32) * 0.1)
    rest[0] = 0.0
    pipe = EgoEgoPipeline(diff, NormStats(torch.full((22, 3), -3.0), torch.full((22, 3), 3.0)), rest)
    if with_stage1:
        init = lambda m, s: init_weights_(m, torch.Generator().manual_seed(s)).eval()
        pipe.headnet = init(HeadFormer(d_model=32, n_layers=1, n_head=2, d_k=16, d_v=16, window=8), 1)
        pipe.gravitynet = init(HeadNormalFormer(d_model=32, n_layers=1, n_head=2, d_k=16, d_v=16, window=16), 2)
    return pipe


def head_inputs(b, t, seed):
    rng = np.random.RandomState(seed)
    jpos = np.cumsum(rng.randn(b, t, 3).astype(np.float32) * 0.02, 1)
    q = rng.randn(b, t, 4).astype(np.float32)
    return torch.from_numpy(jpos), torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))


def stage1_inputs(b, t, seed):
    rng = np.random.RandomState(seed)
    q0 = rng.randn(b, 4).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    return tuple(torch.from_numpy(a) for a in (
        rng.randn(b, t - 1, 512).astype(np.float32), q0,
        np.cumsum(rng.randn(b, t, 3).astype(np.float32) * 0.02, 1),
        np.cumsum(rng.randn(b, t, 3).astype(np.float32) * 0.02, 1),
        np.stack([np.stack([np.eye(3, dtype=np.float32)] * t)] * b),
        rng.randn(b, t, 7).astype(np.float32)))


def roundtrip(prog, tmp_path, name):
    path = str(tmp_path / f"{name}.pt2")
    sx.save_artifact(prog, path)
    return sx.load_artifact(path)


def egoego_ops(prog) -> set:
    """The torch.ops.egoego nodes of a program, its loops' bodies included."""
    return {str(n.target) for gm in prog.graph_module.modules() for n in gm.graph.nodes
            if n.op == "call_function" and "egoego" in str(n.target)}


def live_chain(pipe, jpos, jquat, seed):
    torch.manual_seed(seed)
    return pipe.diffusion.sample_sliding_window_w_canonical(jpos, jquat, pipe.stats, pipe.rest_offsets,
                                                           noise=DefaultNoise("cpu"))


def close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=tol, rtol=tol)


def test_chain_artifact_roundtrip_matches_live(tmp_path):
    """The chain's artifact (weights, stats and rest offsets baked in; each
    window's reverse loop one while_loop of one step) loads and, for one
    seed, draws and computes what the live chain does."""
    pipe = make_pipeline()
    loaded = roundtrip(sx.export_chain(pipe, 2, 20), tmp_path, "chain")  # two windows
    assert {"egoego.gemm.default", "egoego.attention.default"} <= egoego_ops(loaded)
    jpos, jquat = head_inputs(2, 20, 3)
    got = sx.call_artifact(loaded, 7, jpos, jquat)
    assert got[0].shape == (2, 20, 22, 3) and got[1].shape == (2, 20, 3)
    close(got, live_chain(pipe, jpos, jquat, 7))


def test_stage1_artifact_roundtrip_matches_live(tmp_path):
    pipe = make_pipeline(with_stage1=True)
    loaded = roundtrip(sx.export_stage1(pipe, 3, 16), tmp_path, "s1")
    args = stage1_inputs(3, 16, 4)
    live = pipe._stage1(*args)
    close(sx.call_artifact(loaded, None, *args), (live["head_pose"], live["pred_scale"], live["pred_normal"]))


def test_fk_artifact_roundtrip_matches_live(tmp_path):
    pipe = make_pipeline()
    loaded = roundtrip(sx.export_fk(pipe, 2, 10), tmp_path, "fk")
    rng = np.random.RandomState(6)
    root = torch.from_numpy(rng.randn(2, 10, 3).astype(np.float32))
    aa = torch.from_numpy((rng.randn(2, 10, 22, 3) * 0.3).astype(np.float32))
    close(sx.call_artifact(loaded, None, root, aa), pipe.fk(root, aa))


def test_sharded_chain_artifact_roundtrip(tmp_path):
    """export_chain_sharded on a dp 2 mesh: the one-device chain at batch 4
    / 2, which call_sharded runs on two CPU ranks, each on its rows with
    seed + its dp coordinate; the gathered batch is each rank's live chain."""
    pipe = make_pipeline()
    stand_in = pm.Mesh(dp=2, tp=1, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    prog = sx.export_chain_sharded(pipe, 4, 12, stand_in)
    path = str(tmp_path / "chain_dp2.pt2")
    sx.save_artifact(prog, path)
    jpos, jquat = head_inputs(4, 12, 8)
    out_path = str(tmp_path / "sharded.pt")
    pm.spawn(call_sharded_rank, (path, 12, jpos, jquat, out_path), 2, 1, ["cpu", "cpu"])
    got = torch.load(out_path)
    want = [live_chain(pipe, jpos[r * 2:(r + 1) * 2], jquat[r * 2:(r + 1) * 2], 12 + r) for r in range(2)]
    close(got, [torch.cat(parts) for parts in zip(*want)])
    with pytest.raises(ValueError, match="divisible by dp"):
        sx.export_chain_sharded(pipe, 3, 12, stand_in)


def test_e2e_artifact_roundtrip_matches_live(tmp_path):
    """Stage 1, the floor shift, the chain and FK in one program against the
    live three-stage composition for one seed."""
    pipe = make_pipeline(with_stage1=True)
    loaded = roundtrip(sx.export_e2e(pipe, 2, 12, floor_offset=0.07), tmp_path, "e2e")
    args = stage1_inputs(2, 12, 9)
    got = sx.call_artifact(loaded, 33, *args)
    s1 = pipe._stage1(*args)
    hp = s1["head_pose"].clone()
    hp[..., 2] += 0.07
    aa, root = live_chain(pipe, hp[..., :3].contiguous(), hp[..., 3:].contiguous(), 33)
    close(got, (aa, root, *pipe.fk(root, aa), hp, s1["pred_scale"]))


class JaxTableNoise(JaxChainNoise):
    """JAX's chain keys (JaxChainNoise) for an exported chain: a window's
    step draws, split from its loop key in JAX's order, become one table
    when the window's initial x is drawn, and step i reads row i, so the
    traced loop replays them (baked into the program as a constant)."""

    def __init__(self, key, n_steps):
        super().__init__(key)
        self.n_steps = n_steps

    def initial(self, shape):
        self.table = torch.stack([self.step(shape) for _ in range(self.n_steps)])
        return super().initial(shape)

    def step_at(self, i, shape):
        return self.table.index_select(0, i.reshape(1))[0]


def test_exported_chain_matches_jax_live_chain(tmp_path):
    """The exported chain (two windows of a 30-frame sequence at
    test_torch_chain's widths) on JAX's weights and keys against JAX's live
    chain: positions and rotation matrices within 1e-4."""
    rng = np.random.RandomState(0)
    jdiff = JDiffusion(JConfig(**SMALL))
    params = jdiff.init_params(jax.random.PRNGKey(0), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig(**SMALL)), denoiser_state_dict_from_jax(params))
    diff = CondGaussianDiffusion(DiffusionConfig(**SMALL), device="cpu", model=model)
    rest = np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32)
    lo, hi = np.full((22, 3), -1.5, np.float32), np.full((22, 3), 1.5, np.float32)
    pipe = EgoEgoPipeline(diff, NormStats(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(rest))
    jpos, jquat = head_inputs(3, 30, 1)
    key = jax.random.PRNGKey(7)
    prog = sx.export_chain(pipe, 3, 30, noise=JaxTableNoise(key, SMALL["timesteps"]))
    aa_t, root_t = sx.call_artifact(roundtrip(prog, tmp_path, "chain_jax"), None, jpos, jquat)
    aa_j, root_j = jdiff.sample_sliding_window_w_canonical(
        params, key, jnp.asarray(jpos.numpy()), jnp.asarray(jquat.numpy()), JStats(jnp.asarray(lo), jnp.asarray(hi)),
        jnp.asarray(rest))
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(trot.axis_angle_to_matrix(aa_t).numpy(), np.asarray(jrot.axis_angle_to_matrix(aa_j)),
                               atol=1e-4, rtol=0)


def _op_cases():
    """One CPU call of each custom op per GEMM mode: (op, args)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g).to(dt)
    m, k, n, t = 18, 24, 16, 5  # 3 windows of 5 frames (the stem's 6 tokens a window: 18 rows)
    none = [None] * 11
    gemm = torch.ops.egoego.gemm.default
    cases = []
    for mode in (ck.BIAS, ck.BIAS_RELU, ck.PARTIAL):
        cases.append((gemm, (r(m, k), r(n, k), r(n), torch.empty(m, n), mode, m, *none, None, 0, None)))
    cases.append((gemm, (r(m, k, dt=torch.bfloat16), r(n, k, dt=torch.bfloat16), r(n), torch.empty(m, n), ck.LAYER_NORM,
                         m, None, r(m, n), r(n), r(n), torch.ones(m), None, None, None, None, None, None,
                         torch.empty(m, n, dtype=torch.bfloat16), 0, None)))
    cases.append((gemm, (r(3, t, 8), r(n, 16), r(n), torch.empty(3 * (t + 1), n), ck.STEM, 3 * (t + 1), r(3, t, 8),
                         None, None, None, None, r(t + 1, n), r(n), None, None, None, None, None, t, None)))
    cases.append((gemm, (r(3 * (t + 1), k), r(n, k), r(n), torch.empty(3 * t, n), ck.STEP, 3 * t, None, None, None,
                         None, None, None, None, r(3 * t, n), r(3 * t, n), r(3 * t, n), torch.ones(3 * t), None, t,
                         torch.tensor([0.9, 0.1, 0.05]))))
    cases.append((torch.ops.egoego.attention.default, (r(2 * 7, 2 * 24), torch.empty(2 * 7, 2 * 8), 2, 7, 7, 2, 8, 8)))
    cases.append((torch.ops.egoego.mha.default, (r(2, 2, 9, 8), r(2, 2, 9, 8), r(2, 2, 9, 8), torch.empty(2, 2, 9, 8),
                                                 9)))
    cases.append((torch.ops.egoego.residual_layernorm.default, (r(m, n), r(n), r(m, n, dt=torch.bfloat16), r(n), r(n),
                                                                torch.ones(m), torch.empty(m, n),
                                                                torch.empty(m, n, dtype=torch.bfloat16))))
    return cases


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_custom_op_fake_matches_plain(case):
    """Each custom op's registration (schema, fake implementation under
    FakeTensorMode and through AOT dispatch) against its plain CPU
    implementation (torch.library.opcheck), and what the plain version
    writes has its outputs' shapes and dtypes."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))
    outs = [a for a in args if isinstance(a, torch.Tensor) and a.dtype in (torch.float32, torch.bfloat16)]
    before = [(o.shape, o.dtype) for o in outs]
    op(*args)
    assert [(o.shape, o.dtype) for o in outs] == before and all(torch.isfinite(o.float()).all() for o in outs)
