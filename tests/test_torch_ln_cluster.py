"""The bf16 LayerNorm GEMM (fc and w2 of every layer) on the card: csrc/gemm.cu
gemm_wgmma_ln_kernel, which splits each block of 64 rows over a cluster of
four CTAs and sums the row statistics across them. These need an NVIDIA GPU
with nvcc and skip without one; run them there with

    python -m pytest tests/test_torch_ln_cluster.py -q --noconftest

Tolerance 2e-2, as every bf16 case of tests/test_torch_cuda.py (a bf16
rounding of A may flip where the product sums in another order; outputs are
O(1) LayerNorm values).
"""

import pytest
import torch

from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_layer as fl
from egoego_release_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.cuda
TOL_BF16 = 2e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ck.build()
    return torch.device("cuda")


def _ln_inputs(card, m, n, k, seed):
    """bf16 A and W, an f32 residual that bf16 holds exactly (so the bf16
    residual layouts read the same values), and a row mask with zeros."""
    g = torch.Generator(device=card).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=card)
    bf = torch.bfloat16
    a, w, bias = rn(m, k).to(bf), (rn(n, k) * 0.25 / k ** 0.5).to(bf), 0.25 * rn(n)
    res = rn(m, n).to(bf).float()
    ln_s, ln_b = 1 + 0.1 * rn(n), 0.1 * rn(n)
    mask = (rn(m) > -1).float()
    mask[:: max(1, m // 7)] = 0.0
    return a, w, bias, res, ln_s, ln_b, mask


@pytest.mark.parametrize("m,n,k", [
    (7744, 512, 1024), (7744, 512, 512),  # fc and w2 at 64 windows of 121 tokens
    (3968, 512, 1024), (3968, 512, 512),  # at the 128 x 31 tail window
    (363, 512, 1024), (363, 384, 512),    # ragged M; N < 512 leaves a CTA of each cluster no columns
    (93, 200, 512), (1, 512, 64)])        # a CTA with part of its columns; one row and one k-tile
def test_ln_cluster_layouts_match_plain_and_each_other(card, m, n, k):
    """All four layouts (f32 or bf16 residual; f32 out with its bf16 copy,
    or the bf16 out alone) against add_layer_norm_plain, on one launch of
    the cluster kernel each; on equal inputs they agree bit for bit (the
    row statistics add the CTAs' partials in one fixed order), the copy is
    the f32 output rounded, masked rows are zeros, and a second launch
    repeats the first bit for bit."""
    bf = torch.bfloat16
    a, w, bias, res, ln_s, ln_b, mask = _ln_inputs(card, m, n, k, seed=m + n + k)
    want = fl.add_layer_norm_plain(a, w, bias, res, ln_s, ln_b, mask, None)
    got = {}
    for res_dt in (torch.float32, bf):
        for f32_out in (True, False):
            out = torch.empty(m, n, device=card) if f32_out else None
            out_b = torch.empty(m, n, dtype=bf, device=card)
            ck.kernel_launches.clear()
            ck.gemm(ck.LAYER_NORM, a, w, bias, out, M=m, res=res.to(res_dt), ln_s=ln_s, ln_b=ln_b, row_mask=mask,
                    out_b=out_b)
            assert dict(ck.kernel_launches) == {"gemm_wgmma": 1}
            got[res_dt, f32_out] = (out, out_b)
    torch.cuda.synchronize()
    out, out_b = got[torch.float32, True]
    assert float((out - want).abs().max()) < TOL_BF16
    assert torch.equal(out_b, out.to(bf))
    assert not out[mask == 0].any()
    assert torch.equal(got[bf, True][0], out) and torch.equal(got[bf, True][1], out_b)
    assert torch.equal(got[torch.float32, False][1], out_b) and torch.equal(got[bf, False][1], out_b)
    again = torch.empty_like(out)
    ck.gemm(ck.LAYER_NORM, a, w, bias, again, M=m, res=res, ln_s=ln_s, ln_b=ln_b, row_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.parametrize("bsz,frames", [(64, 120), (128, 30)])
def test_graphed_window_equals_eager_at_the_benchmark_step_shapes(card, monkeypatch, bsz, frames):
    """A bf16 window replayed from the captured step (the cluster launches
    inside the graph) equals the eager window bit for bit at the step
    shapes the benchmark runs: 64 windows of 121 tokens and the 128 x 31
    tail."""
    diff = CondGaussianDiffusion(DiffusionConfig(compute_dtype="bfloat16"), device=card, seed=0)
    g = torch.Generator(device=card).manual_seed(5)
    d = diff.cfg.d_feats
    x_start = torch.randn(bsz, frames, d, generator=g, device=card).clamp(-1, 1)
    cond_mask = torch.zeros_like(x_start)
    cond_mask[..., : d // 2] = 1.0

    def window():
        before = dict(ck.kernel_launches), dict(ck.step_graphs)
        x = fs.fused_p_sample_loop(diff, x_start, cond_mask, None, noise=fs.TorchNoise(card, seed=11))
        torch.cuda.synchronize()
        return x, [{key: v - b.get(key, 0) for key, v in dict(c).items() if v != b.get(key, 0)}
                   for c, b in zip((ck.kernel_launches, ck.step_graphs), before)]

    with monkeypatch.context() as mp:
        mp.setattr(fs, "graphs_engage", lambda device, prep: False)
        x_eager, (launches, graphs) = window()
    assert graphs == {"eager": diff.cfg.timesteps}
    x_graph, (g_launches, g_graphs) = window()
    assert g_graphs.get("replayed") == diff.cfg.timesteps and "eager" not in g_graphs
    assert g_launches == launches
    assert torch.equal(x_graph, x_eager)
