"""The tile counter of the bf16 QKV and w1 launches (ops/cuda_kernels.py
``gemm_tiles``, csrc/gemm.cu launch_wgmma) on the CPU: the arithmetic of
``bias_tiles`` at the benchmark cells' shapes, counted through
``count_gemm`` as the C entry reports a launch, and read by the
benchmark's ``hidden_epilogue_pct``. A tile's stores run under the next
tile's products on the same block, so every tile but a block's last is
hidden: none where the tiles do not outnumber the SMs.

    python -m pytest tests/test_torch_gemm_tiles.py -q
"""

from types import SimpleNamespace

import pytest

from benchmark import spec
from egoego_release_tpu_torch.ops import cuda_kernels as ck

SMS = 132  # an H100's SMs
QKV, W1 = 3072, 512  # N of the QKV and w1 products at d_model 512


def launch(mode, m, n, sms=SMS):
    """The struct of one bf16 launch on the wgmma kernel, as egoego_gemm
    leaves it: the kernel, the mode, the tiles and the grid."""
    tiles, grid = ck.bias_tiles(m, n, sms)
    return ck.GemmArgs(M=m, N=n, K=512, mode=mode, compute_bf16=1, kernel=ck.GEMM_KERNELS.index("gemm_wgmma"),
                       tiles=tiles, grid=grid)


@pytest.fixture
def counters(monkeypatch):
    """Fresh kernel counters for the test."""
    for name in ("kernel_launches", "gemm_modes", "gemm_tiles"):
        monkeypatch.setattr(ck, name, type(getattr(ck, name))())
    return ck


# (M, N): (tiles, hidden tiles)
@pytest.mark.parametrize("m,n,tiles,hidden", [
    (64 * 121, QKV, 732, 600), (64 * 121, W1, 122, 0),  # eval: 64 windows of 121 tokens
    (128 * 121, QKV, 1452, 1320), (128 * 121, W1, 242, 110),  # captures' full windows
    (128 * 31, QKV, 372, 240), (128 * 31, W1, 62, 0),  # captures' 30-frame tail
    (64 * 121, QKV // 2, 366, 234), (64 * 121, W1 // 2, 61, 0),  # a tp 2 shard's QKV and w1
    (121, QKV, 12, 0), (31, QKV, 12, 0), (93, W1, 2, 0)])  # the tools at batch 1; a ragged edge
def test_bias_tiles_hide_all_but_each_blocks_last(m, n, tiles, hidden):
    got_tiles, grid = ck.bias_tiles(m, n, SMS)
    assert (got_tiles, got_tiles - grid) == (tiles, hidden)
    assert grid <= SMS and (hidden == 0) == (tiles <= SMS)


@pytest.mark.parametrize("cell,want", [("eval", 70.3), ("captures", 82.7)])
def test_hidden_share_at_the_cells_shapes(counters, cell, want):
    """A reverse step runs QKV and w1 in each of its 4 layers; eval runs
    its steps at 64 x 121 tokens, captures 4 windows at 128 x 121 and the
    tail at 128 x 31 for as many steps each."""
    windows = {"eval": [64 * 121], "captures": [128 * 121] * 4 + [128 * 31]}[cell]
    for m in windows:
        for _ in range(4):
            ck.count_gemm(launch(ck.BIAS, m, QKV))
            ck.count_gemm(launch(ck.BIAS_RELU, m, W1))
    assert counters.kernel_launches == {"gemm_wgmma": 8 * len(windows)}
    assert counters.gemm_modes == {ck.BIAS: 4 * len(windows), ck.BIAS_RELU: 4 * len(windows)}
    share = spec.reader("hidden_epilogue_pct")(SimpleNamespace())
    assert share == pytest.approx(100 * ck.gemm_tiles["bias_hidden"] / ck.gemm_tiles["bias"])
    assert round(share, 1) == want


def test_only_bf16_bias_launches_count_tiles(counters):
    """The other modes and the f32 kernel leave the tile counter alone."""
    args = launch(ck.BIAS, 64 * 121, QKV)
    for mode in (ck.LAYER_NORM, ck.STEM, ck.STEP, ck.PARTIAL):
        args.mode = mode
        ck.count_gemm(args)
    args.mode, args.kernel = ck.BIAS, ck.GEMM_KERNELS.index("gemm_tf32x3")
    ck.count_gemm(args)
    assert not counters.gemm_tiles and sum(counters.kernel_launches.values()) == 5
    assert spec.reader("hidden_epilogue_pct")(SimpleNamespace()) is None
