"""The work model of benchmark/flops.py against counts written out by hand."""

from __future__ import annotations

import json

import pytest

from benchmark import flops, spec

CFG = json.loads((spec.HERE / "configs" / "egoego_stage2_bf16.json").read_text())


def by_hand(t_data: int, batch: int) -> int:
    """tools/chain_mfu.py forward_flops at the release widths, times the batch."""
    tok = t_data + 1
    stem = 2 * 2 * t_data * 198 * 512
    layer = 2 * tok * 512 * 3 * 4 * 256 + 2 * 4 * tok * tok * 512 + 2 * tok * 4 * 256 * 512 + 4 * tok * 512 * 512
    return batch * (stem + 4 * layer + 2 * t_data * 512 * 198)


def test_a_release_step_is_182_4_gflop():
    assert flops.step_flops(CFG, 64, 120) == by_hand(120, 64)
    assert round(flops.step_flops(CFG, 64, 120) / 1e9, 1) == 182.4


def test_the_tail_window_counts_by_the_same_formula():
    # the 470-frame capture's tail: 30 frames, 31 tokens
    assert flops.chain_windows(CFG, 470) == [120, 120, 120, 120, 30]
    assert flops.step_flops(CFG, 16, 30) == by_hand(30, 16)


@pytest.mark.parametrize("compute, peak, element", [("tf32", 495e12, 4), ("bf16", 989e12, 2)])
def test_least_time_takes_the_larger_bound_of_each_launch(compute, peak, element):
    """The bf16 configuration as it is, and its widths computed in f32 (on the
    TF32 peak, 4-byte elements)."""
    cfg = {**CFG, "peak": compute, "element_bytes": element}
    assert flops.PEAK_FLOPS[cfg["peak"]] == peak
    launches = flops.step_launches(cfg, 64, 120)
    assert len(launches) == 2 + 5 * cfg["n_dec_layers"]
    want = sum(max(ops / peak, nbytes / 3.35e12) for _, ops, nbytes in launches)
    assert flops.step_least_seconds(cfg, 64, 120) == pytest.approx(want)
    qkv = dict((n, (o, b)) for n, o, b in launches)["qkv0"]
    assert qkv == (2 * 64 * 121 * 512 * 3072, element * (64 * 121 * 512 + 3072 * 512 + 64 * 121 * 3072))
