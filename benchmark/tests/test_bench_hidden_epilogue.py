"""The reader of metrics/hidden_epilogue_pct.py on a set ``gemm_tiles``
counter: the program's hidden QKV / w1 tiles over all of them, in %, and
None before any such tile or in a program without the counter.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import pytest

from benchmark import spec
from egoego_release_tpu_torch.ops import cuda_kernels as ck


def test_hidden_epilogue_pct_reads_the_tile_counter(monkeypatch):
    read = spec.reader("hidden_epilogue_pct")
    ctx = SimpleNamespace(trace=None)
    monkeypatch.setattr(ck, "gemm_tiles", Counter())
    assert read(ctx) is None
    ck.gemm_tiles.update(bias=4 * (732 + 122), bias_hidden=4 * 600)  # eval's steps at 64 x 121
    assert read(ctx) == pytest.approx(100 * 600 / 854)
    monkeypatch.delattr(ck, "gemm_tiles")
    assert read(ctx) is None
