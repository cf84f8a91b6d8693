"""The readers of the program's spans (benchmark/program_spans.py and
metrics/launch_args_us.py, launch_entry_us.py, step_other_us.py,
driver_work_ms.py, idle_in_launches_pct.py) on a synthetic profiled group:
spans recorded through the program's recorder on a set clock, device
operations written out. Each gives its exact value, and None where it finds
nothing to read.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.devtime import Trace
from egoego_release_tpu_torch.utils import trace

NAMES = ("launch_args_us", "launch_entry_us", "step_other_us", "driver_work_ms", "idle_in_launches_pct")
BASE_US = 1_790_000_000_000_000  # an epoch time, in us, as the profiler's events carry
LO, HI = BASE_US, BASE_US + 1000
# the profiled group's device operations, us after BASE_US; the last runs past its end
DEVICE = [("k1", 0, 140), ("k2", 170, 220), ("k3", 205, 215), ("k4", 400, 1200)]


@pytest.fixture
def clock(monkeypatch):
    """Set the recorder's clock with at(us after BASE_US)."""
    now = [0]
    monkeypatch.setattr(trace, "now", lambda: (BASE_US + now[0]) * 1000)
    trace.clear()
    trace.enable()
    yield lambda us: now.__setitem__(0, us)
    trace.disable()
    trace.clear()


def record(at, launches=True):
    """One batch in the group and a chain after it; times in us:
    prefetch 10-60, prechain 60-70, chain 70-700 (window 80-600, its loop
    100-500: step 120-300 with launches args 130-150 / entry 150-200 and
    200-210 / 210-260, step 300-480 with 310-330 / 330-380), metrics
    700-760, copy 760-770, collect 770-900 (wait 780-880); a chain
    1100-1200 past the group's end."""
    def span(name, a, b, batch=-1, inner=lambda: None):
        at(a)
        row = trace.begin(name, batch)
        inner()
        at(b)
        trace.end(row)

    def launch(a, b, c):
        if launches:
            at(c)
            trace.launch("gemm_wgmma", (BASE_US + a) * 1000, (BASE_US + b) * 1000)

    def loop():
        span("step", 120, 300, inner=lambda: (launch(130, 150, 200), launch(200, 210, 260)))
        span("step", 300, 480, inner=lambda: launch(310, 330, 380))

    span("driver.prefetch", 10, 60, 0)
    span("driver.prechain", 60, 70, 0)
    span("driver.chain", 70, 700, 0, lambda: span("window", 80, 600, inner=lambda: span("window.loop", 100, 500,
                                                                                          inner=loop)))
    span("driver.metrics", 700, 760, 0)
    span("driver.copy", 760, 770, 0)
    span("driver.collect", 770, 900, 0, lambda: span("driver.wait", 780, 880))
    span("driver.chain", 1100, 1200, 1)


def ctx_of(device=DEVICE):
    return SimpleNamespace(trace=Trace(device=[(n, BASE_US + a, BASE_US + b) for n, a, b in device], lo=LO, hi=HI))


def read_all(ctx):
    return {n: spec.reader(n)(ctx) for n in NAMES}


def test_each_reader_gives_its_exact_value(clock):
    record(clock)
    got = read_all(ctx_of())
    # 2 steps; launch.args 20 + 10 + 20 us; launch.entry 50 + 50 + 50 us; the loop 400 us
    assert got["launch_args_us"] == pytest.approx(25.0, abs=1e-6)
    assert got["launch_entry_us"] == pytest.approx(75.0, abs=1e-6)
    assert got["step_other_us"] == pytest.approx(100.0, abs=1e-6)
    assert got["launch_args_us"] + got["launch_entry_us"] + got["step_other_us"] == pytest.approx(400.0 / 2)
    # 50 + 10 + 630 + 60 + 10 + 130 less the chain (630) and the wait (100), one batch
    assert got["driver_work_ms"] == pytest.approx(0.160, abs=1e-9)
    # launches 200 us, busy in them 10 (k1) + 30 + 10 + 10 (k2 with k3): 140 us idle of 1000
    assert got["idle_in_launches_pct"] == pytest.approx(14.0, abs=1e-6)


def test_readers_find_nothing_without_spans_or_device_operations(clock, monkeypatch):
    assert read_all(ctx_of()) == dict.fromkeys(NAMES)  # no span recorded
    record(clock, launches=False)  # as on the CPU: no launch span
    got = read_all(ctx_of())
    assert got["driver_work_ms"] == pytest.approx(0.160, abs=1e-9)
    assert {n: v for n, v in got.items() if n != "driver_work_ms"} == dict.fromkeys(NAMES[:3] + NAMES[4:])
    trace.clear()
    record(clock)
    got = read_all(ctx_of(device=[]))
    assert got["idle_in_launches_pct"] is None and got["launch_args_us"] == pytest.approx(25.0, abs=1e-6)
    # a program without the recorder (the parent of the commit that added it)
    import egoego_release_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "egoego_release_tpu_torch.utils.trace", None)
    assert read_all(ctx_of()) == dict.fromkeys(NAMES)
