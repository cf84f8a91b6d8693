"""The program's own spans (``egoego_release_tpu_torch/utils/trace.py``) in
a traced run's profiled group, for the metrics that read them. The
program records them while the profiler records (its recorder turns
itself on at the driver call), on the profiler's clock, so they are read
after the window with the device operations of the same group.

Each reader returns None where this finds nothing: a program without the
recorder, no span in the group, or (for the launch metrics) no launch span
inside a reverse step, as on the CPU."""

from __future__ import annotations

import numpy as np

# the driver's spans of one batch at its top level (eval/pipeline.py);
# driver.stage1 and driver.wait lie inside driver.prefetch and driver.collect
DRIVER = ("driver.prefetch", "driver.prechain", "driver.chain", "driver.metrics", "driver.copy", "driver.collect")
LAUNCH = ("launch.args", "launch.entry")


def load(ctx):
    """The closed spans inside [ctx.trace.lo, ctx.trace.hi] (microseconds on
    the profiler's clock): {"name", "parent" (the parent's name, "" for
    none), "start", "end" (us), "dur" (us, from the nanoseconds)}, or None.
    Kept on ``ctx`` for the next reader."""
    if hasattr(ctx, "program_spans"):
        return ctx.program_spans
    ctx.program_spans = None
    group = getattr(ctx, "trace", None)
    try:
        from egoego_release_tpu_torch.utils import trace
    except ImportError:
        return None
    if group is None or group.hi <= group.lo:
        return None
    rec = trace.spans()
    start, end = rec["start_ns"] / 1e3, rec["end_ns"] / 1e3
    keep = (rec["end_ns"] > 0) & (start >= group.lo) & (end <= group.hi)
    if not keep.any():
        return None
    parent = np.where(rec["parent"] >= 0, rec["name"][np.maximum(rec["parent"], 0)], "")
    ctx.program_spans = {"name": rec["name"][keep], "parent": parent[keep], "start": start[keep], "end": end[keep],
                         "dur": (rec["end_ns"] - rec["start_ns"])[keep] / 1e3}
    return ctx.program_spans


def count(sp, name: str) -> int:
    return int((sp["name"] == name).sum())


def total_us(sp, names, parent: str | None = None) -> float:
    """Summed durations of the spans named in ``names`` (one name or a
    tuple), of those inside a ``parent`` span when given."""
    sel = np.isin(sp["name"], [names] if isinstance(names, str) else list(names))
    if parent is not None:
        sel &= sp["parent"] == parent
    return float(sp["dur"][sel].sum())


def step_launches(ctx):
    """(spans, reverse steps) when the group has launch spans inside its
    steps, else None."""
    sp = load(ctx)
    if sp is None:
        return None
    steps = count(sp, "step")
    if not steps or not (np.isin(sp["name"], LAUNCH) & (sp["parent"] == "step")).any():
        return None
    return sp, steps


def busy_in(device, lo: float, hi: float, starts, ends) -> np.ndarray:
    """For each interval [starts[i], ends[i]] (sorted or not), the time in it
    during which some device operation (name, start, end) ran, within [lo, hi]."""
    dev = np.array([(a, b) for _, a, b in device], dtype=np.float64).reshape(-1, 2)
    s, e = np.clip(dev[:, 0], lo, hi), np.clip(dev[:, 1], lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    if not len(s):
        return np.zeros(len(starts))
    first = np.r_[True, s[1:] > e[:-1]]  # each merged busy run's first operation
    run_s, run_e = s[first], e[np.r_[first[1:], True]]
    done = np.r_[0.0, np.cumsum(run_e - run_s)]

    def busy_to(t):  # busy time in [lo, t]
        i = np.searchsorted(run_s, t, side="right") - 1
        j = np.maximum(i, 0)
        return np.where(i >= 0, done[j] + np.clip(t - run_s[j], 0.0, run_e[j] - run_s[j]), 0.0)

    return busy_to(np.asarray(ends, dtype=np.float64)) - busy_to(np.asarray(starts, dtype=np.float64))
