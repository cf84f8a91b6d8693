"""Step and launch wrappers: the share of the profiled group's wall time in
which the card was idle while the host was inside a launch span
(``launch.args`` or ``launch.entry`` of a reverse step), in %: the part of
the card's idle time that the launches' host side holds. The device
operations come from the profile (``ctx.trace.device``), the spans from the
program (utils/trace.py), on one clock."""

import numpy as np

from benchmark import program_spans


def read(ctx):
    found = program_spans.step_launches(ctx)
    if found is None or not ctx.trace.device:
        return None
    sp, _ = found
    sel = np.isin(sp["name"], program_spans.LAUNCH) & (sp["parent"] == "step")
    lo, hi = ctx.trace.lo, ctx.trace.hi
    starts, ends = sp["start"][sel], sp["end"][sel]
    idle = float(sp["dur"][sel].sum() - program_spans.busy_in(ctx.trace.device, lo, hi, starts, ends).sum())
    return idle / (hi - lo) * 100.0
