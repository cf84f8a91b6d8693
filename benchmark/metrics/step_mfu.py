"""Whole step: the useful denoiser operations of the window's reverse steps
(real tokens: 182.4 GFLOP a step at 64 x 121) over the window's wall time
and the configuration's peak, in % (benchmark/flops.py)."""


def read(ctx):
    if not ctx.batches:
        return None
    ops = ctx.batches * sum(steps * ctx.flops.step_flops(ctx.cfg, b, td) for b, td, steps in ctx.work)
    return ops / ctx.window_s / ctx.flops.PEAK_FLOPS[ctx.cfg["peak"]] * 100.0
