"""Kernels (csrc/gemm.cu, csrc/attention.cu, csrc/mha.cu): the least time
of the profiled group's reverse steps over their kernels' device time, in %.
The least time is the sum over each step's products and attention of
max(operations / the configuration's peak, bytes / 3.35 TB/s), counted
from shapes (benchmark/flops.py). The kernels are the device operations
named by the program's launch counter (``kernel_launches``) over the
window; without a profile, their time by held-stream CUDA events."""


def read(ctx):
    least = ctx.profiled_batches * sum(steps * ctx.flops.step_least_seconds(ctx.cfg, b, td)
                                       for b, td, steps in ctx.work)
    if ctx.trace is not None and ctx.trace.device:
        kernel_s = ctx.trace.kernel_us(ctx.step_kernels) / 1e6
    else:
        kernel_s = ctx.held_kernel_s
    return least / kernel_s * 100.0 if kernel_s else None
