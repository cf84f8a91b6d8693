"""Step and launch wrappers: kernel launches of the C entries per reverse
step over the window, from the program's own counter
(ops/cuda_kernels.py ``kernel_launches``)."""


def read(ctx):
    steps = len(ctx.spans["denoise_step"])
    return sum(ctx.launches.values()) / steps if steps and ctx.launches else None
