"""Step and launch wrappers (ops/fused_step.py, ops/cuda_kernels.py): host
ms inside ``fused_denoise_step`` per reverse step, waits for the card
included (when the card paces, the launch queue fills and the host waits
in it)."""


def read(ctx):
    s = ctx.spans["denoise_step"]
    return sum(s) / len(s) * 1e3 if s else None
