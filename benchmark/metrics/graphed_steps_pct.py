"""Step and launch wrappers (ops/fused_step.py): the share of the run's
reverse steps on the card that replayed a captured CUDA graph, in %, from
the program's ``step_graphs`` counter (ops/cuda_kernels.py): replayed over
replayed plus eager. The counter is the process's own (warm-up, window and
profiled group), which run the same shapes on the same path. None where the
program has no such counter or ran no step on the card."""


def read(ctx):
    try:
        from egoego_release_tpu_torch.ops import cuda_kernels as ck
    except ImportError:
        return None
    counts = getattr(ck, "step_graphs", None)
    if counts is None:
        return None
    steps = counts.get("replayed", 0) + counts.get("eager", 0)
    return counts.get("replayed", 0) / steps * 100.0 if steps else None
