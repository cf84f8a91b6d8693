"""Device: the share of the window's wall time in which no kernel, copy or
set ran on the card, in %: the card's busy time a batch (the union of the
device operations of the profiled group, or the step kernels' held-stream
time without a profile) times the window's batches, over the window."""


def read(ctx):
    if not ctx.busy_s or ctx.window_s <= 0:
        return None
    return (1.0 - ctx.busy_s / ctx.window_s) * 100.0
