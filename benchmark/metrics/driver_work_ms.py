"""Eval driver (eval/pipeline.py ``run_batches_pipelined``): the driver's own
host ms a batch, without its waits, from the program's spans in the
profiled group: the summed top-level ``driver.*`` spans (prefetch,
prechain, chain, metrics, copy, collect) less ``driver.chain`` (the
sampler's) and ``driver.wait`` (the wait for the batch's copy), over the
number of ``driver.chain`` spans."""

from benchmark import program_spans


def read(ctx):
    sp = program_spans.load(ctx)
    if sp is None or not program_spans.count(sp, "driver.chain"):
        return None
    own = program_spans.total_us(sp, program_spans.DRIVER) - program_spans.total_us(sp, ("driver.chain", "driver.wait"))
    return own / program_spans.count(sp, "driver.chain") / 1e3
