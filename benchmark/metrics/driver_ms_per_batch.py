"""Eval driver (eval/pipeline.py ``run_batches_pipelined``): host ms a batch
inside the driver's call and outside its chains' spans (``stage2_generate_batched``):
the GT FK and floors, stage-1 bookkeeping, the metric suite's dispatch and
the collection of each batch's results, waits for the card included."""


def read(ctx):
    s = ctx.spans
    n = len(s["stage2_generate_batched"])
    if not n or not s["run_batches_pipelined"]:
        return None
    return (sum(s["run_batches_pipelined"]) - sum(s["stage2_generate_batched"])) / n * 1e3
