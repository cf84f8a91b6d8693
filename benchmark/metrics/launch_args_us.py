"""Step and launch wrappers (ops/cuda_kernels.py): host us a reverse step in
the launches' checks and argument structs, from the program's own spans
(utils/trace.py) in the profiled group: the summed ``launch.args`` spans
inside ``step`` spans over the number of ``step`` spans."""

from benchmark import program_spans


def read(ctx):
    found = program_spans.step_launches(ctx)
    if found is None:
        return None
    sp, steps = found
    return program_spans.total_us(sp, "launch.args", parent="step") / steps
