"""Step wrappers and reverse loop (ops/fused_step.py): host us a reverse
step in the loop outside the launches (a window's set-up, the noise draws,
the allocations and the step's Python), from the program's spans in the
profiled group: (the summed ``window.loop`` spans less the ``launch.args``
and ``launch.entry`` spans inside steps) over the number of ``step`` spans.
With launch_args_us and launch_entry_us it partitions the loop's host
time a step."""

from benchmark import program_spans


def read(ctx):
    found = program_spans.step_launches(ctx)
    if found is None:
        return None
    sp, steps = found
    return (program_spans.total_us(sp, "window.loop")
            - program_spans.total_us(sp, program_spans.LAUNCH, parent="step")) / steps
