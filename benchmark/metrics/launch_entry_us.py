"""Step and launch wrappers with the host side of csrc/*.cu's launch code:
host us a reverse step from the C entries' calls to their returns (the
stream, the device guard, the ctypes call, the TMA maps and attributes the
entry sets, the launch), from the program's spans in the profiled group:
the summed ``launch.entry`` spans inside ``step`` spans over the number of
``step`` spans."""

from benchmark import program_spans


def read(ctx):
    found = program_spans.step_launches(ctx)
    if found is None:
        return None
    sp, steps = found
    return program_spans.total_us(sp, "launch.entry", parent="step") / steps
