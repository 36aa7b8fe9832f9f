"""step.host_ms: the host milliseconds of one step of the epoch loop in the
profiled epochs: the program's ``nomad.step`` spans, their seconds over
their count."""

from bench.program_trace import step_ms


def read(ctx):
    return step_ms(ctx, "nomad.step")
