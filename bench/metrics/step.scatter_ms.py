"""step.scatter_ms: the host milliseconds a step spends in its three
``index_put_`` scatters into θ (the program's ``nomad.step.scatter``
spans) in the profiled epochs, over the count of steps."""

from bench.program_trace import step_ms


def read(ctx):
    return step_ms(ctx, "nomad.step.scatter")
