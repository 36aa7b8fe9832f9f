"""step.sample_ms: the host milliseconds a step spends drawing its rows
(the program's ``nomad.step.sample`` spans: the step's generator and the
sampler) in the profiled epochs, over the count of steps."""

from bench.program_trace import step_ms


def read(ctx):
    return step_ms(ctx, "nomad.step.sample")
