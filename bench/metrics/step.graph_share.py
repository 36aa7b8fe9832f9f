"""step.graph_share: the share of the epoch loop's SGD steps that replayed
the program's captured CUDA graph of the step, over the run's epochs (the
set-up's, the window's and the profiled ones): the program's counters
``nomad.step.graphed`` over it and ``nomad.step.eager`` together, in %."""

from bench.program_trace import _trace


def read(ctx):
    trace = _trace()
    if trace is None or not ctx["trace"] or ctx["traffic"]["kind"] != "epochs":
        return None
    counts = trace.counts()
    graphed, eager = counts.get("nomad.step.graphed", 0), counts.get("nomad.step.eager", 0)
    return 100.0 * graphed / (graphed + eager) if graphed + eager else None
