"""What the per-layer readers take from the program's own spans and
counters (``repro_torch.core.trace``). A program without them (an older
checkout) gives nothing to read, and each reader returns ``None``.

The span totals are host seconds the program adds up while the profiler
records, so in a ``--trace 1`` run they cover the profiled slice alone.
The counters are the process's: in a cell of kind ``epochs`` the process
runs one index build, in set-up, and the window's ``stage_s`` holds that
build's stage seconds.
"""

from __future__ import annotations


def _trace():
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace


def step_ms(ctx, name: str):
    """The host milliseconds of the span ``name`` a step of the profiled
    epochs: its seconds over the count of ``nomad.step`` spans."""
    trace = _trace()
    if trace is None or not ctx["trace"] or ctx["traffic"]["kind"] != "epochs":
        return None
    totals = trace.span_totals()
    steps = totals.get("nomad.step", [0, 0.0])[0]
    if not steps or name not in totals:
        return None
    return 1e3 * totals[name][1] / steps


def build_counter(ctx, name: str):
    """The counter ``name`` over the set-up's one build of an ``epochs``
    cell, or ``None``."""
    trace = _trace()
    if trace is None or not ctx["trace"] or ctx["traffic"]["kind"] != "epochs" or len(ctx["window"]["stage_s"]) != 1:
        return None
    return trace.counts().get(name)
