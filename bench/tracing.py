"""A bounded profiled slice of a cell's work, reduced to what the per-layer
metrics read: device-busy time as the union of device intervals, device
time by kernel name, and the idle gaps keyed by what the host was doing.

The slice runs after the measured window, so the window is never traced.
Each unit of work runs inside a span the benchmark opens
(``torch.profiler.record_function``); a gap between device intervals is
keyed by that span and the innermost host operation open at its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def profile_slice(run_unit, n_units: int, span: str, on_cuda: bool) -> dict:
    """Run ``run_unit`` ``n_units`` times under the profiler and summarise
    the trace (see :func:`summarise`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(n_units):
            with record_function(span):
                run_unit()
        if on_cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = summarise(events, span)
    out["units"] = n_units
    return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarise(events: list, span: str) -> dict:
    """From chrome-trace events (µs): ``window_s`` from the first span's
    start to the last span's end, ``busy_s`` the union of device intervals
    inside it, ``kernels`` {name: [count, seconds]}, ``device_ops`` and
    ``idle_gaps`` (at most 10 each, largest first, as [name, seconds])."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == span]
    if not spans:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "device_ops": [], "idle_gaps": []}
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in spans)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in dev:
        a, d = float(e["ts"]), float(e.get("dur", 0))
        kernels[e["name"]][0] += 1
        kernels[e["name"]][1] += d * 1e-6
        a, b = max(a, w0), min(a + d, w1)
        if b > a:
            intervals.append((a, b))
    merged = _merge(intervals)
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps, cur = [], w0
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, _host_at([(a + b) / 2 for a, b in gaps], events, span)):
        idle[f"{span}:{name}"] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy,
        "kernels": dict(kernels),
        "device_ops": [[name[:120], secs] for name, (_n, secs) in top],
        "idle_gaps": [[name[:120], secs] for name, secs in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def _host_at(times, events, span):
    """The innermost host operation open at each of the (sorted) ``times``
    on the thread that opened the spans: a sweep over nested intervals."""
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == span]
    tid = spans[0].get("tid") if spans else None
    ops = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]) for e in events
         if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("tid") == tid and e.get("name") != span),
        key=lambda o: (o[0], -o[1]),
    )
    order = sorted(range(len(times)), key=lambda i: times[i])
    names = ["(host between ops)"] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            names[i] = stack[-1][2]
    return names
