"""The profiled slice's reduction: busy time is the union of device
intervals inside the benchmark's spans, not their sum; idle gaps are keyed
by the innermost host operation open at their middle."""

import pytest

from bench import tracing


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_busy_is_the_union_and_gaps_are_keyed_by_host_ops():
    events = [
        _x("user_annotation", "bench.unit", 0, 100),
        _x("cpu_op", "aten::index_put_", 10, 30),
        _x("cpu_op", "aten::sort", 15, 5),
        _x("kernel", "k_a", 0, 10, tid=7),
        _x("kernel", "k_b", 5, 10, tid=7),  # overlaps k_a: the union is [0, 15)
        _x("kernel", "k_a", 60, 20, tid=7),
        _x("gpu_memcpy", "Memcpy HtoD", 200, 50, tid=7),  # outside the span
    ]
    s = tracing.summarise(events, "bench.unit")
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["kernels"]["k_a"] == [2, pytest.approx(30e-6)]
    assert s["device_ops"][0] == ["Memcpy HtoD", pytest.approx(50e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["bench.unit:aten::index_put_"] == pytest.approx(45e-6)  # [15, 60), middle 37.5
    assert gaps["bench.unit:(host between ops)"] == pytest.approx(20e-6)  # [80, 100)


def test_no_span_reads_nothing():
    s = tracing.summarise([_x("kernel", "k", 0, 5)], "bench.unit")
    assert s["busy_s"] == 0.0 and s["window_s"] == 0.0
