"""The readers of the program's own spans and counters
(``bench/program_trace.py``): nothing to read without a trace, in another
kind of cell, or from a program that has no spans; on a tiny traced
training cell every one of them reads, and the step's phases fit inside
the step."""

import sys

import pytest
import torch

import repro_torch.core
from bench import harness, tracing
from bench.tests import tiny_root
from repro_torch.core import trace

STEP = ["step.host_ms", "step.sample_ms"]
BUILD = ["build.kmeans_pass_s", "build.read_wait_s"]


def _reader(name):
    return harness.load_reader(tiny_root.ROOT / "bench", name)


def _ctx(kind="epochs", traced=True):
    return {"cfg": {}, "traffic": {"kind": kind}, "counts": None,
            "window": {"units": 1, "stage_s": [{"kmeans": 2.0, "knn": 1.0}]},
            "trace": {"window_s": 1.0, "busy_s": 0.1} if traced else None}


@pytest.fixture
def filled():
    """Counters and span totals as a traced epoch cell leaves them."""
    trace.reset()
    trace.count("kmeans.passes", 4)
    trace.count("stream.read_wait_s", 0.25)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with trace.span("nomad.step"):
                for name in ("nomad.step.sample", "nomad.step.k1", "nomad.step.scatter"):
                    with trace.span(name):
                        torch.ones(4).sum()
    yield
    trace.reset()


def test_readers_read_the_program(filled):
    got = {name: _reader(name)(_ctx()) for name in STEP + BUILD}
    totals = trace.span_totals()
    assert got["step.host_ms"] == pytest.approx(1e3 * totals["nomad.step"][1] / 3)
    assert got["step.sample_ms"] == pytest.approx(1e3 * totals["nomad.step.sample"][1] / 3)
    assert 0 < got["step.sample_ms"] <= got["step.host_ms"]
    assert got["build.kmeans_pass_s"] == pytest.approx(0.5) and got["build.read_wait_s"] == pytest.approx(0.25)


@pytest.mark.parametrize("name", STEP + BUILD)
def test_nothing_to_read_without_a_trace_or_in_another_kind(filled, name):
    read = _reader(name)
    assert read(_ctx(traced=False)) is None
    for kind in ("builds", "queries"):
        assert read(_ctx(kind)) is None


@pytest.mark.parametrize("name", STEP + BUILD)
def test_a_program_without_spans_reads_nothing(filled, name, monkeypatch):
    monkeypatch.delattr(repro_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert _reader(name)(_ctx()) is None


def test_nothing_counted_reads_nothing():
    trace.reset()
    assert all(_reader(name)(_ctx()) is None for name in STEP + BUILD)


def test_a_tiny_traced_training_cell_reads_every_one(tmp_path):
    root = tiny_root.make(tmp_path)
    trace.reset()
    out, parts = tiny_root.run(root, "tiny.train", trace=True)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(STEP + BUILD) <= set(got)
    assert sum(got[n] for n in STEP[1:]) < got["step.host_ms"]
    assert got["build.read_wait_s"] >= 0
    passes = trace.counts()["kmeans.passes"]
    assert passes >= 2
    assert got["build.kmeans_pass_s"] * passes == pytest.approx(parts["build_stage_s"]["kmeans"], abs=6e-4)


def test_idle_gaps_are_keyed_by_the_program_spans():
    """``tracing.summarise`` keys a gap by the innermost host event open at
    its middle on the benchmark's thread: a program span where no op is
    open under it."""
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}

    events = [
        x("user_annotation", "bench.epoch", 0, 100),
        x("user_annotation", "nomad.step", 0, 90),
        x("user_annotation", "nomad.step.sample", 0, 20),
        x("user_annotation", "nomad.step.k1", 20, 50),
        x("cpu_op", "aten::mm", 22, 6),
        x("user_annotation", "nomad.step.scatter", 70, 20),
        x("kernel", "k", 0, 10, tid=7),
        x("kernel", "k", 20, 4, tid=7),
        x("kernel", "k", 30, 40, tid=7),
        x("kernel", "k", 80, 4, tid=7),
    ]
    gaps = dict(tracing.summarise(events, "bench.epoch")["idle_gaps"])
    assert gaps == {"bench.epoch:nomad.step.sample": pytest.approx(10e-6),  # [10, 20)
                    "bench.epoch:aten::mm": pytest.approx(6e-6),  # [24, 30)
                    "bench.epoch:nomad.step.scatter": pytest.approx(10e-6),  # [70, 80)
                    "bench.epoch:(host between ops)": pytest.approx(16e-6)}  # [84, 100), middle 92
