"""The reader of the epoch loop's step counters, ``step.graph_share``:
graphed steps over all steps, in %; nothing to read without a trace, in
another kind of cell, from a program without the counters, or where no
step was counted; on the CPU every step of a tiny traced training cell
runs eagerly."""

import sys

import pytest

import repro_torch.core
from bench import harness
from bench.tests import tiny_root
from repro_torch.core import trace


def _read(ctx):
    return harness.load_reader(tiny_root.ROOT / "bench", "step.graph_share")(ctx)


def _ctx(kind="epochs", traced=True):
    return {"cfg": {}, "traffic": {"kind": kind}, "counts": None, "window": {"units": 1, "stage_s": [{}]},
            "trace": {"window_s": 1.0, "busy_s": 0.1} if traced else None}


@pytest.fixture
def counted():
    trace.reset()
    trace.count("nomad.step.eager", 3)
    trace.count("nomad.step.graphed", 364)
    trace.count("nomad.step.graphed", 367)
    yield
    trace.reset()


def test_the_share_of_graphed_steps(counted):
    assert _read(_ctx()) == pytest.approx(100.0 * 731 / 734)


@pytest.mark.parametrize("kind,traced", [("epochs", False), ("builds", True), ("queries", True)])
def test_nothing_to_read_without_a_trace_or_in_another_kind(counted, kind, traced):
    assert _read(_ctx(kind, traced)) is None


def test_a_program_without_the_counters_reads_nothing(counted, monkeypatch):
    monkeypatch.delattr(repro_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert _read(_ctx()) is None


def test_nothing_counted_reads_nothing():
    trace.reset()
    assert _read(_ctx()) is None


def test_a_tiny_traced_training_cell_on_the_cpu_runs_every_step_eagerly(tmp_path):
    root = tiny_root.make(tmp_path)
    trace.reset()
    out, _ = tiny_root.run(root, "tiny.train", trace=True)
    assert out["metrics"]["step.graph_share"]["value"] == 0.0
    assert trace.counts()["nomad.step.eager"] > 0
