"""The port's kernel plumbing under threads: the service launches kernels
from worker threads, two batchers at once during a hot swap.

* ``_build.load`` builds and loads a library once, whichever of several
  threads asks first (one module lock over ``build`` and ``load``; the
  temporary file is named by pid and thread id);
* a launch count never loses an increment (``registry.count_launch``
  under a lock), and every CUDA wrapper counts through it.

A lost race is too rare to show reliably, so the tests pin the locks:
the build is slowed down to widen the window, and the count is hammered.
"""

from __future__ import annotations

import re
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build, registry  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


class _StubLib:
    """What ``ctypes.CDLL`` returns: one attribute per entry point, each
    taking ``argtypes``/``restype``."""

    def __init__(self, path):
        self.path = path
        for fn in _build.SIGNATURES["pairwise"]:
            setattr(self, fn, type("Entry", (), {})())


def test_load_builds_once_across_threads(monkeypatch, tmp_path):
    calls = []

    def slow_build(names=_build.SOURCES):
        calls.append(tuple(names))
        time.sleep(0.05)  # a build takes seconds: widen the window
        return {n: tmp_path / f"lib{n}.so" for n in names}

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", _StubLib)
    monkeypatch.setattr(_build, "_LOADED", {})
    start = threading.Barrier(8)
    got, errs = [None] * 8, []

    def go(i):
        try:
            start.wait()
            got[i] = _build.load("pairwise")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert calls == [("pairwise",)]
    assert all(lib is got[0] for lib in got)
    entry = getattr(got[0], "pairwise_dist2_f32")
    assert entry.argtypes == _build.SIGNATURES["pairwise"]["pairwise_dist2_f32"]


def test_temporary_library_named_by_pid_and_thread(monkeypatch, tmp_path):
    """Two threads building one source at once write two temporary files."""
    started = []
    both = threading.Barrier(2)  # both threads alive at once: no reused thread id

    class _Proc:
        def __init__(self, cmd, **_kw):
            started.append(cmd[cmd.index("-o") + 1])
            both.wait(10)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _Proc)
    threads = [threading.Thread(target=_build._start, args=("pairwise",)) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(started) == 2 and started[0] != started[1]
    assert all(re.search(r"\.\d+-\d+\.tmp$", p) for p in started)


def test_count_launch_loses_nothing_across_threads():
    kernel = registry.Kernel("probe", plain=None, cuda=None, source="", replaces="")
    start = threading.Barrier(16)

    def go():
        start.wait()
        for _ in range(10_000):
            registry.count_launch(kernel)

    threads = [threading.Thread(target=go) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernel.launches == 160_000


def test_every_cuda_wrapper_counts_through_the_helper():
    ops = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*/ops.py"))
    counted = {p.parent.name: len(re.findall(r"registry\.count_launch\(", p.read_text())) for p in ops}
    bare = [str(p) for p in ops if re.search(r"\.launches\s*\+=", p.read_text())]
    assert not bare, bare
    # one count per CUDA entry: the pairs count each direction; capacity_admit
    # has no kernel (jnp-only in the reference)
    assert counted == {"capacity_admit": 0, "cauchy_mean": 2, "frozen_attract": 2, "kmeans_assign": 1,
                       "nomad_step": 2, "pairwise": 1}
