"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of its sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused. ``ptxas``'s
register and shared-memory report is kept beside it as ``<lib>.log``.
Nothing is built at import: the first launch builds what it needs, and
:func:`build` with no argument builds every kernel at once, one nvcc
process each. :func:`build` and :func:`load` hold one module lock, so
threads that reach a kernel's first launch together build and load it
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("pairwise", "kmeans_assign", "nomad_step", "cauchy_mean", "frozen_attract")

_V, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points (every pointer and the stream as void*)
SIGNATURES = {
    "pairwise": {"pairwise_dist2_f32": [_V] * 3 + [_I] * 6 + [_V]},
    "kmeans_assign": {"kmeans_assign_f32": [_V] * 6 + [_I] * 5 + [_V]},
    "nomad_step": {
        "nomad_step_fwd_f32": [_V] * 11 + [_I] * 7 + [_V],
        "nomad_step_bwd_f32": [_V] * 11 + [_I] * 4 + [_V],
    },
    "cauchy_mean": {
        "cauchy_mean_fwd_f32": [_V] * 5 + [_I] * 5 + [_V],
        "cauchy_mean_bwd_f32": [_V] * 6 + [_I] * 5 + [_V],
    },
    "frozen_attract": {
        "frozen_attract_fwd_f32": [_V] * 5 + [_I] * 4 + [_V],
        "frozen_attract_bwd_f32": [_V] * 7 + [_I] * 4 + [_V],
    },
}

_LOADED: dict = {}
_LOCK = threading.RLock()  # build() and load(): one thread builds and loads a library


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit is"
        )
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one nvcc; install its library. Returns its error, or ""."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed for csrc/{name}.cu:\n{log}"
    Path(str(out) + ".log").write_text(log)
    os.replace(tmp, out)
    return ""


def build(names=SOURCES) -> dict:
    """Compile the named kernels (all nvcc processes run at once, and all
    are waited for); return {name: library path}. Already-built libraries
    are reused."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        errors = [e for e in (_finish(n, s) for n, s in started.items()) if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def ptxas_report(name: str) -> str:
    log = Path(str(library_path(name)) + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
