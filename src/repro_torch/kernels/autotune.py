"""Launch-plan autotuner with a bucketed, source-keyed cache (port of the
JAX package's ``kernels/autotune.py``, its v2 semantics).

For each (kernel, card, shape bucket) the tuner times every plan of the
spec's ``plan_candidates`` on inputs drawn from the signature, by CUDA
events, and records the winner:

* in the process, a dict;
* on disk, JSON at ``$REPRO_TUNE_CACHE`` (default
  ``build/repro_torch/kernel_tune.json`` beside the built kernels, which
  ``.gitignore`` lists), so winners survive across runs.

**A plan must not change a bit of the output.** The port promises fit
determinism across machines, so a sweep runs the default plan first and
rejects every candidate whose outputs differ from it in any bit (reported
with ``"bit_equal": False``, never recorded). Only K2's chunking (min and
argmin are exact and the partials reduce in chunk order) and K3's block
tile (each output's sum over D runs in the same order) offer more than
one plan; K1, K4 and K5's plans fix the order of their sums and are the
only ones offered.

Cache semantics, the reference's:

* **Shape buckets.** Dimensions ≤ 128 key exactly; larger ones round up to
  the next power of two, so N = 49k and N = 50k share one sweep, run at
  the bucket's shape.
* **Source-hash invalidation.** Each entry records a hash of the kernel's
  ``ops.py`` package and ``csrc`` sources; an entry whose hash no longer
  matches is ignored at load.
* **Versioned envelope** ``{"version": 2, "entries": {...}}``. Corrupt,
  truncated or foreign files are ignored and rewritten at the next store;
  stores are read-modify-write with an atomic replace, so racing writers
  each leave a valid file (the last wins).

**Who reads it.** K2's and K3's wrappers, called without a plan (as
``registry.dispatch`` and every path of the port call them), take it from
:func:`plan_for`: the cached winner of the call's bucket on this card,
else the spec's default plan at the call's own shape (the plan the
wrapper chose before the tuner existed).

**Who writes it.** With ``REPRO_AUTOTUNE=1`` :func:`plan_for` sweeps a
bucket it has no winner for, on first sight, and stores the winner; unset
or ``0`` it only reads. Sweeping is opt-in, unlike the reference (which
sweeps whenever Pallas compiles), so that a fit or a served batch never
pays for a sweep in the middle of its own timing. Sweep launches are not
counted (``registry.uncounted``).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.registry import KernelSpec, ShapeSig, output_leaves, uncounted

CACHE_VERSION = 2
_SWEEP_REPS = 5  # timed calls a candidate, after one warm-up call
_CSRC = Path(__file__).resolve().parent.parent / "csrc"

_memory_cache: dict[str, dict] = {}
_disk_loaded_from: Optional[str] = None


@functools.lru_cache(maxsize=None)
def _default_cache_path() -> str:
    from repro_torch.kernels._build import BUILD_DIR

    return str(BUILD_DIR / "kernel_tune.json")


def cache_path() -> str:
    path = os.environ.get("REPRO_TUNE_CACHE")
    return _default_cache_path() if path is None else path


# ---------------------------------------------------------------------------
# Cache keys: shape buckets, the card, the kernel's source hash
# ---------------------------------------------------------------------------


def bucket_dim(n: int) -> int:
    """≤ 128 exact; above, the next power of two (49k and 50k → 65536)."""
    n = int(n)
    if n <= 128:
        return n
    p = 128
    while p < n:
        p *= 2
    return p


def bucket_sig(sig: ShapeSig) -> ShapeSig:
    """Every dimension of every argument bucketed (dtypes key exactly)."""
    return tuple((tuple(bucket_dim(d) for d in shape), dt) for shape, dt in sig)


@functools.lru_cache(maxsize=None)
def _card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def card_name(device) -> str:
    """The key's card: ``torch.cuda.get_device_name`` for a CUDA device,
    else the device type."""
    return _card_name(torch.device(device))


@functools.lru_cache(maxsize=4096)
def cache_key(name: str, card: str, sig: ShapeSig) -> str:
    return f"{name}|{card}|{bucket_sig(sig)!r}"


@functools.lru_cache(maxsize=None)
def _files_hash(paths: tuple) -> str:
    h = hashlib.sha256()
    for p in paths:
        try:
            h.update(os.path.basename(p).encode())
            h.update(Path(p).read_bytes())
        except OSError:
            return "unknown"
    return h.hexdigest()[:16]


def source_hash(spec: KernelSpec) -> str:
    """Hash of the kernel package's ``.py`` sources and the ``csrc`` files
    of its kernel (the ``.cu`` and every header it includes)."""
    if spec.cuda is None:
        return "plain-only"
    from repro_torch.kernels import registry

    mod = sys.modules.get(spec.plain.__module__)
    mod_file = getattr(mod, "__file__", None)
    if not mod_file:
        return "unknown"
    pkg = Path(mod_file).resolve().parent
    files = sorted(str(p) for p in pkg.glob("*.py"))
    src = registry.get(spec.name).source
    cu = _CSRC / Path(src).name
    if cu.exists():
        files.append(str(cu))
        text = cu.read_text()
        files += sorted(str(_CSRC / h.name) for h in _CSRC.glob("*.cuh") if f'"{h.name}"' in text)
    return _files_hash(tuple(files))


def autotune_enabled() -> bool:
    """``REPRO_AUTOTUNE=1``: :func:`plan_for` sweeps missing buckets."""
    return os.environ.get("REPRO_AUTOTUNE", "0") != "0"


# ---------------------------------------------------------------------------
# The disk cache
# ---------------------------------------------------------------------------


def _load_disk() -> None:
    """Merge the file's valid entries into memory (once a path). Anything
    unusable (unreadable or corrupt JSON, another version or layout, an
    unregistered kernel, a stale source hash) is skipped."""
    global _disk_loaded_from
    path = cache_path()
    if _disk_loaded_from == path:
        return
    _disk_loaded_from = path
    try:
        with open(path) as f:
            on_disk = json.load(f)
    except (OSError, ValueError):
        return
    if not isinstance(on_disk, dict) or on_disk.get("version") != CACHE_VERSION:
        return
    entries = on_disk.get("entries")
    if not isinstance(entries, dict):
        return
    from repro_torch.kernels import registry

    for k, v in entries.items():
        if not isinstance(v, dict) or "plan" not in v:
            continue
        try:
            spec = registry.spec(str(k).split("|", 1)[0])
        except KeyError:
            continue
        if v.get("src") != source_hash(spec):
            continue
        _memory_cache.setdefault(k, v)


def _store_disk(key: str, entry: dict) -> None:
    """Read-modify-write with an atomic replace (best effort). The
    per-candidate report never goes to disk, only the winner; a damaged or
    foreign file is replaced by a fresh envelope."""
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            with open(path) as f:
                on_disk = json.load(f)
        except (OSError, ValueError):
            on_disk = None
        if (not isinstance(on_disk, dict) or on_disk.get("version") != CACHE_VERSION
                or not isinstance(on_disk.get("entries"), dict)):
            on_disk = {"version": CACHE_VERSION, "entries": {}}
        on_disk["entries"][key] = {k: v for k, v in entry.items() if k != "candidates"}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(on_disk, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only file system: the winner still serves this process


def clear_memory_cache() -> None:
    """Forget this process's winners (the disk is untouched)."""
    global _disk_loaded_from
    _memory_cache.clear()
    _disk_loaded_from = None


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def _time_candidate(run, device) -> float:
    """Best of ``_SWEEP_REPS`` calls (µs) after a warm-up call: CUDA events
    on a card, the host clock elsewhere."""
    run()
    best = float("inf")
    if device.type == "cuda":
        for _ in range(_SWEEP_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        return best
    import time

    for _ in range(_SWEEP_REPS):
        t0 = time.perf_counter()
        run()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def sweep(spec: KernelSpec, sig: ShapeSig, *, device=None, report: bool = False, seed: int = 0) -> dict:
    """Time every plan at ``sig`` on inputs drawn on ``device`` (default
    the card); return the winning entry ``{"plan", "us", "n_candidates",
    "src"}``. The default plan runs first, and a candidate whose outputs
    differ from it in any bit is rejected. ``report=True`` adds
    ``"candidates"``: each plan's time and whether it was bit-equal (kept
    off the disk). A plan that fails to run is skipped; with none left,
    the entry holds the default plan and ``"us": None``."""
    from repro_torch.core.runtime import resolve_device

    device = resolve_device(device)
    args = spec.make_inputs(torch.Generator(device=device).manual_seed(seed), sig)
    default = spec.default_plan(sig, device)
    results = []
    with uncounted():
        try:
            want = output_leaves(spec.cuda(*args, plan=default))
        except Exception:  # noqa: BLE001 (no kernel for this shape or device: nothing to hold plans to)
            want = None
        plans = [default] + [p for p in spec.plan_candidates(sig) if p != default]
        for plan in plans if want is not None else ():
            run = lambda plan=plan: spec.cuda(*args, plan=plan)  # noqa: E731
            try:
                got = output_leaves(run())
                same = len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
                us = _time_candidate(run, device) if same else None
            except Exception:  # noqa: BLE001 (a plan this shape or card refuses)
                continue
            results.append({"plan": dict(plan), "us": us, "bit_equal": same})
    kept = [r for r in results if r["bit_equal"]]
    if not kept:
        entry = {"plan": dict(default), "us": None}
    else:
        best = min(kept, key=lambda r: r["us"])
        entry = {"plan": best["plan"], "us": best["us"], "n_candidates": len(kept)}
    entry["src"] = source_hash(spec)
    if report:
        entry["candidates"] = results
    return entry


def record(spec: KernelSpec, sig: ShapeSig, entry: dict, *, device=None) -> None:
    """Store a sweep's winner (memory and disk) for ``device``'s card."""
    from repro_torch.core.runtime import resolve_device

    entry = dict(entry)
    entry.setdefault("src", source_hash(spec))
    key = cache_key(spec.name, card_name(resolve_device(device)), sig)
    _memory_cache[key] = entry
    _store_disk(key, entry)


def plan_for(spec: KernelSpec, sig: ShapeSig, *, device=None) -> dict:
    """The cached winner at ``sig``'s bucket on ``device``'s card, else a
    sweep at the bucket's shape (when :func:`autotune_enabled`), else the
    spec's default plan at ``sig`` itself. A sweep in which no plan ran is
    remembered in memory only, and the default is served."""
    from repro_torch.core.runtime import resolve_device

    device = resolve_device(device)
    key = cache_key(spec.name, card_name(device), sig)
    _load_disk()
    entry = _memory_cache.get(key)
    if entry is None and autotune_enabled():
        entry = sweep(spec, bucket_sig(sig), device=device)
        if entry["us"] is None:
            entry = {"plan": None}
        else:
            _store_disk(key, entry)
        _memory_cache[key] = entry
    if entry is None or entry["plan"] is None:
        return dict(spec.default_plan(sig, device))
    return entry["plan"]
