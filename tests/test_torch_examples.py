"""The six ``examples/*_torch.py`` twins run on the CPU (``--device cpu``)
at their references' CI points, exit 0 and print their references' lines;
the sharded map of ``distributed_map_torch.py`` keeps its NP@10 within
0.05 of its single-device map. One intra-op thread each."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
JAX_FREE = """
import runpy, sys
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code or 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print("loaded", bad)
sys.exit(rc or (1 if bad else 0))
"""


def _run(script: str, *args, timeout: int = 240):
    """The example as ``__main__`` in a child that then fails if it loaded
    JAX or the JAX package."""
    r = subprocess.run([sys.executable, "-c", JAX_FREE, str(ROOT / "examples" / script), *args, "--device", "cpu"],
                       capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "loaded []" in r.stdout
    return r.stdout


def _has(out: str, *prefixes):
    lines = [ln.strip() for ln in out.splitlines()]
    missing = [p for p in prefixes if not any(ln.startswith(p) for ln in lines)]
    assert not missing, (missing, out[-3000:])


@pytest.mark.parametrize("store", [False, True])
def test_quickstart(store):
    out = _run("quickstart_torch.py", "--n", "1500", "--epochs", "4", "--clusters", "8", *(["--store"] if store else []))
    _has(out, "generating 1500 points, 64-d, 12 clusters", "fitting NOMAD Projection", "epoch   0/4  loss",
         "done in ", "loss ", "NP@10 = ", "map (digits = cluster labels):", "OK")
    assert "[strategy=local, shards=1]" in out
    if store:
        _has(out, "fitting from disk-backed store at ")


def test_serve_map():
    out = _run("serve_map_torch.py", "--n", "2000", "--queries", "400", "--dim", "16", "--epochs", "8",
               "--clusters", "8", "--microbatch", "128")
    _has(out, "fitting 2000 points", "fit done in ", "serving: strategy=local, shards=1, microbatch=128",
         "placed 400 queries in ", "OK")
    frac = float(re.search(r"([\d.]+)% of placements within 3× their neighborhood radius", out).group(1))
    assert frac > 90.0


def test_serve_http_points_at_its_extras_without_fastapi():
    try:
        import fastapi  # noqa: F401
        import uvicorn  # noqa: F401
    except ImportError:
        out = _run("serve_http_torch.py", "--n", "1500", "--dim", "16", "--epochs", "3", "--clusters", "8")
        assert "this example needs the HTTP extras" in out
        return
    out = _run("serve_http_torch.py", "--n", "1500", "--dim", "16", "--epochs", "3", "--clusters", "8",
               "--port", "8791")
    _has(out, "serving http://127.0.0.1:8791", "POST /project: ", "again: cache_hit=True", "/metrics: ", "OK")


@pytest.mark.parametrize("arch,lookup", [("mixtral-8x7b", True), ("mamba2-2.7b", False)])
def test_serve_lm(arch, lookup):
    out = _run("serve_lm_torch.py", "--arch", arch, "--new-tokens", "8", *(["--map-lookup"] if lookup else []))
    _has(out, "serving ", "prefill: ", "decoded 8 tokens × 4 seqs in ", "sampled continuations (greedy):",
         "seq0: …", "OK")
    if lookup:
        _has(out, "nearest corpus docs per continuation (id:class @ dist):")
        assert len(re.findall(r"seq\d: \d+:\d@", out)) == 4


def test_embed_and_map(tmp_path):
    out = _run("embed_and_map_torch.py", "--train-steps", "50", "--docs", "4000", "--epochs", "20",
               "--inverse-steps", "400", "--workdir", str(tmp_path))
    _has(out, "training qwen3-14b", "step    0  loss", "trained in ", "embedding 4000 documents",
         "corpus embeddings: (4000, 128)", "map quality: NP@10=", "inverse head: R²=", "explore(",
         "OK — model → embeddings → map → explore pipeline complete")
    assert (tmp_path / "map" / "inverse.npz").exists()


@pytest.mark.parametrize("hierarchical", [False, True])
def test_distributed_map(hierarchical):
    out = _run("distributed_map_torch.py", *(["--hierarchical"] if hierarchical else []))
    want = "hierarchical" if hierarchical else "sharded"
    shape = "(2, 2, 2)" if hierarchical else "(2, 4)"
    _has(out, "building index", "single-device reference", "8 shards, ", f"ran as strategy={want} on mesh {shape} "
         "(8 shards)")
    np10 = {m.group(1): float(m.group(2)) for m in re.finditer(r"^(\S+)\s*:\s+[\d.]+s  NP@10=([\d.]+)", out, re.M)}
    assert set(np10) == {"1-device", "8-shard"}, out
    assert abs(np10["8-shard"] - np10["1-device"]) <= 0.05, np10
