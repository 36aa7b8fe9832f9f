"""Nothing the benchmark loads is JAX or the JAX package, names compared
whole (``repro_torch`` begins with ``repro`` and is the program), and the
yardstick's files import nothing of the program."""

import ast
import subprocess
import sys
import types

from bench import run as run_mod
from bench.tests import tiny_root

ROOT = tiny_root.ROOT
YARDSTICK = ("reference.py", "judge.py", "yardstick.py", "datagen.py", "tracing.py")


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "reproducible", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run_mod.forbidden_modules() == []
    for name in ("repro", "repro.core.nomad", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run_mod.forbidden_modules() == ["flax", "jaxlib.xla_client", "repro", "repro.core.nomad"]


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from pathlib import Path
from bench.tests import tiny_root
from bench import calibrate, harness, run
root = tiny_root.make(Path({str(tmp_path)!r}))
for w in tiny_root.CELLS:
    out, _ = tiny_root.run(root, w, trace=True)
    assert out["correct"], out
    cell = harness.load_cell(root, w)
    for m in cell.per_layer:
        harness.load_reader(cell.bench_dir, m["name"])
print("FOUND", run.forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND []" in r.stdout


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        tree = ast.parse((ROOT / "bench" / name).read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib", "flax"), (name, m)
