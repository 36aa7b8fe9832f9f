"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no source file of it (or chip_smoke.py) imports either."""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.nomad, repro_torch.index.build\n"
        "import repro_torch.core.strategy, repro_torch.kernels.registry\n"
        "import repro_torch.serve, repro_torch.serve.transform, repro_torch.checkpoint\n"
        "import repro_torch.service, repro_torch.service.app, repro_torch.pipeline.inverse\n"
        "import repro_torch.optim, repro_torch.pipeline, repro_torch.pipeline.embed, repro_torch.pipeline.run\n"
        "import repro_torch.models, repro_torch.models.convert, repro_torch.data.embeddings, repro_torch.configs\n"
        "import repro_torch.models.steps\n"
        "from repro_torch.models.lm import init_cache, load_cache_from_prefill, decode_step, cache_capacity\n"
        "from repro_torch.models.attention import attend_decode, attention_decode_block\n"
        "from repro_torch.models.ssm import init_ssm_state, ssm_decode_block\n"
        "import repro_torch.optim.quantized, repro_torch.optim.sgd, repro_torch.optim.adamw, repro_torch.data.loader\n"
        "from repro_torch.models.steps import cross_entropy, make_loss_fn, make_train_step\n"
        "from repro_torch.models.attention import attend_flash\n"
        "from repro_torch.models.lm import trainable\n"
        "from repro_torch.optim import SGD, QTensor, quantize_int8, dequantize_int8\n"
        "from repro_torch.data.loader import TokenStream, stream_seed\n"
        "import repro_torch.launch.train, repro_torch.launch.dryrun, repro_torch.roofline\n"
        "from repro_torch.roofline.op_cost import analyze_ops, memory_analysis\n"
        "from repro_torch.roofline.analysis import HW_H100, nomad_analytic_terms\n"
        "from repro_torch.core import cauchy_pairwise\n"
        "from repro_torch.data import hierarchical_mixture, swiss_roll\n"
        "from repro_torch.index import build_index, kmeans_fit, capacity_assign\n"
        "from repro_torch.service.core import handle_for\n"
        "from repro_torch.models.lm import abstract_params\n"
        "from repro_torch.models.steps import batch_specs, cache_specs, input_specs\n"
        "import repro_torch.core.distributed, repro_torch.launch.distributed, repro_torch.launch.mesh\n"
        "from repro_torch.core.runtime import barrier, process_count, process_index, resolve_device\n"
        "from repro_torch.core.strategy import ShardedStrategy, HierarchicalStrategy, resolve_strategy\n"
        "from repro_torch.core.strategy import default_mesh, flat_mesh, fetch_global, sync_processes\n"
        "from repro_torch.index.build import resolve_build_strategy\n"
        "from repro_torch.index.kmeans import kmeans_fit_sharded\n"
        "from repro_torch.launch.mesh import Mesh, make_mesh\n"
        "import repro_torch.launch.sharding, repro_torch.launch.pipeline, repro_torch.optim.compression\n"
        "import repro_torch.launch.selftest, repro_torch.launch.selftest_pipeline, repro_torch.kernels.autotune\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.models.moe import set_ep_mesh, moe_ep\n"
        "from repro_torch.models.attention import set_decode_context, attend_decode_sharded\n"
        "from repro_torch.kernels import registry\n"
        "registry.names(), registry.spec_names()  # imports every kernel module\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("module,allowed", [
    ("repro_torch.core.runtime", {"repro_torch", "repro_torch.core", "repro_torch.core.cauchy",
                                  "repro_torch.core.runtime"}),
    ("repro_torch.launch.mesh", {"repro_torch", "repro_torch.core", "repro_torch.core.cauchy",
                                 "repro_torch.core.runtime", "repro_torch.launch", "repro_torch.launch.mesh"}),
])
def test_runtime_layers_import_nothing_above_them(module, allowed):
    """The process's runtime facts and the slot meshes sit below the fit,
    the build and serving, which all import them: importing them loads no
    other module of the port, so no import cycle runs through them."""
    code = (
        f"import sys, {module}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch'))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert loaded <= allowed, sorted(loaded - allowed)


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_sources_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    assert not offenders, offenders
