"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no source file of it (or chip_smoke.py) imports either."""

from __future__ import annotations

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
        "from repro_torch.kernels import registry\n"
        "registry.names()  # imports every kernel module\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_sources_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    assert not offenders, offenders
