"""Run one cell of the benchmark once, on the card this process is given.

    python3 bench/run.py --workload pubmed.train --seed 7 --seconds 30 --trace 0

(or ``PYTHONPATH=src python -m bench.run ...``) from the root of a
checkout. The last line of standard output is the result object; the
numbers compared and their limits are the last lines of standard error.
The run exits non-zero and prints no result without a CUDA device, when
the program cannot be imported, or when JAX or the JAX package was loaded
into this process. Every cache the program or PyTorch writes lands under
``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, names compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def setup_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout, the program on the path."""
    cache = root / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_environment(ROOT)

    import torch

    from bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not importable: {e}", file=sys.stderr)
        return 2
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out, parts = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded into this process: {found}", file=sys.stderr)
        return 3
    err, line = report(out, parts)
    print("\n".join(err), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def report(out: dict, parts: dict):
    """(lines for standard error, ending with the checks; the result line)."""
    from bench import harness

    err = ["parts_s " + json.dumps({k: round(v, 3) for k, v in parts.items() if isinstance(v, float)})]
    err += [f"{k} " + json.dumps(v) for k, v in parts.items() if not isinstance(v, float)]
    return err + harness.check_lines(out["checks"]), json.dumps(out)


if __name__ == "__main__":
    sys.exit(main())
