"""Run one cell of the benchmark once, on the cards the cell names.

    python3 bench/run.py --workload pubmed.train --seed 7 --seconds 30 --trace 0

(or ``PYTHONPATH=src python -m bench.run ...``) from the root of a
checkout. The last line of standard output is the result object; the
numbers compared and their limits are the last lines of standard error.
The run exits non-zero and prints no result without as many CUDA devices
as the cell's ``chips``, when the program cannot be imported, or when JAX
or the JAX package was loaded into a process of the run. Every cache the
program or PyTorch writes lands under ``build/`` in the checkout.

A cell on one card runs in this process on ``cuda:0``. A cell on C > 1
cards runs as C ranks, this script started once a card by
``bench/ranks.py``, rank r on ``cuda:r``; the options after ``--trace``
are the launcher's to its ranks.
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


def main(argv=None, device_type: str = "cuda", rank_timeout_s=None) -> int:
    """The command. ``device_type`` "cpu" skips the look for a card and
    runs the cell on the CPU (gloo between ranks): for the tests alone."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    for opt, kind in (("--rank", int), ("--world", int), ("--coordinator", str), ("--device", str),
                      ("--t-start", float), ("--rank-timeout", int), ("--parent-pid", int)):
        ap.add_argument(opt, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    setup_environment(ROOT)

    import torch

    from bench import harness

    if args.rank is not None:
        return rank_main(args)
    cell = harness.load_cell(ROOT, args.workload)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not importable: {e}", file=sys.stderr)
        return 2
    chips = int(cell.workload["chips"])
    if device_type == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if chips > 1:
        from bench import ranks

        argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds", repr(args.seconds),
                "--trace", str(args.trace)]
        return ranks.launch(ROOT / "bench" / "run.py", argv, chips, device_type, T_START,
                            rank_timeout_s or ranks.RANK_TIMEOUT_S, loaded_forbidden=forbidden_found)
    device = "cuda:0" if device_type == "cuda" else "cpu"
    out, parts = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device, T_START)
    if forbidden_found():
        return 3
    err, line = report(out, parts)
    print("\n".join(err), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def forbidden_found() -> bool:
    """Name on standard error the forbidden modules this process loaded."""
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded into this process: {found}", file=sys.stderr, flush=True)
    return bool(found)


def rank_main(args) -> int:
    """One rank of a cell on several cards: join the process group, let
    rank 0 build the program's kernels while the others wait, run, and
    (rank 0) print. Any fault ends the process at once, without the
    process group's teardown, which could wait on a dead peer."""
    import torch

    from bench import harness, ranks
    from repro_torch.launch.distributed import initialize_distributed, shutdown

    ranks.die_with_parent(args.parent_pid)
    device = torch.device("cpu" if args.device == "cpu" else f"cuda:{args.rank}")
    try:
        initialize_distributed(args.coordinator, args.world, args.rank, device=device, timeout_s=args.rank_timeout)
        if args.rank == 0 and device.type == "cuda":
            from repro_torch.kernels import _build

            _build.build()
        ranks.barrier(device)
        out, parts = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device,
                                 args.t_start, rank=args.rank, world=args.world)
    except BaseException:  # noqa: BLE001 — a rank's fault ends the run: report it, leave at once
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    shutdown()
    if forbidden_found():
        return 3
    if args.rank == 0:
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
