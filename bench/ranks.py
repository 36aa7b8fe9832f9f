"""A cell on C > 1 cards: one process a card, started, watched and ended
by ``run.py``, and the few collectives by which the harness keeps the
ranks in step.

The launcher (:func:`launch`) starts C copies of ``run.py``, rank r on
card r, which meet at a free local port through the program's own
``repro_torch.launch.distributed.initialize_distributed`` (NCCL on the
card, gloo on the CPU). Rank 0 alone prints the result line and the
check lines; the launcher passes them on only when every rank ended with
status 0, and otherwise prints no result, ends every rank that is left
and exits non-zero:

* a rank that exits with another status: the others are ended
  ``GRACE_S`` seconds after it;
* a rank that hangs: its peers' collectives give up after the process
  group's timeout (``RANK_TIMEOUT_S``, rendezvous included), those ranks
  exit (NCCL's watchdog first spends about a minute on its debug dump),
  and the hung one is ended ``GRACE_S`` seconds later;
* a run that is still going after ``RUN_DEADLINE_S`` seconds: every rank
  is ended;
* a launcher that is ended itself takes its ranks with it (SIGTERM ends
  them; each rank dies with its parent).
"""

from __future__ import annotations

import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

RANK_TIMEOUT_S = 180  # the process group's timeout: rendezvous and each collective
GRACE_S = 20  # after one rank has ended, the others' time to end
RUN_DEADLINE_S = 1150  # a whole run, a checkout's first (which compiles) included
TAIL = 3000  # characters of a failed rank's standard error passed on


# ---------------------------------------------------------------------------
# In each rank
# ---------------------------------------------------------------------------


def die_with_parent(parent_pid: int) -> None:
    """Let the kernel end this rank when its launcher ends (Linux's
    ``PR_SET_PDEATHSIG``); exit at once if the launcher is gone already."""
    import ctypes

    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass
    if os.getppid() != parent_pid:
        os._exit(1)


def barrier(device: torch.device) -> None:
    """Every rank waits here for the others (one tiny all-reduce, which
    behaves alike on NCCL and gloo)."""
    import torch.distributed as dist

    t = torch.zeros(1, device=device)
    dist.all_reduce(t)
    t.item()


def rank0_says(flag: bool, device: torch.device) -> bool:
    """Rank 0's ``flag`` on every rank: one scalar broadcast."""
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def gather(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def worst(per_rank: list) -> dict:
    """Each number compared, as the worst rank reads it: a number that is
    not finite on some rank, else the largest; missing on a rank, inf."""
    names = dict.fromkeys(n for numbers in per_rank for n in numbers)
    out = {}
    for name in names:
        values = [float(numbers.get(name, math.inf)) for numbers in per_rank]
        bad = [v for v in values if not math.isfinite(v)]
        out[name] = bad[0] if bad else max(values)
    return out


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def launch(run_py: Path, argv: list, world: int, device_type: str, t_start: float,
           rank_timeout_s: int = RANK_TIMEOUT_S, loaded_forbidden=lambda: False) -> int:
    """Run ``run_py argv`` as ``world`` ranks; pass rank 0's output on
    when every rank ended with status 0 and ``loaded_forbidden()``, asked
    of this process once they have, is false. Returns the run's status."""
    from repro_torch.launch.distributed import pick_free_port

    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    common = [*argv, "--world", str(world), "--coordinator", f"127.0.0.1:{pick_free_port()}",
              "--device", device_type, "--t-start", repr(t_start), "--rank-timeout", str(rank_timeout_s),
              "--parent-pid", str(os.getpid())]
    previous = signal.signal(signal.SIGTERM, _exit_on_sigterm)
    procs, logs = [], []
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        try:
            for r in range(world):
                out, err = (open(Path(tmp) / f"{r}.{s}", "w+b") for s in ("out", "err"))
                logs.append((out, err))
                procs.append(subprocess.Popen([sys.executable, str(run_py), *common, "--rank", str(r)],
                                              stdin=subprocess.DEVNULL, stdout=out, stderr=err, env=env))
            rcs, why = _watch(procs)
        finally:
            _end(procs)
            signal.signal(signal.SIGTERM, previous)
        texts = []
        for out, err in logs:
            texts.append(tuple(_read(f) for f in (out, err)))
            out.close()
            err.close()
    if why is None and all(rc == 0 for rc in rcs):
        if loaded_forbidden():
            return 3
        for r in list(range(1, world)) + [0]:
            if texts[r][1]:
                sys.stderr.write(texts[r][1])
        sys.stderr.flush()
        sys.stdout.write(texts[0][0])
        sys.stdout.flush()
        return 0
    for r, (rc, (_out, err)) in enumerate(zip(rcs, texts)):
        print(f"rank {r}: exit status {rc}\n{err[-TAIL:]}", file=sys.stderr)
    print(f"the run failed: {why or 'a rank exited with another status than 0'}", file=sys.stderr, flush=True)
    return next((rc for rc in rcs if rc > 0), 1)


def _exit_on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def _watch(procs: list):
    """Wait for every rank; end them all ``GRACE_S`` after the first ends
    while others run on, or at ``RUN_DEADLINE_S``. (statuses, why ended)."""
    first_end, why = None, None
    deadline = time.monotonic() + RUN_DEADLINE_S
    while any(p.poll() is None for p in procs):
        now = time.monotonic()
        if first_end is None and any(p.poll() is not None for p in procs):
            first_end = now
        if first_end is not None and now - first_end > GRACE_S:
            why = f"a rank was still running {GRACE_S} s after another had ended"
        elif now > deadline:
            why = f"the run was still going after {RUN_DEADLINE_S} s"
        if why:
            _end(procs)
            break
        time.sleep(0.05)
    return [p.wait() for p in procs], why


def _end(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _read(f) -> str:
    f.flush()
    f.seek(0)
    return f.read().decode(errors="replace")
