"""Kind ``ranks``, for the tests of a cell on several cards alone (copied
into a test checkout as ``bench/kinds/ranks.py``): each unit all-reduces
a vector drawn from the seed, the rank and the unit, and the check holds
every sum a rank received against the sum of every rank's draws,
worked out again in float64. Rank r holds r + 1 MiB more than it needs,
so the cards' peaks differ.

Faults for the tests, each from the traffic mix on one rank:
``fault_rank`` alters the sums that rank received, ``exit_rank`` exits
with status 1 after ``exit_after`` units, ``hang_rank`` sleeps for an
hour after ``hang_after`` units, ``jax_rank`` loads a module named
``jax``."""

from __future__ import annotations

import os
import sys
import time
import types

import torch

from bench import datagen
from bench.harness import Work

WIDTH = 4096


class Kind(Work):
    span = "bench.ranks"

    def draw(self, rank: int, unit: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(datagen.sub_seed(self.seed, 7, rank, unit))
        return torch.randn(WIDTH, generator=g, dtype=torch.float64)

    def setup(self):
        self.pad = torch.ones((self.rank + 1) << 20, dtype=torch.uint8, device=self.device)
        self.sums = []
        if self.rank == self.traffic.get("jax_rank"):
            sys.modules["jax"] = types.ModuleType("jax")

    def unit(self):
        i = len(self.sums)
        t = self.draw(self.rank, i).float().to(self.device)
        torch.distributed.all_reduce(t)
        got = t.double().cpu()
        if self.rank == self.traffic.get("fault_rank"):
            got[0] += 1.0
        self.sums.append(got)
        tr = self.traffic
        if self.rank == tr.get("exit_rank") and len(self.sums) == tr["exit_after"]:
            os._exit(1)
        if self.rank == tr.get("hang_rank") and len(self.sums) == tr["hang_after"]:
            time.sleep(3600)

    def free(self):
        del self.pad

    def check(self) -> dict:
        gap = 0.0
        for i, got in enumerate(self.sums):
            want = sum(self.draw(r, i).float().double() for r in range(self.world))
            gap = max(gap, float((got - want).abs().max() / want.abs().max()))
        return {"sum_gap": gap}
