"""Kind ``queries``: one closed-loop caller placing requests of held-out
rows through ``MapServer.transform``; the check judges requests drawn from
the seed."""

from __future__ import annotations

import time

import numpy as np
import torch

from bench import datagen, judge
from bench import reference as ref
from bench.harness import Work, _index_arrays


class Kind(Work):
    """One closed-loop caller placing requests of held-out rows on a map
    frozen after the first epochs of the fit's schedule."""

    span = "bench.request"

    def setup(self):
        from repro_torch.core.strategy import LocalStrategy
        from repro_torch.serve import FrozenMap, MapServer

        cfg, tr = self.cfg, self.traffic
        self.make_data()
        self.index, _ = self.build_index()
        th_rows = self.theta_rows(self.index)
        strategy = LocalStrategy()
        t = time.perf_counter()
        theta = strategy.prepare(cfg, cfg.method, self.index, th_rows, self.device)
        for e in range(int(tr["fit_epochs"])):
            theta, _ = strategy.run_epoch(theta, e, *ref.epoch_lrs(self.cfgd, e))
        self.fit_theta = strategy.fetch(theta)
        del strategy, theta
        t = self.part("fit", t)
        self.frozen = FrozenMap.from_index_theta(self.index, self.fit_theta, cfg, device=self.device)
        self.server = MapServer(self.frozen)
        t = self.part("freeze", t)
        rows, n_pool = int(tr["request_rows"]), int(tr["pool_requests"])
        pool = datagen.mixture_rows(self.cell.config["data"], self.centres, rows * n_pool, self.seed,
                                    datagen.QUERY_STREAM)
        self.pool = datagen.to_host(pool).reshape(n_pool, rows, -1)
        del pool
        t = self.part("queries", t)
        self.outs = []
        self.server.transform(self.pool[0], seed=self.request_seed(0))  # warm
        self.part("warm", t)

    def request_seed(self, i: int) -> int:
        return datagen.sub_seed(self.seed, 3, i) & 0xFFFFFFFF

    def unit(self):
        i = len(self.outs)
        r = self.server.transform(self.pool[i % len(self.pool)], seed=self.request_seed(i))
        self.outs.append({"embedding": r.embedding, "cells": r.cells, "neighbor_ids": r.neighbor_ids,
                          "neighbor_dists": r.neighbor_dists})

    def free(self):
        del self.server

    def check(self) -> dict:
        arrays = _index_arrays(self.index)
        arrays["x_rows"] = torch.from_numpy(arrays["x_rows"]).to(self.device)
        numbers = judge.index_numbers(self.x, arrays, self.cfgd, self.seed)
        fz = {f: getattr(self.frozen, f) for f in ("theta_rows", "x_rows", "centroids", "counts", "means",
                                                    "inv_perm")}
        numbers.update(judge.map_numbers(fz, arrays, self.fit_theta, self.cfgd))
        n = len(self.outs)
        m = min(n, int(self.traffic["check_requests"]))
        picks = np.random.default_rng(datagen.sub_seed(self.seed, 5)).choice(n, m, replace=False)
        rows = int(self.traffic["request_rows"])
        worst = {}
        for i in sorted(picks):
            q = torch.from_numpy(self.pool[i % len(self.pool)]).to(self.device)
            seeds = torch.full((rows,), self.request_seed(int(i)), dtype=torch.int64, device=self.device)
            got = judge.query_numbers(self.cfgd, fz, self.index.perm, q, seeds,
                                      torch.arange(rows, device=self.device), self.outs[i])
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        numbers.update(worst)
        return numbers
