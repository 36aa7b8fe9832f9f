"""Kind ``epochs``: training epochs of the fit's schedule through
``LocalStrategy.run_epoch``; the check follows the warm-up epoch and the
window's first epoch, each from the θ that the program started it from."""

from __future__ import annotations

import time

import torch

from bench import judge
from bench import reference as ref
from bench.harness import F64, Work, _index_arrays


def _host(theta: torch.Tensor):
    return theta.detach().double().cpu().numpy()


class Kind(Work):
    """Training epochs of the fit's schedule through ``LocalStrategy``; the
    fit wraps to the start θ after its last epoch."""

    span = "bench.epoch"

    def setup(self):
        from repro_torch.core.strategy import LocalStrategy

        cfg = self.cfg
        self.make_data()
        self.index, report = self.build_index()
        self.stage_s.append(report.stage_s)
        self.th_rows = self.theta_rows(self.index)
        self.strategy = LocalStrategy()
        self.theta = self.strategy.prepare(cfg, cfg.method, self.index, self.th_rows, self.device)
        # epoch 0 is the warm-up, through the window's own call
        t = time.perf_counter()
        self.theta, loss = self.strategy.run_epoch(self.theta, 0, *ref.epoch_lrs(self.cfgd, 0))
        self.checked = [(float(loss), self.th_rows.astype("float64"), _host(self.theta))]
        self.part("warm", t)
        self.epoch = 1
        self.first = None  # the window's first epoch: (epoch, mean loss, θ at its start, θ at its end)

    def unit(self):
        if self.epoch == self.cfg.n_epochs:
            self.theta.copy_(torch.from_numpy(self.th_rows))
            self.epoch = 0
        start = self.theta.clone() if self.first is None else None
        lr0, lr1 = ref.epoch_lrs(self.cfgd, self.epoch)
        self.theta, loss = self.strategy.run_epoch(self.theta, self.epoch, lr0, lr1)
        if start is not None:
            self.first = (self.epoch, loss, start, self.theta.clone())
        self.epoch += 1

    def free(self):
        epoch, loss, start, end = self.first
        self.first = (epoch, float(loss), _host(start), _host(end))
        del self.strategy, self.theta

    def check(self) -> dict:
        arrays = _index_arrays(self.index)
        arrays["x_rows"] = torch.from_numpy(arrays["x_rows"]).to(self.device)
        numbers = judge.index_numbers(self.x, arrays, self.cfgd, self.seed)
        del arrays["x_rows"]
        epoch, loss, start, end = self.first
        self.checked.append((loss, start, end))
        want = [ref.epoch_from(self.cfgd, th0, arrays, self.seed, e, self.device, F64)
                for e, (_, th0, _) in zip((0, epoch), self.checked)]
        numbers.update(judge.train_numbers(self.checked, want))
        return numbers
