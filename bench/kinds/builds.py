"""Kind ``builds``: ``IndexBuilder.build`` of the same rows, back to back;
the check judges the window's last build."""

from __future__ import annotations

import torch

from bench import judge
from bench.harness import Work, _index_arrays


class Kind(Work):
    """Index builds of the same rows, back to back."""

    span = "bench.build"

    def setup(self):
        self.make_data()
        self.build_index()  # warm
        self.parts["warm"] = self.parts.pop("build")
        self.last = None

    def unit(self):
        self.last, report = self.build_index()
        self.stage_s.append(report.stage_s)

    def free(self):
        pass

    def check(self) -> dict:
        arrays = _index_arrays(self.last)
        arrays["x_rows"] = torch.from_numpy(arrays["x_rows"]).to(self.device)
        return judge.index_numbers(self.x, arrays, self.cfgd, self.seed)
