"""serve.batch_p95_ms: the 95th percentile of the window's request times,
each from the call to its placements on the host, over every request."""

import numpy as np


def read(ctx):
    w = ctx["window"]
    if ctx["traffic"]["kind"] != "queries" or not w["units"]:
        return None
    return float(np.percentile(np.asarray(w["unit_s"], np.float64), 95)) * 1e3
