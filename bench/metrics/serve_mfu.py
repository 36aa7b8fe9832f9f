"""serve_mfu: placing the window's queries, their necessary work from the
configuration's shapes (``bench/yardstick.py:serve_batch_work``: the
nearest centroid, the kNN in the cell, the frozen steps over the K means
and the k neighbours) at the card's peaks, as a share of the traced run's
window."""

from bench import yardstick as ys


def read(ctx):
    w = ctx["window"]
    if ctx["traffic"]["kind"] != "queries" or not w["units"]:
        return None
    per_request = ys.serve_batch_work(ctx["cfg"], int(ctx["traffic"]["request_rows"]))
    return ys.share_pct(per_request.bound_s() * w["units"], w["seconds"])
