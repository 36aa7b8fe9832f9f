"""build_mfu: an index build's necessary work from the configuration's
shapes and the built cells' sizes (``bench/yardstick.py:build_work``: one
assignment pass, the candidate pass and the in-cell kNN) at the card's
peaks, as a share of the build time measured over the traced run's
window."""

from bench import yardstick as ys


def read(ctx):
    w = ctx["window"]
    if ctx["traffic"]["kind"] != "builds" or not w["units"]:
        return None
    counts = ctx["counts"] if len(ctx["counts"]) else None
    return ys.share_pct(ys.build_work(ctx["cfg"], counts).bound_s(), w["seconds_per_unit"])
