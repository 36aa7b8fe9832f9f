"""train_mfu: the training epoch's necessary work from the configuration's
shapes (``bench/yardstick.py:epoch_work``) at the card's peaks, as a share
of the epoch time measured over the traced run's window."""

from bench import yardstick as ys


def read(ctx):
    w = ctx["window"]
    if ctx["traffic"]["kind"] != "epochs" or not w["units"]:
        return None
    return ys.share_pct(ys.epoch_work(ctx["cfg"]).bound_s(), w["seconds_per_unit"])
