"""The device's idle share of the profiled slice: 100 · (1 − the union of
device-activity intervals / the slice's length), from the trace."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
