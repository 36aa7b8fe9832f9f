"""build.stragglers_s: the seconds an index build spends placing its
stragglers on the host (the program's ``BuildReport.stage_s``, whose
stages end on a device synchronise), averaged over the window's builds."""


def read(ctx):
    got = [s["stragglers"] for s in ctx["window"]["stage_s"] if "stragglers" in s]
    if ctx["traffic"]["kind"] != "builds" or not got:
        return None
    return sum(got) / len(got)
