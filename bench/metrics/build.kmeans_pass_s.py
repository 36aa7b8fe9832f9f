"""build.kmeans_pass_s: the seconds of one k-means pass over the rows in
the set-up's index build: its ``kmeans`` stage (``BuildReport.stage_s``,
ended on a device synchronise) over the program's count of passes
(``kmeans.passes``: the LSH seeding and every E-step)."""

from bench.program_trace import build_counter


def read(ctx):
    passes = build_counter(ctx, "kmeans.passes")
    stage = ctx["window"]["stage_s"][0].get("kmeans") if passes else None
    return None if stage is None else stage / passes
