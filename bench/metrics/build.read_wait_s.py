"""build.read_wait_s: the host seconds the set-up's index build waited on
its chunk reader (the program's counter ``stream.read_wait_s``, summed
over every chunk ``stream_chunks`` handed the build)."""

from bench.program_trace import build_counter


def read(ctx):
    return build_counter(ctx, "stream.read_wait_s")
