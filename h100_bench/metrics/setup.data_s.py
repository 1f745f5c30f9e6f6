"""Host seconds of set-up spent on making the cell's inputs from the seed and
the program's graphs from them, timed from the benchmark's own files
around the calls."""


def read(ctx):
    return ctx.spans.get("setup.data_s")
