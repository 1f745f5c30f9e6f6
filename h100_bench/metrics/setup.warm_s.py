"""Host seconds of set-up spent on building the model, its optimiser and the
loop, and the loop's first calls (the first one captures a CUDA graph),
timed from the benchmark's own files around the calls."""


def read(ctx):
    return ctx.spans.get("setup.warm_s")
