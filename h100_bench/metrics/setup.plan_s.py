"""Host seconds of set-up spent on the program's plans: the large-N plan, or
the graph banks, timed from the benchmark's own files around the calls."""


def read(ctx):
    return ctx.spans.get("setup.plan_s")
