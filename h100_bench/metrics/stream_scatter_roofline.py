"""``stream_scatter``'s share of its roofline (``bounds/stream_scatter.py``)."""

from h100_bench.roofline import share


def read(ctx):
    return share(ctx, "stream_scatter")
