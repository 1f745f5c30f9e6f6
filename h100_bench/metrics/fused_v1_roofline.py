"""``fused_v1``'s share of its roofline (``bounds/fused_v1.py``)."""

from h100_bench.roofline import share


def read(ctx):
    return share(ctx, "fused_v1")
