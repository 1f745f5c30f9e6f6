"""A port kernel's share of its roofline in a traced stretch: the least
time its calls of one epoch could take, their bytes (``bounds/<kernel>.py``)
over the device memory rate, against the device time of the kernels the
trace names as its own, per epoch.

A reading needs the bound file's call list to match the port's own launch
counter for the kernel in that epoch, and no other kernel of the port that
shares its trace name to have run; otherwise there is nothing sound to read
and the metric is left out (and said so on standard error)."""

from __future__ import annotations

import sys

from h100_bench.core import load_module
from h100_bench.peaks import HBM_BYTES_PER_S


def share(ctx, kernel: str) -> float | None:
    """Percent of the roofline, or None."""
    bound = load_module("bounds", kernel)
    calls = bound.calls(ctx.shapes)
    counted = ctx.launches.get(bound.COUNTER, 0)
    others = [k for k in bound.SHARES if ctx.launches.get(k, 0)]
    if not calls or others or abs(counted - len(calls)) > 1e-9:
        print(f"roofline {kernel}: {len(calls)} calls bounded an epoch, "
              f"{counted} counted, sharing its trace name with {others}: "
              "not read", file=sys.stderr)
        return None
    ms, hits = ctx.stretch.matching_ms(bound.TRACE,
                                       getattr(bound, "AFTER", None))
    if hits == 0 or ms <= 0.0:
        return None
    return 100.0 * (sum(calls) / HBM_BYTES_PER_S * 1e3) / ms
