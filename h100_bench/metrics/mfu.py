"""The whole step's share of the cards' float32 peak: the FLOPs an epoch
needs at the published widths (``flops/<model>.py``) over the untraced
epoch time times 67 TFLOP/s a card."""

from h100_bench.peaks import F32_FLOPS


def read(ctx):
    return 100.0 * ctx.flops / (ctx.epoch_ms / 1e3 * F32_FLOPS * ctx.chips)
