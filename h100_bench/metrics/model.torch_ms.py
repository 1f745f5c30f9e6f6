"""Device time an epoch of every kernel that is neither the port's own nor
a GEMM nor a collective: PyTorch's elementwise ops, gathers, sums,
concatenations and the optimiser, in the traced stretch."""


def read(ctx):
    return ctx.stretch.per_epoch_ms("torch") or None
