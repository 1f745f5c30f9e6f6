"""Device time an epoch of the GEMM kernels (the model's projections and
their gradients, by their library's kernel names), in the traced stretch."""


def read(ctx):
    return ctx.stretch.per_epoch_ms("gemm") or None
