"""Device time an epoch of the port's own CUDA kernels (``csrc/``), in the
traced stretch."""


def read(ctx):
    return ctx.stretch.per_epoch_ms("port") or None
