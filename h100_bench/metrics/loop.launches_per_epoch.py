"""Device kernels launched an epoch, in the traced stretch."""


def read(ctx):
    return len(ctx.stretch.kernels) / ctx.stretch.epochs or None
