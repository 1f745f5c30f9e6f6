"""The device's idle share of an epoch: one less the union of its kernel
and memory-operation intervals in the traced stretch, per epoch, over the
same run's untraced epoch time (tracing stretches the wall, not the
device's work). A collective's kernel spins while its peers catch up, so
its time is waiting, not work: it is left out here."""


def read(ctx):
    busy_ms = ctx.stretch.busy_s(collectives=False) * 1e3 / ctx.stretch.epochs
    return 100.0 * (1.0 - busy_ms / ctx.epoch_ms)
