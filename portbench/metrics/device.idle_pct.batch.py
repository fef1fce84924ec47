"""device.idle_pct.batch: the share of the traced window in which no
operation (kernel, copy or fill) ran on the card, in the batch cells."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
