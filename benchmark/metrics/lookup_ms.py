"""Device milliseconds a call spends in the window lookup kernels #1 and #2
(names holding corr_window), the mean over ranks. Layer: lookups
(ops/corr.py)."""

UNIT = "ms"


def read(ctx):
    return ctx.per_call(lambda s: ctx.kernel_seconds(s, "corr_window"))
