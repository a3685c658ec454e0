"""The share of the traced window in which no device activity runs (the
union of the kernels', copies' and sets' intervals in the profile), the
mean over ranks. Layer: device."""

UNIT = "%"


def read(ctx):
    if ctx.window_s <= 0 or not any(s["busy_s"] for s in ctx.ranks):
        return None
    busy = sum(s["busy_s"] for s in ctx.ranks) / len(ctx.ranks)
    return 100.0 * (1.0 - busy / ctx.window_s)
