"""The lookup kernels' share of their roofline: the least time of a call's
lookups on the cards (benchmark/work.py: the level cells the patches
touch read once, the windows written once, the coordinates read once, at
3.35 TB/s) over the device time of kernels whose names hold corr_window,
summed over ranks. The lookups are bound by bytes: at ~11 float32
operations a window entry their operations take under a tenth of the
bytes' time. Layer: kernels (csrc/)."""

UNIT = "%"


def read(ctx):
    spent = sum(ctx.kernel_seconds(s, "corr_window") for s in ctx.ranks)
    if spent <= 0 or not ctx.calls:
        return None
    least = ctx.work["lookup_bytes"] / ctx.HBM_BYTES_PER_S * ctx.calls
    return 100.0 * least / spent
