"""The whole clip's share of the cards' peak: the operations one call needs
(benchmark/work.py, from the configuration's shapes) times the calls of
the window, over the window's seconds times 989 TFLOP/s (dense bfloat16)
a card. Layer: the whole clip (serving.py -> models/accflow.py)."""

UNIT = "%"


def read(ctx):
    if not ctx.calls or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.work["flops"] * ctx.calls / (ctx.window_s * ctx.PEAK_BF16_FLOPS * ctx.chips)
