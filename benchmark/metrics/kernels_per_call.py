"""Device kernels a call launches, from the profile of the window's graph
replays (the mean over ranks). The op wrappers' launch counters count no
replay, so they are not read. Layer: graphs (graphs.py)."""

UNIT = "kernels"


def read(ctx):
    counts = [sum(n for _, n in s["kernels"].values()) for s in ctx.ranks]
    if not any(counts) or not ctx.calls:
        return None
    return sum(counts) / len(counts) / ctx.calls
