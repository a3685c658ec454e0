"""MiB a rank sends in the exchanges of one call, by the program's own
counter (mesh.bytes_sent, which a graph's replay adds to), the mean over
ranks. Layer: mesh (parallel/mesh.py)."""

UNIT = "MiB"


def read(ctx):
    sent = [s["bytes_sent"] for s in ctx.ranks]
    if len(sent) < 2 or not any(sent) or not ctx.calls:
        return None
    return sum(sent) / len(sent) / ctx.calls / 2 ** 20
