"""Device milliseconds a call spends in NCCL's kernels, the mean over ranks:
transfers and the waits for the slowest rank inside them. Layer: mesh
(parallel/mesh.py)."""

UNIT = "ms"


def read(ctx):
    if len(ctx.ranks) < 2:
        return None
    return ctx.per_call(lambda s: ctx.kernel_seconds(s, "nccl"))
