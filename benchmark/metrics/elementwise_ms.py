"""Device milliseconds a call spends in elementwise kernels (harness/
profile.py's KINDS), the mean over ranks. Layer: the flow estimator and
the accumulation cells (models/raft.py, models/gma.py,
models/accflow.py, ops/)."""

from benchmark.harness.profile import by_kind

UNIT = "ms"


def read(ctx):
    return ctx.per_call(lambda s: by_kind(s).get("elementwise", 0.0))
