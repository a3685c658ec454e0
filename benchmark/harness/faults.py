"""Faults planted under the timed path by the benchmark's tests, to show
that `correct` comes out false for each fault a clip cell can have. A
driven run never plants one.

Wrapped around the clip call (`wrap`):

- "stale": every call returns the previous call's flows (a state that
  is never updated);
- "half_batch": the second half of the batch gets the first half's flows
  (half the batch left out);
- "altered": one flow map of every call negated where it is produced.

Planted in the program before it is built (`plant`), so that the graph
captures them:

- "no_exchange": the height-split program's all_gathers return this
  rank's own tensor in every rank's place (the exchange between chips
  left out: halos, gathered keys and contexts, the norms' statistics);
- "lookup_zero", "lookup_offset", "lookup_coarsest": the window lookup of
  radius 4 over 4 levels (kernel #1, ops/corr_cuda.py::lookup_corr_fused,
  on the stored pyramid and on each `ondemand` chunk's rows alike)
  returns zeros, reads every window one cell to the right (x + 1 at
  level 0), or returns zeros in the coarsest level's channels.
"""

from __future__ import annotations

import torch

OUTPUT = ("stale", "half_batch", "altered")
LOOKUP = ("lookup_zero", "lookup_offset", "lookup_coarsest")
NAMES = OUTPUT + ("no_exchange",) + LOOKUP


def wrap(fn, fault: str | None):
    """`fn` (clip -> flows) with an output fault planted; `fn` itself for
    None or a fault that `plant` plants."""
    if fault is not None and fault not in NAMES:
        raise ValueError(f"unknown fault {fault!r}; the faults are {NAMES}")
    if fault not in OUTPUT:
        return fn
    held = {}

    def call(x):
        out = fn(x)
        if fault == "stale":
            prev, held["out"] = held.get("out", out), out
            return prev
        out = out.clone()
        if fault == "half_batch":
            half = out.shape[1] // 2
            out[:, half:] = out[:, :half]
        else:
            out[-1, 0] = -out[-1, 0]
        return out

    return call


def plant(fault: str | None):
    """Plant `fault` in the program if it is one planted there; returns
    the function that takes it out again."""
    if fault == "no_exchange":
        from accflow_tpu_torch.parallel import mesh

        owner, attr = mesh, "_all_gather"

        def faulty(t: torch.Tensor, group, size: int) -> torch.Tensor:
            return torch.stack([t.detach()] * size)
    elif fault in LOOKUP:
        from accflow_tpu_torch.ops import corr_cuda

        owner, attr = corr_cuda, "lookup_corr_fused"
        lookup = corr_cuda.lookup_corr_fused
        window = (2 * corr_cuda.RADIUS + 1) ** 2

        def faulty(levels, coords, radius=corr_cuda.RADIUS, out_dtype=torch.float32):
            if fault == "lookup_offset":
                coords = coords.clone()
                coords[:, 0] += 1.0
            out = lookup(levels, coords, radius, out_dtype=out_dtype)
            if fault == "lookup_zero":
                return torch.zeros_like(out)
            if fault == "lookup_coarsest":
                out = out.clone()
                out[:, -window:] = 0
            return out
    else:
        return lambda: None
    original = getattr(owner, attr)
    setattr(owner, attr, faulty)
    return lambda: setattr(owner, attr, original)
