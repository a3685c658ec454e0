"""Rematerialisation of a block under autograd, the port's counterpart of
JAX's jax.checkpoint policies: AccFlowConfig.remat wraps each accumulation
cell (models/accflow.py), the estimators' train forward each GRU iteration
(models/raft.py::raft_iterate, JAX's scan_remat). It changes what the
backward stores and recomputes, not the gradients.

No remat'd block draws random numbers (a train step's noise is drawn before
the forward), so the checkpoints run with preserve_rng_state=False, which
is exact: they neither read nor set the devices' RNG state, which a CUDA
graph capture of the step (graphs.CudaGraphedStep) would refuse.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_SAVED_BY_DOTS = {  # what remat="dots" keeps: JAX's checkpoint_dots
    torch.ops.aten.convolution.default,
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.baddbmm.default,
}


def _keep_dots(ctx, op, *args, **kwargs):
    """Keep conv and matmul outputs, and those of the port's kernel ops
    (namespace accflow: the correlation lookups), which stand for JAX's
    lookup einsums, dots that checkpoint_dots keeps too: a kernel's forward
    then runs once per step, not again in the backward."""
    del ctx, args, kwargs
    if op in _SAVED_BY_DOTS or getattr(op, "namespace", None) == "accflow":
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, remat):
    """`fn` under the remat policy `remat`, with autograd recording: False,
    None or "none" runs it as it is, True or "full" under
    torch.utils.checkpoint (nothing stored but its inputs), "dots" under a
    selective checkpoint that keeps conv, matmul and kernel-op outputs.
    Without autograd recording `fn` runs as it is."""
    if remat not in (False, None, "none", True, "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got {remat!r}")
    if remat in (False, None, "none") or not torch.is_grad_enabled():
        return fn
    if remat == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts, _keep_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx_fn,
                                     preserve_rng_state=False)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, preserve_rng_state=False)
