"""Gradient accumulation over k micro-batches per optimizer step, the
port's counterpart of accflow_tpu/train/accum.py.

`grad_accum: k` in a train config splits every step's batch into k equal
micro-batches; each runs forward and backward with its loss scaled by 1/k,
the gradients add up in `.grad`, and the single update follows. Only one
micro-batch's activations are alive at a time. For the batch-mean losses
of train/loss.py with k dividing the batch, the gradients equal the full
batch's up to float32 summation order.
"""

from __future__ import annotations

import torch


def split_batch(x: torch.Tensor, k: int, axis: int):
    """k equal chunks of x along `axis`; raises unless k divides it."""
    n = x.shape[axis]
    if n % k != 0:
        raise ValueError(f"grad_accum={k} must divide the batch ({n} on axis {axis} "
                         f"of {tuple(x.shape)})")
    return x.chunk(k, dim=axis)


def accumulate_grads(loss_fn, k: int, *arrays, axis: int = 1):
    """loss_fn(*arrays) -> (loss, metrics) over k micro-batches (every array
    carries the batch on `axis`): backward of each micro-batch's loss / k
    into `.grad`. Returns (loss, metrics), detached means over the
    micro-batches; k=1 is one forward and backward of the whole batch."""
    chunks = list(zip(*(split_batch(a, k, axis) for a in arrays)))
    total, sums = 0.0, {}
    for chunk in chunks:
        loss, metrics = loss_fn(*chunk)
        (loss / k).backward()
        total = total + loss.detach() / k
        for m, v in metrics.items():
            sums[m] = sums.get(m, 0.0) + v.detach() / k
    return total, sums
