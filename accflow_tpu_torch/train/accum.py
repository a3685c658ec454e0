"""Gradient accumulation over k micro-batches per optimizer step, the
port's counterpart of accflow_tpu/train/accum.py.

`grad_accum: k` in a train config splits every step's batch into k equal
micro-batches; each runs forward and backward with its loss scaled by 1/k,
the gradients add up in `.grad`, and the single update follows. Only one
micro-batch's activations are alive at a time. For the batch-mean losses
of train/loss.py with k dividing the batch, the gradients equal the full
batch's up to float32 summation order. Train-mode BatchNorm normalises
each micro-batch with its own statistics (the reference's DataParallel
semantics, as in JAX), and the running-statistics updates the
micro-batches keep are averaged, for the step to apply once. Nothing here
reads a device value on the host, so a CUDA graph of the train step
(graphs.CudaGraphedStep) holds the k micro-batches unrolled.
"""

from __future__ import annotations

import torch

from accflow_tpu_torch.nn.layers import collect_bn_updates


def split_batch(x: torch.Tensor, k: int, axis: int):
    """k equal chunks of x along `axis`; raises unless k divides it."""
    n = x.shape[axis]
    if n % k != 0:
        raise ValueError(f"grad_accum={k} must divide the batch ({n} on axis {axis} "
                         f"of {tuple(x.shape)})")
    return x.chunk(k, dim=axis)


def accumulate_grads(loss_fn, k: int, *arrays, axis: int = 1, model=None):
    """loss_fn(*arrays) -> (loss, metrics) over k micro-batches (every array
    carries the batch on `axis`): backward of each micro-batch's loss / k
    into `.grad`. Returns (loss, metrics, bn_updates): the loss and metrics
    as detached means over the micro-batches, and the mean of the
    running-statistics updates that `model`'s train-mode BatchNorm layers
    kept in each micro-batch's forward ({layer: (mean, var)},
    nn.layers.collect_bn_updates; empty without `model` or such layers).
    k=1 is one forward and backward of the whole batch."""
    chunks = list(zip(*(split_batch(a, k, axis) for a in arrays)))
    total, sums, bn = 0.0, {}, {}
    for chunk in chunks:
        loss, metrics = loss_fn(*chunk)
        (loss / k).backward()
        total = total + loss.detach() / k
        for m, v in metrics.items():
            sums[m] = sums.get(m, 0.0) + v.detach() / k
        if model is not None:
            for name, stats in collect_bn_updates(model).items():
                bn[name] = tuple(acc + s / k for acc, s in zip(bn.get(name, (0.0, 0.0)), stats))
    return total, sums, bn
