"""Sequence losses and metrics, the port's counterpart of
accflow_tpu/train/loss.py (reference loss.py):

- sequence_loss_raft (loss.py:4-25): gamma-weighted L1 over the
  per-iteration predictions, weight gamma^(n-1-i);
- sequence_loss_acc (loss.py:28-44): unweighted L1 summed over matched
  prediction / ground-truth lists;
- epe_metrics: EPE and the 1px / 3px / 5px rates of the final prediction.

Flows are channels-last, predictions stacked on a leading axis; the
metrics stay tensors on the flows' device (read them when needed).

Under a spatial handle (parallel/mesh.py: each rank holds its block of
rows) both losses and the metrics are means over the global pixels,
written as each rank's part: its pixels' sum over the global element count
of its data shard (the handle's height, whose blocks may differ by 8 rows,
not its own). The parts add up to the one-process value; the convention
is that each rank back-propagates its own part and the ranks' gradients
are summed over the spatial group (parallel.mesh.average_gradients), the
exchanges' backward carrying each part's gradient to the rows it read. No
rank back-propagates a sum over ranks (that and a gradient sum would count
every part n times). The train step reports the parts summed over the
group (parallel.mesh.spatial_sum, detached).
"""

from __future__ import annotations

import math

import torch

from accflow_tpu_torch.parallel import mesh


def _global_count(x: torch.Tensor, spatial, channel_dims: int) -> int:
    """The element count of (..., N, H, W, *C) over its last 3 +
    channel_dims axes, at the handle's global height (mesh.global_rows):
    its own count without a handle."""
    n, h, w, *c = x.shape[x.ndim - 3 - channel_dims:]
    return math.prod((n, mesh.global_rows(h, spatial), w, *c))


def epe_metrics(flow_final: torch.Tensor, flow_gt: torch.Tensor, spatial=None) -> dict:
    """EPE and the 1px / 3px / 5px rates over (N, H, W); with a spatial
    handle this rank's parts of them (module docstring)."""
    epe = torch.sqrt(torch.sum((flow_final - flow_gt) ** 2, dim=-1))
    count = _global_count(epe, spatial, 0)
    return {"epe": epe.sum() / count, "1px": (epe < 1).float().sum() / count,
            "3px": (epe < 3).float().sum() / count, "5px": (epe < 5).float().sum() / count}


def sequence_loss_raft(predictions: torch.Tensor, flow_gt: torch.Tensor, gamma: float = 0.8,
                       spatial=None):
    """predictions: (T, N, H, W, 2); flow_gt: (N, H, W, 2). spatial: both
    are this rank's rows, and the loss and metrics its parts (module
    docstring); without a handle each iteration's L1 is torch's mean."""
    t = predictions.shape[0]
    weights = gamma ** torch.arange(t - 1, -1, -1, dtype=torch.float32,
                                    device=predictions.device)
    err = torch.abs(predictions - flow_gt[None])
    if spatial is None:
        l1 = err.mean(dim=(1, 2, 3, 4))
    else:
        l1 = err.sum(dim=(1, 2, 3, 4)) / _global_count(err, spatial, 1)
    return torch.sum(weights * l1), epe_metrics(predictions[-1], flow_gt, spatial)


def sequence_loss_acc(predictions: torch.Tensor, flow_gts: torch.Tensor, spatial=None):
    """predictions, flow_gts: (S, N, H, W, 2), the accumulated outputs
    [F_{2,0}..F_{N,0}] against bflows [F20..F60]. spatial: both are this
    rank's rows, and the loss and metrics its parts (module docstring)."""
    if predictions.shape != flow_gts.shape:
        raise ValueError(f"length not match! {tuple(predictions.shape)} vs "
                         f"{tuple(flow_gts.shape)}")
    err = torch.abs(predictions - flow_gts)
    loss = (err.sum(dim=(1, 2, 3, 4)) / _global_count(err, spatial, 1)).sum()
    return loss, epe_metrics(predictions[-1], flow_gts[-1], spatial)
