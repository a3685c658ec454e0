"""Sequence losses and metrics, the port's counterpart of
accflow_tpu/train/loss.py (reference loss.py):

- sequence_loss_raft (loss.py:4-25): gamma-weighted L1 over the
  per-iteration predictions, weight gamma^(n-1-i);
- sequence_loss_acc (loss.py:28-44): unweighted L1 summed over matched
  prediction / ground-truth lists;
- epe_metrics: EPE and the 1px / 3px / 5px rates of the final prediction.

Flows are channels-last, predictions stacked on a leading axis; the
metrics stay tensors on the flows' device (read them when needed).
"""

from __future__ import annotations

import torch


def epe_metrics(flow_final: torch.Tensor, flow_gt: torch.Tensor) -> dict:
    epe = torch.sqrt(torch.sum((flow_final - flow_gt) ** 2, dim=-1)).reshape(-1)
    return {
        "epe": epe.mean(),
        "1px": (epe < 1).float().mean(),
        "3px": (epe < 3).float().mean(),
        "5px": (epe < 5).float().mean(),
    }


def sequence_loss_raft(predictions: torch.Tensor, flow_gt: torch.Tensor, gamma: float = 0.8):
    """predictions: (T, N, H, W, 2); flow_gt: (N, H, W, 2)."""
    t = predictions.shape[0]
    weights = gamma ** torch.arange(t - 1, -1, -1, dtype=torch.float32,
                                    device=predictions.device)
    l1 = torch.abs(predictions - flow_gt[None]).mean(dim=(1, 2, 3, 4))
    return torch.sum(weights * l1), epe_metrics(predictions[-1], flow_gt)


def sequence_loss_acc(predictions: torch.Tensor, flow_gts: torch.Tensor):
    """predictions, flow_gts: (S, N, H, W, 2), the accumulated outputs
    [F_{2,0}..F_{N,0}] against bflows [F20..F60]."""
    if predictions.shape != flow_gts.shape:
        raise ValueError(f"length not match! {tuple(predictions.shape)} vs "
                         f"{tuple(flow_gts.shape)}")
    loss = torch.abs(predictions - flow_gts).mean(dim=(1, 2, 3, 4)).sum()
    return loss, epe_metrics(predictions[-1], flow_gts[-1])
