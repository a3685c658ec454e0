"""The generic loss zoo, the port's counterpart of
accflow_tpu/train/losses_extra.py (reference networks/losses.py: defined
there, imported by no entry point; kept for API completeness).

L1, L2, Charbonnier, a multi-scale weighted sum, and `get_loss(loss_type)`
keyed as the configs spell `loss_type`. Flows are (N, H, W, C).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from accflow_tpu_torch.ops.grids import resize_bilinear_align_corners


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target).mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.sqrt((pred - target) ** 2 + eps ** 2).mean()


def multiscale_loss(preds: Sequence[torch.Tensor], target: torch.Tensor,
                    weights: Optional[Sequence[float]] = None,
                    base: Callable = l1_loss) -> torch.Tensor:
    """Weighted sum over multi-resolution predictions; the target is resized
    (align_corners, values scaled with the width ratio) to each level."""
    if weights is None:
        weights = [0.32 / (2 ** i) for i in range(len(preds))]
    total = 0.0
    th, tw = target.shape[1:3]
    for w, p in zip(weights, preds):
        ph, pw = p.shape[1:3]
        if (ph, pw) != (th, tw):
            scaled = resize_bilinear_align_corners(target, (ph, pw)) * (pw / tw)
        else:
            scaled = target
        total = total + w * base(p, scaled)
    return total


def get_loss(loss_type: str) -> Callable:
    table = {"l1": l1_loss, "l2": l2_loss, "charbonnier": charbonnier_loss}
    key = loss_type.lower()
    if key not in table:
        raise NotImplementedError(f"loss {loss_type!r} not supported")
    return table[key]
