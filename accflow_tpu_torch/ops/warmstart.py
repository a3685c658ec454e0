"""Flow warm-starting helpers, counterpart of accflow_tpu/ops/warmstart.py.

- forward_splat_flow: on-device splatting of a flow field along an
  advection field (ops/softsplat.py), batched; the warm start of the
  streaming step (streaming.py) and of AccFlowConfig.warm_start.
- forward_interpolate_flow: the reference's host-side scipy forward
  interpolation (networks/raft/utils/utils.py:31-63), kept for API parity.
"""

from __future__ import annotations

import numpy as np
import torch

from accflow_tpu_torch.ops.softsplat import softsplat


def forward_interpolate_flow(flow: np.ndarray) -> np.ndarray:
    """Reference-parity scipy version. flow: (H, W, 2) numpy -> (H, W, 2):
    nearest-neighbour scattered interpolation of the forward-advected flow
    field (0 where no advected point lands inside the image)."""
    from scipy import interpolate

    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    if valid.sum() == 0:
        return np.zeros_like(flow)
    pts = (x1[valid], y1[valid])
    flow_x = interpolate.griddata(pts, dx.reshape(-1)[valid], (x0, y0),
                                  method="nearest", fill_value=0)
    flow_y = interpolate.griddata(pts, dy.reshape(-1)[valid], (x0, y0),
                                  method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)


def forward_splat_flow(flow: torch.Tensor, advect=None) -> torch.Tensor:
    """Splat `flow` (B, H, W, 2) forward along `advect` (average mode) ->
    (B, H, W, 2) float32. advect=None splats the flow along itself
    (upstream RAFT's constant-velocity warm start for consecutive pairs);
    pass -dflow for backward pair flows (the grid advances one frame).
    Holes become 0, the prior the scipy version uses outside its hull."""
    return softsplat(flow, flow if advect is None else advect, mode="average")
