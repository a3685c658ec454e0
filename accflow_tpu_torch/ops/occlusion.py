"""AccFlow's photometric occlusion (getOcc, networks/AccFlow_.py:127-135),
counterpart of accflow_tpu/ops/occlusion.py."""

from __future__ import annotations

import torch

from accflow_tpu_torch.ops.sampling import backwarp


def photometric_occ(flow12, feat1, feat2, binary: bool = True) -> torch.Tensor:
    """Warp feat2 (N, H, W, C) by flow12 (N, H, W, 2) and compare to feat1.

    binary=True: (N, H, W, 1) float32 map, 1 where the mean abs error is
    <= 1.0 (visible). binary=False: the raw abs error map (N, H, W, C)."""
    err = torch.abs(feat1 - backwarp(feat2, flow12))
    if binary:
        err = err.mean(dim=-1, keepdim=True)
        return (err <= 1.0).float()
    return err
