"""Occlusion estimation, counterpart of accflow_tpu/ops/occlusion.py:
- calc_occ_mask: bidirectional-consistency occlusion for evaluation
  (test_cvo.py:53-78): thresh = 0.01*(|f| + |b|) + 0.5;
- photometric_occ: AccFlow's getOcc (networks/AccFlow_.py:127-135)."""

from __future__ import annotations

import torch

from accflow_tpu_torch.ops.sampling import backwarp


def _length(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 magnitude over the flow channel dim, keepdims."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def calc_occ_mask(bflow: torch.Tensor, fflow: torch.Tensor):
    """Bidirectional occlusion masks of a pair's backward and forward flows
    (N, H, W, 2). Returns (occ_bw, occ_fw), float32 (N, H, W, 1) maps,
    1 = occluded."""
    mag = _length(fflow) + _length(bflow)
    diff_fw = fflow + backwarp(bflow, fflow)
    diff_bw = bflow + backwarp(fflow, bflow)
    thresh = 0.01 * mag + 0.5
    return (_length(diff_bw) > thresh).float(), (_length(diff_fw) > thresh).float()


def photometric_occ(flow12, feat1, feat2, binary: bool = True, spatial=None) -> torch.Tensor:
    """Warp feat2 (N, H, W, C) by flow12 (N, H, W, 2) and compare to feat1.

    binary=True: (N, H, W, 1) float32 map, 1 where the mean abs error is
    <= 1.0 (visible). binary=False: the raw abs error map (N, H, W, C).
    spatial: flow12, feat1 and the map are this rank's rows, feat2 the
    whole height (backwarp)."""
    err = torch.abs(feat1 - backwarp(feat2, flow12, spatial))
    if binary:
        err = err.mean(dim=-1, keepdim=True)
        return (err <= 1.0).float()
    return err
