"""Coordinate grids and align_corners bilinear flow resizing, counterpart
of accflow_tpu/ops/grids.py. Flows are (N, H, W, 2) in (x, y) order."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """Pixel-coordinate grid (batch, ht, wd, 2) float32, channel order (x, y)."""
    ys, xs = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device),
        indexing="ij",
    )
    grid = torch.stack([xs, ys], dim=-1)
    return grid[None].expand(batch, ht, wd, 2).contiguous()


def resize_bilinear_align_corners(flow: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear align_corners=True resize of (N, H, W, C) to (N, h2, w2, C)
    in float32 (F.interpolate; degenerate size-1 axes read position 0)."""
    if tuple(out_hw) == tuple(flow.shape[1:3]):
        return flow
    x = F.interpolate(flow.float().permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=True)
    return x.permute(0, 2, 3, 1)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsample of a flow field (N, H, W, 2); values scaled by 8."""
    n, h, w, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, (8 * h, 8 * w))


def downflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear downsample of a flow field; values divided by 8."""
    n, h, w, _ = flow.shape
    if h % 8 != 0 or w % 8 != 0:
        raise ValueError(f"downflow8 requires /8 divisible dims, got {(h, w)}")
    return resize_bilinear_align_corners(flow, (h // 8, w // 8)) / 8.0
