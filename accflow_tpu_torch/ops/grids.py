"""Coordinate grids and align_corners bilinear flow resizing, counterpart
of accflow_tpu/ops/grids.py. Flows are (N, H, W, 2) in (x, y) order."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accflow_tpu_torch.parallel import mesh


def coords_grid(batch: int, ht: int, wd: int, device=None, row0: int = 0) -> torch.Tensor:
    """Pixel-coordinate grid (batch, ht, wd, 2) float32, channel order (x, y),
    of rows row0 .. row0 + ht - 1 (a rank's rows of a height-sharded map)."""
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + ht, dtype=torch.float32, device=device),
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


def upflow8(flow: torch.Tensor, spatial=None) -> torch.Tensor:
    """8x bilinear upsample of a flow field (N, H, W, 2); values scaled by 8.

    spatial (a parallel.mesh.Spatial handle): flow is this rank's rows of
    the 1/8 field, the output its rows at full resolution. The resize maps
    output row r to input row r (h8 - 1) / (H - 1) of the GLOBAL heights,
    which lies below r / 8: a rank's first output rows read the last row of
    the rank above, its last ones the first row of the rank below. One halo
    row each way (mesh.halo_rows) serves, and the blend is downflow8's."""
    n, h, w, _ = flow.shape
    if spatial is None:
        return 8.0 * resize_bilinear_align_corners(flow, (8 * h, 8 * w))
    h8, r0 = spatial.height(h), spatial.row0(h)
    f = flow.float()
    above, below = mesh.halo_rows(f, spatial, 1, 1, dim=1)
    y0, y1, ly = _taps(h8, 8 * h8, 8 * r0, 8 * h, flow.device)
    x0, x1, lx = _taps(w, 8 * w, 0, 8 * w, flow.device)
    return 8.0 * _blend(torch.cat([above, f, below], dim=1), y0 - (r0 - 1), y1 - (r0 - 1), ly,
                        x0, x1, lx)


def _blend(f, y0, y1, ly, x0, x1, lx) -> torch.Tensor:
    """F.interpolate's bilinear blend of rows y0/y1 and columns x0/x1 of f
    (N, H, W, C) at weights ly and lx: h0 (w0 x00 + w1 x01) + h1 (w0 x10 +
    w1 x11)."""
    def blend(r):
        return (1.0 - lx)[:, None] * r.index_select(2, x0) + lx[:, None] * r.index_select(2, x1)

    ly = ly.view(1, -1, 1, 1)
    return (1.0 - ly) * blend(f.index_select(1, y0)) + ly * blend(f.index_select(1, y1))


def _taps(n_in: int, n_out: int, start: int, count: int, device):
    """Output positions start .. start + count - 1 of an align_corners
    resize from n_in to n_out: the two source indices and the second's
    weight, in upsample_bilinear2d's float32 arithmetic (scale
    (n_in - 1) / (n_out - 1), source scale * i, its floor, the next index
    clamped to the last). The scale is the float32 quotient as a host
    number: no copy to the device, which a CUDA graph's capture refuses."""
    scale = float(torch.tensor(n_in - 1, dtype=torch.float32) / max(n_out - 1, 1))
    src = torch.arange(start, start + count, device=device).float() * scale
    i0 = src.long()
    lam = (src - i0).clamp(0.0, 1.0)
    return i0, torch.where(i0 < n_in - 1, i0 + 1, i0), lam


def downflow8(flow: torch.Tensor, spatial=None) -> torch.Tensor:
    """8x bilinear downsample of a flow field; values divided by 8.

    spatial (a parallel.mesh.Spatial handle): flow is this rank's rows of
    the full-resolution field, the output its rows at 1/8. The resize maps
    output row i to input row i (H - 1) / (H/8 - 1) = 8i + 7i / (H/8 - 1)
    of the GLOBAL height H, which lies in [8i, 8i + 7] with its next row
    inside 8i + 7 too (or at weight 0 on the last row): every row read is
    this rank's own, so nothing is exchanged. The blend is F.interpolate's,
    h0 (w0 x00 + w1 x01) + h1 (w0 x10 + w1 x11)."""
    n, h, w, _ = flow.shape
    if h % 8 != 0 or w % 8 != 0:
        raise ValueError(f"downflow8 requires /8 divisible dims, got {(h, w)}")
    if spatial is None:
        return resize_bilinear_align_corners(flow, (h // 8, w // 8)) / 8.0
    h8, height = h // 8, spatial.height(h)
    y0, y1, ly = _taps(height, height // 8, spatial.row0(h8), h8, flow.device)
    x0, x1, lx = _taps(w, w // 8, 0, w // 8, flow.device)
    base = spatial.row0(h)
    return _blend(flow.float(), y0 - base, y1 - base, ly, x0, x1, lx) / 8.0
