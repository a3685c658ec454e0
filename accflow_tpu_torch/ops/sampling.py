"""Bilinear sampling with grid_sample semantics (align_corners=True, zeros
padding), counterpart of accflow_tpu/ops/sampling.py.

Written as four explicit corner gathers, each masked on its own when it
falls outside the image, rather than through F.grid_sample: the same
arithmetic as the JAX reference, and no library sampler on the GPU path.
Layouts are the JAX ones: images (B, H, W, C), coords (..., 2) in (x, y).
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample img (B, H, W, C) at pixel coords (B, ..., 2) -> (B, ..., C).

    Integer coords hit pixel centres; valid ranges are [0, W-1] x [0, H-1].
    Taps outside contribute zero. The weights are float32; the gathered
    values and the blend keep img's dtype."""
    b, h, w, c = img.shape
    out_shape = coords.shape[:-1] + (c,)
    if h == 0 or w == 0:
        return img.new_zeros(out_shape)
    pts = coords.reshape(b, -1, 2).float()
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(b * h * w, c)
    base = (torch.arange(b, device=img.device) * (h * w)).view(b, 1)

    def tap(xi, yi, weight):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = flat.index_select(0, idx.reshape(-1)).view(b, -1, c)
        return vals * (weight * valid).unsqueeze(-1).to(vals.dtype)

    out = (
        tap(x0, y0, (1.0 - fx) * (1.0 - fy))
        + tap(x0 + 1.0, y0, fx * (1.0 - fy))
        + tap(x0, y0 + 1.0, (1.0 - fx) * fy)
        + tap(x0 + 1.0, y0 + 1.0, fx * fy)
    )
    return out.reshape(out_shape)


def bilinear_sample_backward(grad: torch.Tensor, coords: torch.Tensor, h: int, w: int,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The gradient of bilinear_sample(img, coords) with respect to img
    (B, h, w, C), for the output's gradient grad (B, ..., C): the transpose
    of the four masked corner gathers, each tap's weighted gradient added
    into its pixel in float32 (what autograd of bilinear_sample computes, in
    another summation order), cast once to `dtype`."""
    b, c = grad.shape[0], grad.shape[-1]
    out = torch.zeros((b * h * w, c), dtype=torch.float32, device=grad.device)
    if h == 0 or w == 0:
        return out.view(b, h, w, c).to(dtype)
    pts = coords.float().reshape(*grad.shape[:-1], 2).flatten(1, -2)
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    g = grad.float().flatten(1, -2)
    base = (torch.arange(b, device=grad.device) * (h * w)).view(b, 1)

    def tap(xi, yi, weight):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        out.index_add_(0, idx.reshape(-1), (g * (weight * valid).unsqueeze(-1)).reshape(-1, c))

    tap(x0, y0, (1.0 - fx) * (1.0 - fy))
    tap(x0 + 1.0, y0, fx * (1.0 - fy))
    tap(x0, y0 + 1.0, (1.0 - fx) * fy)
    tap(x0 + 1.0, y0 + 1.0, fx * fy)
    return out.view(b, h, w, c).to(dtype)


def backwarp(image: torch.Tensor, flow: torch.Tensor, spatial=None) -> torch.Tensor:
    """Backward-warp (B, H, W, C) by flow (B, H, W, 2): out(p) = image(p + flow).

    spatial (a parallel.mesh.Spatial handle): flow and the output are this
    rank's rows, at their global positions, and `image` is the whole
    height (mesh.gather_rows), since p + flow may land on any row."""
    h, w = flow.shape[1:3]
    row0 = 0 if spatial is None else spatial.row0(h)
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + h, dtype=torch.float32, device=image.device),
        torch.arange(w, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    grid = torch.stack([xs, ys], dim=-1)[None]
    return bilinear_sample(image, grid + flow.float())
