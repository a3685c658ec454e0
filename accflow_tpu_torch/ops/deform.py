"""Modulated 3x3 deformable convolution (DCNv2, torchvision.ops.DeformConv2d
semantics), counterpart of accflow_tpu/ops/deform.py, in plain torch.

For each output pixel p and tap k = ky*3 + kx the input is sampled
bilinearly (zeros padding) at p + (ky-1, kx-1) + offset_k, scaled by the
tap's mask, and the 9 samples are contracted with the weights in one
(N*H*W, 9*Cin) x (9*Cin, Cout) matmul. Offset channel 2k is dy (row) and
2k+1 is dx (column); mask channels are ordered by k (torchvision's
layout, which the released checkpoints were trained against).
"""

from __future__ import annotations

import torch

from accflow_tpu_torch.ops.sampling import bilinear_sample
from accflow_tpu_torch.parallel import mesh


def deform_conv3x3(x, offsets, mask, weight, bias=None, spatial=None) -> torch.Tensor:
    """x (N, Cin, H, W); offsets (N, 18, H, W); mask (N, 9, H, W);
    weight (Cout, Cin, 3, 3); bias (Cout,) -> (N, Cout, H, W).

    Coordinates and tap weights are float32; the gathered values, the
    blend and the contraction keep x's dtype. spatial (a
    parallel.mesh.Spatial handle): x, offsets, mask and the output are this
    rank's rows; the taps sit at the rows' global positions and sample the
    whole height of x (mesh.gather_rows): the offsets are learned and
    unbounded, so no halo of fixed depth serves."""
    n, cin, h, w = x.shape
    row0 = 0
    if spatial is not None:
        row0 = spatial.row0(h)
        x = mesh.gather_rows(x, spatial, dim=2)
    cout = weight.shape[0]
    if tuple(weight.shape[-2:]) != (3, 3):
        raise ValueError(f"deform_conv3x3 takes a 3x3 kernel, got {tuple(weight.shape)}")
    dev = x.device
    off = offsets.float().reshape(n, 9, 2, h, w)
    ky = torch.arange(9, device=dev).div(3, rounding_mode="floor").float() - 1.0
    kx = torch.arange(9, device=dev).remainder(3).float() - 1.0
    gy = torch.arange(row0, row0 + h, dtype=torch.float32, device=dev).view(1, 1, h, 1)
    gx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, 1, w)
    py = gy + ky.view(1, 9, 1, 1) + off[:, :, 0]
    px = gx + kx.view(1, 9, 1, 1) + off[:, :, 1]
    coords = torch.stack([px, py], dim=-1).permute(0, 2, 3, 1, 4)  # (N, H, W, 9, 2)

    sampled = bilinear_sample(x.permute(0, 2, 3, 1), coords)  # (N, H, W, 9, Cin)
    sampled = sampled * mask.permute(0, 2, 3, 1).to(sampled.dtype)[..., None]
    wmat = weight.permute(2, 3, 1, 0).reshape(9 * cin, cout).to(x.dtype)
    out = sampled.reshape(n * h * w, 9 * cin) @ wmat
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.view(n, h, w, cout).permute(0, 3, 1, 2)
