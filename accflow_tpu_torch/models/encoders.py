"""RAFT feature and context encoders (NCHW), counterpart of
accflow_tpu/models/encoders.py.

BasicEncoder: 7x7/2 stem, three residual stages (64, 96, 128 channels,
strides 1, 2, 2), 1x1 output conv; total stride 8. Norm modes: "instance"
(RAFT fnet), "batch" (frozen, RAFT cnet) and "none" (AccFlow context).
Submodule names follow the reference state_dict; the downsample norm is
stored once, under `downsample.1`, as in the JAX tree (the reference also
aliases it as `norm3`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from accflow_tpu_torch.nn.layers import Conv2d, make_norm


def _conv(cin, cout, k, stride=1):
    return Conv2d(cin, cout, k, stride=stride, init="kaiming_normal_out")


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                _conv(in_planes, planes, 1, stride), make_norm(norm_fn, planes)
            )

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """(N, 3, H, W) -> (N, output_dim, H/8, W/8)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 input_dim: int = 3):
        super().__init__()
        self.conv1 = _conv(input_dim, 64, 7, 2)
        self.norm1 = make_norm(norm_fn, 64)
        in_planes = 64
        for idx, (planes, stride) in enumerate(zip((64, 96, 128), (1, 2, 2)), 1):
            setattr(self, f"layer{idx}", nn.Sequential(
                ResidualBlock(in_planes, planes, norm_fn, stride),
                ResidualBlock(planes, planes, norm_fn, 1),
            ))
            in_planes = planes
        self.conv2 = _conv(128, output_dim, 1)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
