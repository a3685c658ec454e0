"""Plain PyTorch building blocks of the reference: the arithmetic (float32
with TF32 off, or the control's float8), convolutions, norms, bilinear
sampling and the resizes. Weights come as a flat state dict (name ->
tensor) under the upstream RAFT / GMA / AccFlow parameter names.

Nothing here imports the measured program: every formula is written out
from the papers' released code (RAFT's corr.py, update.py, extractor.py;
AccFlow's networks/AccFlow_.py; torchvision's DeformConv2d semantics).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


class Arith:
    """float32 arithmetic: every convolution and matrix product takes its
    operands as they are. Run under `exact()` so that no float32 product
    runs in TF32."""

    name = "float32"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def conv(self, x, w, b=None, stride: int = 1):
        kh, kw = w.shape[-2:]
        y = F.conv2d(self.round(x), self.round(w), None, stride, ((kh - 1) // 2, (kw - 1) // 2))
        return y if b is None else y + b.view(1, -1, 1, 1)

    def matmul(self, a, b):
        return torch.matmul(self.round(a), self.round(b))


class Float8Arith(Arith):
    """The control: every operand of a convolution or a matrix product
    rounded to float8 e4m3 with a per-tensor scale (its largest magnitude
    mapped to 448, e4m3's largest value), the products then taken in
    float32. The flow state and everything between the products stay
    float32."""

    name = "float8_e4m3"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        scale = 448.0 / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale


@contextlib.contextmanager
def exact():
    """TF32 off for cuBLAS and cuDNN within the block, and cuDNN left to
    time its float32 algorithms (its default picks, without TF32, took
    36 s for one 1080p clip on an H100 where the timed ones take 2-4 s);
    restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = prev


def conv(a: Arith, sd: dict, name: str, x, stride: int = 1):
    return a.conv(x, sd[name + ".weight"], sd.get(name + ".bias"), stride)


def norm(sd: dict, name: str, x, kind: str):
    """"instance": per (sample, channel) over H, W, biased variance, eps
    1e-5, no affine; "batch": frozen, the running statistics; "none"."""
    if kind == "instance":
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + 1e-5)
    if kind == "batch":
        scale = sd[name + ".weight"] / torch.sqrt(sd[name + ".running_var"] + 1e-5)
        shift = sd[name + ".bias"] - sd[name + ".running_mean"] * scale
        return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    if kind == "none":
        return x
    raise ValueError(kind)


def basic_encoder(a: Arith, sd: dict, p: str, x, kind: str):
    """RAFT's BasicEncoder (extractor.py): 7x7/2 stem, residual stages of
    64, 96, 128 channels at strides 1, 2, 2, a 1x1 output conv. x (N, 3, H,
    W) -> (N, C, H/8, W/8)."""
    x = torch.relu(norm(sd, p + "norm1", conv(a, sd, p + "conv1", x, 2), kind))
    for layer, stride in ((1, 1), (2, 2), (3, 2)):
        for blk in (0, 1):
            q = f"{p}layer{layer}.{blk}."
            s = stride if blk == 0 else 1
            y = torch.relu(norm(sd, q + "norm1", conv(a, sd, q + "conv1", x, s), kind))
            y = torch.relu(norm(sd, q + "norm2", conv(a, sd, q + "conv2", y), kind))
            if q + "downsample.0.weight" in sd:
                x = norm(sd, q + "downsample.1", conv(a, sd, q + "downsample.0", x, s), kind)
            x = torch.relu(x + y)
    return conv(a, sd, p + "conv2", x)


def bilinear(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W) sampled at pixel positions px, py (B, ...) with
    align_corners semantics and zeros outside -> (B, C, ...): four corner
    gathers, each corner dropped on its own where it lies outside."""
    b, c, h, w = img.shape
    shape = px.shape[1:]
    px, py = px.reshape(b, -1), py.reshape(b, -1)
    x0, y0 = torch.floor(px), torch.floor(py)
    flat = img.reshape(b, c, h * w)
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (1 - (px - xi).abs()) * (1 - (py - yi).abs())
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = torch.gather(flat, 2, idx[:, None, :].expand(b, c, idx.shape[1]))
        out = out + vals * (wgt * inside)[:, None, :]
    return out.reshape(b, c, *shape)


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = img(p + flow(p)); img (B, C, H, W), flow (B, 2, H, W) in
    (x, y) order."""
    b, _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device, dtype=flow.dtype),
                            torch.arange(w, device=flow.device, dtype=flow.dtype), indexing="ij")
    return bilinear(img, xs + flow[:, 0], ys + flow[:, 1])


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT's convex 8x upsampling: flow (N, 2, h, w), mask (N, 576, h, w),
    channel k*64 + r*8 + s for tap k of the 3x3 neighbourhood and sub-pixel
    (r, s) -> (N, 2, 8h, 8w)."""
    n, _, h, w = flow.shape
    m = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    nb = F.unfold(8 * flow, 3, padding=1).view(n, 2, 9, 1, 1, h, w)
    up = (m * nb).sum(dim=2)  # (N, 2, r, s, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def downflow8(flow: torch.Tensor) -> torch.Tensor:
    """(N, 2, H, W) -> (N, 2, H/8, W/8): bilinear, align_corners, values / 8."""
    h, w = flow.shape[-2:]
    return F.interpolate(flow, size=(h // 8, w // 8), mode="bilinear", align_corners=True) / 8
