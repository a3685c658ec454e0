"""AccFlow's backward accumulation (Wu et al., ICCV 2023; networks/AccFlow_.py)
in plain PyTorch: the long-range flows F_{i,0}, i = 2 .. T-1, of a clip.

The estimator gives three kinds of 1/8-scale flows (full-resolution pair
flows resized with align_corners and divided by 8): the local f_{i,i-1},
the direct F_{i,0} and the seed F_{1,0}. A context encoder (RAFT's basic
encoder without norm) encodes every frame. Each step i encodes the local,
direct and carried flows (FlowEncoder), marks where frame i's context
differs from frame i-1's warped by the local flow (the binary occlusion
map, mean |error| <= 1 means visible), runs AccPlus (a modulated 3x3
deformable conv of the carried encoding, its offsets and masks from a
ZeroConv scaled by exp(3 * scale)), blends the result with the direct
flow's encoding by a mask of the direct flow's context error map, and
decodes the carry at 1/8 scale and the flow at full scale (convex
upsampling).
"""

from __future__ import annotations

import torch

from benchmark.reference.layers import (
    Arith,
    backwarp,
    basic_encoder,
    bilinear,
    conv,
    convex_upsample,
    downflow8,
)
from benchmark.reference.raft import pair_flows


def _stack(a: Arith, sd: dict, p: str, x):
    return conv(a, sd, p + ".2", torch.relu(conv(a, sd, p + ".0", x)))


def _flow_encoder(a: Arith, sd: dict, flow):
    x = torch.relu(conv(a, sd, "flow_encoder.conv1", flow))
    x = torch.relu(conv(a, sd, "flow_encoder.conv2", x))
    return conv(a, sd, "flow_encoder.conv3", x)


def deform3x3(a: Arith, x, offsets, mask, weight, bias):
    """Modulated deformable conv (torchvision's DeformConv2d layout): tap k
    = ky*3 + kx samples x at p + (ky - 1, kx - 1) + (offsets[2k], offsets[2k
    + 1]) (dy, dx), bilinear with zeros outside, scaled by mask[k]; the
    taps are contracted with the weight as one matrix product."""
    n, c, h, w = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=x.device, dtype=torch.float32),
                            torch.arange(w, device=x.device, dtype=torch.float32), indexing="ij")
    taps = []
    for k in range(9):
        py = ys + (k // 3 - 1) + offsets[:, 2 * k]
        px = xs + (k % 3 - 1) + offsets[:, 2 * k + 1]
        taps.append(bilinear(x, px, py) * mask[:, k: k + 1])
    cols = torch.stack(taps, dim=1).permute(0, 3, 4, 1, 2).reshape(n * h * w, 9 * c)
    wmat = weight.permute(2, 3, 1, 0).reshape(9 * c, -1)
    out = a.matmul(cols, wmat) + bias
    return out.view(n, h, w, -1).permute(0, 3, 1, 2)


def _accplus(a: Arith, sd: dict, df, f, o, c):
    x = _stack(a, sd, "accplus.conv1", torch.cat([df, f, o], dim=1))
    x = torch.relu(conv(a, sd, "accplus.conv2.0", torch.cat([x, c], dim=1)))
    x = torch.relu(conv(a, sd, "accplus.conv2.2", x))
    x = conv(a, sd, "accplus.conv2.4.conv", x) * torch.exp(3 * sd["accplus.conv2.4.scale"])
    off, m = x[:, :18], torch.sigmoid(x[:, 18:])
    f_ = deform3x3(a, f, off, m, sd["accplus.dconv.weight"], sd["accplus.dconv.bias"])
    x = _stack(a, sd, "accplus.conv3", torch.cat([f_, df, o], dim=1))
    x = torch.relu(conv(a, sd, "accplus.conv4.0", torch.cat([x, c, f_, df], dim=1)))
    x = torch.relu(conv(a, sd, "accplus.conv4.2", x))
    return conv(a, sd, "accplus.conv4.4", x)


def _decode(a: Arith, sd: dict, x):
    flow = _stack(a, sd, "flow_decoder.flow", x)
    return flow, convex_upsample(flow, _stack(a, sd, "flow_decoder.mask", x))


def clip_flows(a: Arith, est_sd: dict, acc_sd: dict, cfg: dict, images: torch.Tensor):
    """images (T, N, H, W, 3) in [-1, 1] -> (T-2, N, H, W, 2) float32
    flows [F_{2,0} .. F_{T-1,0}]. cfg: the configuration file's
    `estimator` entry (reference/raft.py::pair_flows)."""
    t = images.shape[0]
    s = t - 2
    src = tuple(range(2, t)) + tuple(range(2, t)) + (1,)
    dst = tuple(range(1, t - 1)) + (0,) * s + (0,)
    small = [downflow8(f) for f in pair_flows(a, est_sd, cfg, images, src, dst)]
    dflows, inis, carry = small[:s], small[s: 2 * s], small[2 * s]
    ctx = [basic_encoder(a, acc_sd, "context.", images[i].permute(0, 3, 1, 2).float(), "none")
           for i in range(t)]
    outs = []
    for k in range(s):
        i = k + 2
        err = (ctx[i] - backwarp(ctx[i - 1], dflows[k])).abs().mean(dim=1, keepdim=True)
        occ = (err <= 1.0).float()
        emap = (ctx[i] - backwarp(ctx[0], inis[k])).abs()
        f_ini, df = _flow_encoder(a, acc_sd, inis[k]), _flow_encoder(a, acc_sd, dflows[k])
        f_acc = _accplus(a, acc_sd, df, _flow_encoder(a, acc_sd, carry), occ, ctx[i])
        blend = torch.sigmoid(_stack(a, acc_sd, "blending.mask", emap))
        carry, out = _decode(a, acc_sd, f_ini * blend + (1 - blend) * f_acc)
        outs.append(out.permute(0, 2, 3, 1))
    return torch.stack(outs)
