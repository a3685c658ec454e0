"""RAFT (Teed & Deng, ECCV 2020) and GMA (Jiang et al., ICCV 2021) pair
flows in plain PyTorch, one pair at a time.

RAFT: the all-pairs correlation of a pair's 1/8-scale features, <f1(q),
f2_l(k)> / sqrt(C) against f2 average-pooled 2x per level, stored for one
pair at a time (the blocks that let a 1080p clip fit: 5.7 GB a pair in
float32 where the whole clip's 11 pairs would take 62 GB); a window of
(2r+1)^2 bilinear taps per level around coords / 2^l, zeros outside, with
channel l*(2r+1)^2 + a*(2r+1) + b at (x/2^l + a - r, y/2^l + b - r); the
motion encoder, a separable ConvGRU (1x5 then 5x1), the flow head, and
the convex upsampling of the last iteration's flow with a 0.25-scaled
mask.

GMA: RAFT plus one attention over the context features, content only:
softmax over keys of (q . k) / sqrt(dim_head), q and k from one bias-free
1x1 conv of the context, built once per pair; every iteration aggregates
v = to_v(motion) through it and adds gamma times the result to the motion
features, which join the GRU's input beside them.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.layers import Arith, basic_encoder, bilinear, conv, convex_upsample


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).float()


def pyramid(a: Arith, f1: torch.Tensor, f2: torch.Tensor, levels: int) -> list:
    """f1, f2 (N, C, h, w) -> `levels` maps (N*h*w, hl, wl)."""
    n, c, h, w = f1.shape
    q = f1.reshape(n, c, h * w).transpose(1, 2)
    out, keys = [], f2
    for lvl in range(levels):
        if lvl:  # 2x2 mean; an odd last row or column is dropped
            hk, wk = keys.shape[-2] // 2, keys.shape[-1] // 2
            keys = keys[..., :2 * hk, :2 * wk].reshape(n, c, hk, 2, wk, 2).mean(dim=(3, 5))
        hl, wl = keys.shape[-2:]
        corr = a.matmul(q, keys.reshape(n, c, hl * wl)) / math.sqrt(c)
        out.append(corr.reshape(n * h * w, hl, wl))
    return out


def lookup(levels: list, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """coords (Q, 2) in level-0 pixels -> (Q, L*(2r+1)^2) windows."""
    d = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)
    dx = d.repeat_interleave(2 * radius + 1)  # the outer index a carries x
    dy = d.repeat(2 * radius + 1)
    outs = []
    for lvl, corr in enumerate(levels):
        if corr.numel() == 0:  # a map pooled to nothing reads zeros
            outs.append(coords.new_zeros(coords.shape[0], dx.numel()))
            continue
        c = coords / 2 ** lvl
        px = c[:, 0:1] + dx[None]
        py = c[:, 1:2] + dy[None]
        outs.append(bilinear(corr[:, None], px, py)[:, 0])
    return torch.cat(outs, dim=1)


def _motion(a: Arith, sd: dict, flow, corr):
    p = "update_block.encoder."
    cor = torch.relu(conv(a, sd, p + "convc1", corr))
    cor = torch.relu(conv(a, sd, p + "convc2", cor))
    flo = torch.relu(conv(a, sd, p + "convf1", flow))
    flo = torch.relu(conv(a, sd, p + "convf2", flo))
    out = torch.relu(conv(a, sd, p + "conv", torch.cat([cor, flo], dim=1)))
    return torch.cat([out, flow], dim=1)


def _gru(a: Arith, sd: dict, h, x):
    p = "update_block.gru."
    for ax in "12":
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv(a, sd, p + "convz" + ax, hx))
        r = torch.sigmoid(conv(a, sd, p + "convr" + ax, hx))
        q = torch.tanh(conv(a, sd, p + "convq" + ax, torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
    return h


def attention(a: Arith, sd: dict, inp: torch.Tensor, dim_head: int) -> torch.Tensor:
    """GMA's content-only attention of context features (N, C, h, w) ->
    (N, hw, hw), one head."""
    n, _, h, w = inp.shape
    qk = a.conv(inp, sd["att.to_qk.weight"])
    q, k = qk.flatten(2).transpose(1, 2).split(dim_head, dim=2)
    return torch.softmax(a.matmul(q, k.transpose(1, 2)) / math.sqrt(dim_head), dim=-1)


def aggregate(a: Arith, sd: dict, attn: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
    n, c, h, w = motion.shape
    v = a.conv(motion, sd["update_block.aggregator.to_v.weight"]).flatten(2).transpose(1, 2)
    out = a.matmul(attn, v).transpose(1, 2).reshape(n, -1, h, w)
    return motion + sd["update_block.aggregator.gamma"] * out


def refine(a: Arith, sd: dict, cfg: dict, f1, f2, net, inp, attn=None) -> torch.Tensor:
    """The GRU loop of one pair from its features: f1, f2 (N, C, h, w),
    net, inp (N, 128, h, w) -> the upsampled flow (N, 2, 8h, 8w)."""
    n, _, h, w = f1.shape
    levels = pyramid(a, f1, f2, cfg["corr_levels"])
    ys, xs = torch.meshgrid(torch.arange(h, device=f1.device, dtype=torch.float32),
                            torch.arange(w, device=f1.device, dtype=torch.float32), indexing="ij")
    coords0 = torch.stack([xs, ys])[None].expand(n, 2, h, w)
    coords1 = coords0.clone()
    for _ in range(cfg["iters"]):
        corr = lookup(levels, coords1.permute(0, 2, 3, 1).reshape(-1, 2), cfg["corr_radius"])
        corr = corr.view(n, h, w, -1).permute(0, 3, 1, 2)
        motion = _motion(a, sd, coords1 - coords0, corr)
        if attn is not None:
            motion = torch.cat([motion, aggregate(a, sd, attn, motion)], dim=1)
        net = _gru(a, sd, net, torch.cat([inp, motion], dim=1))
        hidden = torch.relu(conv(a, sd, "update_block.flow_head.conv1", net))
        coords1 = coords1 + conv(a, sd, "update_block.flow_head.conv2", hidden)
    mask = torch.relu(conv(a, sd, "update_block.mask.0", net))
    mask = 0.25 * conv(a, sd, "update_block.mask.2", mask)
    return convex_upsample(coords1 - coords0, mask)


def pair_flows(a: Arith, sd: dict, cfg: dict, frames: torch.Tensor, src, dst) -> list:
    """Flows src[i] -> dst[i] of frames (K, N, H, W, 3) in [-1, 1]: a list
    of (N, 2, H, W), one pair at a time. cfg: the configuration file's
    estimator entry (corr_levels, corr_radius, iters, hidden_dim,
    attention_heads, dim_head; attention_heads 0 for RAFT)."""
    used = sorted(set(src) | set(dst))
    fmaps = {i: basic_encoder(a, sd, "fnet.", _nchw(frames[i]), "instance") for i in used}
    hd = cfg["hidden_dim"]
    state = {}
    for i in sorted(set(src)):
        out = basic_encoder(a, sd, "cnet.", _nchw(frames[i]), "batch")
        net, inp = torch.tanh(out[:, :hd]), torch.relu(out[:, hd:])
        attn = attention(a, sd, inp, cfg["dim_head"]) if cfg["attention_heads"] else None
        state[i] = (net, inp, attn)
    return [refine(a, sd, cfg, fmaps[i], fmaps[j], *state[i]) for i, j in zip(src, dst)]
