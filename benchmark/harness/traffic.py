"""The one general generator of clip traffic: a pool of distinct moving
clips made on the device from the seed, as a traffic file's parameters
say (`moving_clips`):

- frames, batch, height, width: each clip is (frames, batch, H, W, 3) in
  [-1, 1], replicate-padded to multiples of 8 as RAFT's InputPadder pads
  ("sintel" mode: the pad split between both sides; nothing at 1080 or
  512 rows);
- each batch element is a smooth random texture (uniform noise at 1/8
  scale, bilinearly enlarged, plus N(0, 0.05^2) grain), every frame the
  texture shifted on the torus by a velocity of up to `max_velocity`
  pixels a frame, redrawn every `velocity_period` frames (the first
  frame unshifted);
- pool: the number of distinct clips, drawn in turn from one generator
  seeded with the run's seed. Every seed gives clips of the same sizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def padded(n: int) -> tuple:
    """(before, after) padding that brings n to a multiple of 8."""
    pad = (((n // 8) + 1) * 8 - n) % 8
    return pad // 2, pad - pad // 2


def clip_shape(traffic: dict) -> tuple:
    """(T, N, H, W) of a clip as the program gets it (padded)."""
    h, w = traffic["height"], traffic["width"]
    return (traffic["frames"], traffic["batch"], h + sum(padded(h)), w + sum(padded(w)))


def moving_clip(gen: torch.Generator, t: int, n: int, h: int, w: int, vmax: int, period: int,
                device) -> torch.Tensor:
    coarse = torch.rand((n, 3, max(h // 8, 1), max(w // 8, 1)), generator=gen, device=device)
    tex = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    tex = (tex + 0.05 * torch.randn(tex.shape, generator=gen, device=device)).clamp(0, 1) * 2 - 1
    vel = torch.randint(-vmax, vmax + 1, ((t + period - 1) // period, n, 2), generator=gen,
                        device=device)
    vel = vel.repeat_interleave(period, dim=0)[:t].cpu()
    vel[0] = 0
    cum = vel.cumsum(0).tolist()
    frames = torch.stack([
        torch.stack([torch.roll(tex[b], shifts=(cum[i][b][1], cum[i][b][0]), dims=(1, 2))
                     for b in range(n)]) for i in range(t)])
    return frames.permute(0, 1, 3, 4, 2).contiguous()


def clip_pool(traffic: dict, seed: int, device) -> torch.Tensor:
    """(pool, T, N, H, W, 3) float32 clips on `device`, from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t, n, h, w = traffic["frames"], traffic["batch"], traffic["height"], traffic["width"]
    clips = torch.stack([moving_clip(gen, t, n, h, w, traffic["max_velocity"],
                                     traffic["velocity_period"], device)
                         for _ in range(traffic["pool"])])
    (top, bottom), (left, right) = padded(h), padded(w)
    if top or bottom or left or right:
        p, t_, n_ = clips.shape[:3]
        x = clips.reshape(p * t_ * n_, h, w, 3).permute(0, 3, 1, 2)
        x = F.pad(x, (left, right, top, bottom), mode="replicate")
        clips = x.permute(0, 2, 3, 1).reshape(p, t_, n_, *x.shape[-2:], 3).contiguous()
    return clips
