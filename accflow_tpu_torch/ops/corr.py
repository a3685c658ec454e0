"""All-pairs correlation pyramid and its plain window lookup, counterpart
of accflow_tpu/ops/corr.py (`build_corr_pyramid`, `lookup_corr_gather`).

Pyramid: level l holds corr(q, k) = <f1(q), f2_l(k)> / sqrt(C) for every
query pixel q of f1 against f2 average-pooled 2x l times (pooling drops an
odd last row or column). Pooling f2 first equals pooling the volume, since
the product is linear in f2. Each level is stored flat over queries as
(Q, hl, wl), Q = B*H*W in (b, y, x) order.

Lookup: for every query and level, the (2r+1)^2 bilinear window of the
query's own map around coords/2^l (align_corners, zeros outside), levels
concatenated level-major. Window-offset quirk kept for checkpoint parity:
channel l*81 + a*9 + b samples (x/2^l + a - r, y/2^l + b - r), so the outer
index a carries the x offset (networks/raft/corr.py:32-38).

`lookup_corr_plain` is the explicit 4-corner gather: the CPU path and the
oracle of the CUDA kernel (ops/corr_cuda.py), which the GPU path runs.
"""

from __future__ import annotations

import math

import torch

from accflow_tpu_torch.nn.layers import tf32
from accflow_tpu_torch.ops.sampling import bilinear_sample


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x2/stride-2 average pool over H, W of (B, C, H, W); an odd
    last row/column is dropped, and a size-1 axis pools to size 0."""
    b, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :, : 2 * h2, : 2 * w2].reshape(b, c, h2, 2, w2, 2)
    return x.mean(dim=(3, 5))


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4, dtype=torch.float32):
    """fmap1, fmap2 (B, C, H, W) -> list of num_levels (B*H*W, hl, wl) maps.

    The products run in float32. With bfloat16 features the float32 matmul
    is exact under TF32 (10 mantissa bits hold the 7 of bf16), so TF32 is
    allowed then — the counterpart of JAX's corr_precision="default". With
    float32 features TF32 is off. `dtype` is the stored levels' type."""
    b, c, h, w = fmap1.shape
    bf16_valued = fmap1.dtype == torch.bfloat16 and fmap2.dtype == torch.bfloat16
    f1 = fmap1.float().reshape(b, c, h * w).transpose(1, 2)  # (B, HW, C)
    f2 = fmap2.float()
    inv_sqrt_c = 1.0 / math.sqrt(c)
    levels = []
    with tf32(bf16_valued):
        for _ in range(num_levels):
            hl, wl = f2.shape[-2:]
            corr = torch.bmm(f1, f2.reshape(b, c, hl * wl)) * inv_sqrt_c
            levels.append(corr.reshape(b * h * w, hl, wl).to(dtype))
            f2 = avg_pool2(f2)
    return levels


def lookup_corr_plain(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """levels: list of (Q, hl, wl); coords (Q, 2) float32 in level-0 pixels
    -> (Q, L*(2r+1)^2) float32. Values are blended in float32 whatever the
    levels' dtype (the kernel's arithmetic)."""
    num = 2 * radius + 1
    q = coords.shape[0]
    delta = torch.linspace(-radius, radius, num, dtype=torch.float32,
                           device=coords.device)
    offsets = torch.stack([delta.repeat_interleave(num), delta.repeat(num)], -1)
    outs = []
    for i, level in enumerate(levels):
        hl, wl = level.shape[-2:]
        pts = coords.float().view(q, 1, 2) / (2.0 ** i) + offsets[None]
        sampled = bilinear_sample(level.reshape(q, hl, wl, 1).float(), pts)
        outs.append(sampled.reshape(q, num * num))
    return torch.cat(outs, dim=-1)
