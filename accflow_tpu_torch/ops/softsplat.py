"""Softmax splatting (forward warping), counterpart of
accflow_tpu/ops/softsplat.py: bilinear forward splatting by scatter-add with
summation / average / linear / softmax weighting (the softmax-splatting
paper's modes). Plain torch: this is XLA code in the JAX package, not a
Pallas kernel.

Determinism: colliding targets are summed with `index_put_(accumulate=True)`
under `torch.use_deterministic_algorithms(True)`, which on the GPU takes
PyTorch's sort-based accumulation instead of float atomics, so a splat is
bit-reproducible run to run, as JAX's scatter-add is. The GPU's summation
order still differs from the CPU's (float rounding, ~1 ulp per collision).
The switch is process state, which neither torch.export nor a CUDA graph
records, so the scatter is the torch op `accflow::splat_add` (`splat_add`):
an exported program calls the op, whose implementation turns the switch on
around the scatter wherever the program runs, and a CUDA graph captures the
sort-based kernels the op chose.
"""

from __future__ import annotations

import contextlib

import torch

from accflow_tpu_torch.parallel import mesh


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms on for the block, the previous setting
    restored afterwards (the switch is process-wide)."""
    prev, prev_warn = (torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


@torch.library.custom_op("accflow::splat_add", mutates_args=(),
                         schema="(Tensor values, Tensor flow) -> Tensor")
def splat_add(values, flow):
    """Bilinear scatter-add of `values` (B, H, W, C) along `flow`
    (B, H, W, 2) -> (B, H, W, C); corners outside the image are dropped."""
    b, h, w, c = values.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=values.device),
        torch.arange(w, dtype=torch.float32, device=values.device),
        indexing="ij",
    )
    tx = xs[None] + flow[..., 0]
    ty = ys[None] + flow[..., 1]
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = tx - x0, ty - y0
    vals = values.reshape(b * h * w, c)
    base = (torch.arange(b, device=values.device) * (h * w)).view(b, 1, 1)
    out = values.new_zeros((b * h * w, c))
    with _deterministic():
        for xi, yi, weight in (
            (x0, y0, (1 - fx) * (1 - fy)),
            (x0 + 1, y0, fx * (1 - fy)),
            (x0, y0 + 1, (1 - fx) * fy),
            (x0 + 1, y0 + 1, fx * fy),
        ):
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            wgt = (weight * valid).reshape(-1, 1).to(vals.dtype)
            out.index_put_((idx.reshape(-1),), vals * wgt, accumulate=True)
    return out.view(b, h, w, c)


@splat_add.register_fake
def _(values, flow):
    return torch.empty_like(values, memory_format=torch.contiguous_format)


def _splat_rows(values: torch.Tensor, flow: torch.Tensor, spatial) -> torch.Tensor:
    """splat_add over a height-sharded image: each rank splats its own
    rows' sources, at their global positions, into a full-height canvas
    (the other rows' sources are zeros, which add nothing), the group sums
    the canvases (mesh.sum_ranks) and each rank keeps its own rows."""
    b, h, w, c = values.shape
    height, r0 = spatial.height(h), spatial.row0(h)
    canvas = values.new_zeros((b, height, w, c))
    canvas[:, r0:r0 + h] = values
    moves = flow.new_zeros((b, height, w, 2))
    moves[:, r0:r0 + h] = flow
    return mesh.sum_ranks(splat_add(canvas, moves), spatial)[:, r0:r0 + h]


def softsplat(image: torch.Tensor, flow: torch.Tensor, metric=None,
              mode: str = "average", eps: float = 1e-7, spatial=None) -> torch.Tensor:
    """Forward-warp `image` (B, H, W, C) by `flow` (B, H, W, 2), float32.

    mode: "summation" | "average" | "linear" (weight = metric) | "softmax"
    (weight = exp(metric)); metric (B, H, W, 1) for the weighted modes.
    spatial (a parallel.mesh.Spatial handle): image, flow, metric and the
    result are this rank's rows; the numerator and the weight are the
    group's sums (_splat_rows, one collective), and only then does the
    average divide."""
    image, flow = image.float(), flow.float()
    if mode == "summation":
        return splat_add(image, flow) if spatial is None else _splat_rows(image, flow, spatial)
    if mode == "average":
        weight = image.new_ones(image.shape[:3] + (1,))
    elif mode in ("linear", "softmax"):
        if metric is None:
            raise ValueError(f"softsplat mode {mode!r} needs a metric")
        weight = metric.float() if mode == "linear" else torch.exp(metric.float())
    else:
        raise ValueError(f"unknown softsplat mode: {mode!r}")
    if spatial is not None:
        num, den = _splat_rows(torch.cat([image * weight, weight], -1), flow,
                               spatial).split([image.shape[-1], 1], -1)
        return num / (den + eps)
    num = splat_add(image * weight, flow)
    den = splat_add(weight, flow)
    return num / (den + eps)
