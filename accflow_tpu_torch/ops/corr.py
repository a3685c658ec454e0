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
`lookup_corr_plain_backward` is its gradient with respect to the levels:
the CPU path of the lookup ops' backward and the oracle of the backward
kernel (ops/corr_backward_cuda.py), held against torch.autograd.grad of
lookup_corr_plain and against JAX's gradient by the tests.

Split lookup (`lookup_corr_split_v2`, the `experimental:fused_bd[2]`
spellings of `corr_lookup`): the same windows per level as (Q, 9, 9) arrays,
each from two separable tent contractions, tmp = wy . corr3 over y and then
wx . tmp over x. Level impl "bd" runs the y contraction through the
y_contract kernel (ops/corr_bd_cuda.py), "mm" through torch.bmm. The motion
encoder consumes them unflattened (BasicMotionEncoder.forward_split).
"""

from __future__ import annotations

import contextlib
import math

import torch

from accflow_tpu_torch.nn.layers import tf32
from accflow_tpu_torch.ops.corr_bd_cuda import y_contract
from accflow_tpu_torch.ops.sampling import bilinear_sample, bilinear_sample_backward

# corr_lookup spellings (accflow_tpu/ops/corr.py:116-134): the live ones the
# all-levels lookup serves, and the experimental split ones with their
# number of "bd" levels (the rest "mm").
FUSED_LOOKUPS = ("fused", "mm", "pallas_fused")
SPLIT_LOOKUPS = {"fused_bd": 1, "fused_bd2": 2}


def normalize_corr_lookup(spelling: str) -> str:
    """The port's lookup for a `corr_lookup` spelling: "fused" for fused,
    mm and pallas_fused (one function in JAX, one kernel here: kernel #1),
    "auto" for auto (resolve_auto_lookup picks per shape),
    "fused_bd" / "fused_bd2" for experimental:fused_bd[2]. As in JAX, an
    experimental variant needs its "experimental:" prefix (ValueError
    without). ondemand[:chunk] and the other variants raise
    NotImplementedError: they are not ported."""
    if spelling.startswith("experimental:"):
        impl = spelling.split(":", 1)[1]
        if impl in SPLIT_LOOKUPS:
            return impl
        raise NotImplementedError(
            f"corr_lookup={spelling!r} is not ported to accflow_tpu_torch; "
            f"ported: {' | '.join(FUSED_LOOKUPS)} | auto | "
            + " | ".join(f"experimental:{k}" for k in SPLIT_LOOKUPS))
    if spelling in FUSED_LOOKUPS:
        return "fused"
    if spelling == "auto":
        return spelling
    if spelling.split(":", 1)[0] == "ondemand":
        raise NotImplementedError(
            f"corr_lookup={spelling!r} (the volume-free hi-res mode) is not ported "
            "to accflow_tpu_torch yet (ROADMAP.md, queue 1 #11)")
    raise ValueError(
        f"corr_lookup={spelling!r} is an adjudicated experimental variant, not a "
        f"supported impl: spell it 'experimental:{spelling}' to opt in. Supported: "
        "fused | mm | ondemand[:chunk] | auto | pallas_fused")


# Stored-volume budget of corr_lookup="auto" (and of GMA's attn_chunk=-1),
# JAX's value (accflow_tpu/ops/corr.py:136-143), sized there for a 16 GB
# chip. Re-deriving it for the H100's 80 GB waits for the volume-free
# lookup it would switch to (ROADMAP.md, queue 1 #11).
AUTO_VOLUME_BYTES = 4 << 30


def stored_volume_bytes(batch: int, h8: int, w8: int, num_levels: int = 4,
                        dtype=torch.float32) -> int:
    """Bytes of the stored pyramid (build_corr_pyramid) for `batch` pairs
    of h8 x w8 feature maps: B*H8*W8 queries times the sum of hl*wl over
    the levels, in `dtype`. These are logical bytes, as the card's memory
    holds the levels. JAX counts the TPU's layout, whose minor dim is
    padded to 128 lanes, up to ~2.8x more (accflow_tpu/ops/corr.py:145-162),
    so "auto" switches at larger shapes here: at the CVO-6 clip shape
    (22 pairs of 64 x 64, float32) JAX counts 5.5 GB and picks ondemand,
    the port 2.0 GB and picks fused."""
    k, hl, wl = 0, h8, w8
    for _ in range(num_levels):
        k += hl * wl
        hl, wl = hl // 2, wl // 2
    return batch * h8 * w8 * k * dtype.itemsize


def resolve_auto_lookup(spelling: str, batch: int, h8: int, w8: int,
                        num_levels: int = 4, dtype=torch.float32) -> str:
    """corr_lookup "auto" for `batch` pairs of h8 x w8 feature maps:
    "fused" while stored_volume_bytes fits AUTO_VOLUME_BYTES; beyond it
    JAX picks the volume-free ondemand lookup, which is not ported, so this
    raises NotImplementedError. Other spellings pass through. A symbolic
    batch (an export with a symbolic batch) cannot be sized: ValueError,
    as in JAX."""
    if spelling != "auto":
        return spelling
    if not isinstance(batch, int):
        raise ValueError(
            "corr_lookup='auto' needs a concrete batch to size the stored volume, "
            f"got symbolic {batch!r}: pick an explicit impl ('fused', ...) for an "
            "export with a symbolic batch")
    nbytes = stored_volume_bytes(batch, h8, w8, num_levels, dtype)
    if nbytes <= AUTO_VOLUME_BYTES:
        return "fused"
    raise NotImplementedError(
        f"corr_lookup='auto': the stored volume of {batch} x {h8} x {w8} needs {nbytes} "
        f"bytes, over the {AUTO_VOLUME_BYTES}-byte budget, where JAX switches to the "
        "volume-free ondemand lookup, which is not ported to accflow_tpu_torch yet "
        "(ROADMAP.md, queue 1 #11)")


def _divisor_chunk(total: int, chunk: int) -> int:
    """The largest divisor of `total` that is <= the requested chunk
    (accflow_tpu/ops/corr.py:210-215)."""
    chunk = max(1, min(int(chunk), total))
    while total % chunk:
        chunk -= 1
    return chunk


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


def lookup_corr_plain(levels, coords: torch.Tensor, radius: int = 4,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """levels: list of (Q, hl, wl); coords (Q, 2) float32 in level-0 pixels
    -> (Q, L*(2r+1)^2) in `out_dtype`. Values are blended in float32
    whatever the levels' dtype (the kernel's arithmetic), then cast once."""
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
    return torch.cat(outs, dim=-1).to(out_dtype)


def lookup_corr_plain_backward(grad_out: torch.Tensor, coords: torch.Tensor, level_shapes,
                               radius: int = 4, dtype: torch.dtype = torch.float32) -> list:
    """The gradient of lookup_corr_plain with respect to its levels:
    grad_out (Q, L*(2r+1)^2), the gradient of the lookup's output; coords
    (Q, 2) float32; level_shapes the L (hl, wl); dtype the levels'. Each
    level's window is bilinear_sample at lookup_corr_plain's points, so its
    gradient is bilinear_sample_backward at the same points: what
    torch.autograd.grad of lookup_corr_plain gives (in another summation
    order), written out because a custom op's kernel, where the CPU op runs
    this, runs with autograd off. Returns L (Q, hl, wl) gradients in
    `dtype` (bfloat16 levels: the float32 sums rounded once). Coords get no
    gradient, as JAX stops it."""
    num = 2 * radius + 1
    q = coords.shape[0]
    delta = torch.linspace(-radius, radius, num, dtype=torch.float32, device=coords.device)
    offsets = torch.stack([delta.repeat_interleave(num), delta.repeat(num)], -1)
    g = grad_out.float().view(q, len(level_shapes), num * num, 1)
    grads = []
    for i, (hl, wl) in enumerate(level_shapes):
        pts = coords.float().view(q, 1, 2) / (2.0 ** i) + offsets[None]
        grads.append(bilinear_sample_backward(g[:, i], pts, hl, wl, dtype).view(q, hl, wl))
    return grads


def window_weights(centers: torch.Tensor, size: int) -> torch.Tensor:
    """Separable bilinear weights: centers (Q, K) -> (Q, K, size) float32,
    weight[q, k, y] = max(0, 1 - |y - centers[q, k]|): grid_sample's
    align_corners=True with zeros outside along one axis."""
    ys = torch.arange(size, dtype=torch.float32, device=centers.device)
    return torch.clamp(1.0 - torch.abs(ys - centers[..., None]), min=0.0)


@contextlib.contextmanager
def _float32_reduction():
    """cuBLAS's bfloat16 GEMMs reduce in float32 inside the block: PyTorch's
    `allow_bf16_reduced_precision_reduction` (process-wide, on by default)
    lets them reduce split-K partial sums in bfloat16. Restored afterwards."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b of one level type with float32 accumulation: float32
    operands in full float32 (TF32 off), float32 out; bfloat16 operands as
    they are (the bf16 GEMM, reduced-precision reductions off), out rounded
    once to bfloat16, the type every caller takes next. No float32 copies
    of the levels."""
    with tf32(False), _float32_reduction():
        return torch.bmm(a, b)


def _tents(corr3: torch.Tensor, cf: torch.Tensor, scale: float, radius: int):
    """The x and y tent weights (Q, 2r+1, wl) and (Q, 2r+1, hl), float32."""
    _, hl, wl = corr3.shape
    num = 2 * radius + 1
    delta = torch.linspace(-radius, radius, num, dtype=torch.float32, device=cf.device)
    return (window_weights(cf[:, 0:1] / scale + delta, wl),
            window_weights(cf[:, 1:2] / scale + delta, hl))


def _level_window_mm(corr3, cf, scale: float, radius: int) -> torch.Tensor:
    """One level's window from the two tent contractions: (Q, a, b) in the
    level's dtype (accflow_tpu/ops/corr.py::_level_window_mm). Weights and
    tmp take the level's dtype, as in JAX."""
    wx, wy = _tents(corr3, cf, scale, radius)
    tmp = _contract(wy.to(corr3.dtype), corr3)  # (Q, b, wl)
    return _contract(wx.to(corr3.dtype), tmp.transpose(1, 2))


def _level_window_bd(corr3, cf, scale: float, radius: int, f32: bool) -> torch.Tensor:
    """One level's window with the y contraction through the y_contract
    kernel (accflow_tpu/ops/corr.py::_level_window_bd): wy and corr3 go in
    float32 under float32 compute, else bfloat16, and the kernel writes tmp
    in the level's dtype; the x contraction as in _level_window_mm."""
    kd = torch.float32 if f32 else torch.bfloat16
    wx, wy = _tents(corr3, cf, scale, radius)
    tmp = y_contract(corr3.to(kd), wy.to(kd), out_dtype=corr3.dtype)  # (Q, b, wl)
    return _contract(wx.to(corr3.dtype), tmp.transpose(1, 2))


def lookup_corr_split_v2(levels, coords: torch.Tensor, radius: int = 4,
                         level_impl=("bd", "mm", "mm", "mm"),
                         compute_dtype=torch.float32) -> list:
    """levels: list of (Q, hl, wl) maps; coords (B, H, W, 2) in level-0
    pixels, Q = B*H*W. level_impl[i] ("bd" or "mm"; the last repeats) picks
    level i's formulation. Returns one (B, H, W, 2r+1, 2r+1) window per
    level in the levels' dtype (bfloat16 levels: float32 sums rounded once),
    indexed [a (x offset), b (y offset)]
    (accflow_tpu/ops/corr.py::lookup_corr_split_v2)."""
    b, h, w, _ = coords.shape
    num = 2 * radius + 1
    cf = coords.reshape(b * h * w, 2).float()
    f32 = compute_dtype == torch.float32
    outs = []
    for i, level in enumerate(levels):
        impl = level_impl[i] if i < len(level_impl) else level_impl[-1]
        if impl == "mm":
            out = _level_window_mm(level, cf, 2.0 ** i, radius)
        elif impl == "bd":
            out = _level_window_bd(level, cf, 2.0 ** i, radius, f32)
        else:
            raise ValueError(f"level impl {impl!r} is not ported (ported: bd, mm)")
        outs.append(out.reshape(b, h, w, num, num))
    return outs
