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
channel l*(2r+1)^2 + a*(2r+1) + b samples (x/2^l + a - r, y/2^l + b - r),
so the outer index a carries the x offset (networks/raft/corr.py:32-38).
Any radius and level count (the estimators' corr_radius and corr_levels);
a level pooled to nothing (a 1-pixel map pools to 0 x 0) reads nothing and
gives zeros.

`lookup_corr_plain` is the explicit 4-corner gather: the CPU path and the
oracle of the CUDA kernels, which the GPU path runs (`lookup_corr_kernel`:
kernel #1, ops/corr_cuda.py, at radius 4 over 4 levels; kernel #2,
ops/corr_level_cuda.py, at every other radius and level count).
`lookup_corr_plain_backward` is its gradient with respect to the levels:
the CPU path of the lookup ops' backward and the oracle of the backward
kernel (ops/corr_backward_cuda.py), held against torch.autograd.grad of
lookup_corr_plain and against JAX's gradient by the tests.

The experimental spellings of `corr_lookup` (behind "experimental:";
normalize_corr_lookup, dispatched by models/raft.py as JAX's RAFT step
dispatches them) compute the same windows laid out for the TPU's units,
each in JAX's order of casts: bfloat16 levels give bfloat16 tent weights
and float32 sums, float32 levels (JAX's precision "highest") float32
throughout, TF32 off. None needs a host synchronisation.
- Flat, (B, H, W, L*(2r+1)^2) into convc1 (`lookup_flat`): `lookup_corr_pallas`
  (accflow_tpu/ops/corr_pallas.py:466; kernel #2, ops/corr_level_cuda.py),
  `lookup_corr_rows` (accflow_tpu/ops/corr.py:953: a 2r+2-row gather, a
  float32 lerp, the x tent product), `lookup_corr_patch` (:707: one
  (2r+2)^2 patch blended from its four corners), `lookup_corr_gather`
  (:464: lookup_corr_plain itself).
- Split, per-level (B, H, W, 2r+1, 2r+1) windows [a (x), b (y)] into the
  motion encoder unflattened (`split_windows`): `lookup_corr_split_v2` (:916-950)
  with a level impl each: "mm" two tent products (`_level_window_mm`,
  :832), "bd" the y product through the y_contract kernel #3
  (`_level_window_bd`, :886; ops/corr_bd_cuda.py, built for 2r+1 taps),
  "vpu_y" the y product
  summed in float32 (`_level_window_vpu_y`, :854), "rows" / "rows_gx" a row
  gather finished by the x product or a column gather
  (`_level_window_rows`, :772); `lookup_corr_split` (:575-622) with the x
  contraction as a product ("mxu") or 2r+1 multiply-and-sum passes ("vpu",
  `_level_window_vpu_x`); `lookup_corr_split_packed` (:495-574), levels
  start.. packed into one map, their windows one (B, H, W, L', 2r+1, 2r+1) entry.
  `window_weights` is JAX's `_window_weights` (:695).

Volume-free lookup (`corr_lookup="ondemand[:chunk]"`, the hi-res mode,
accflow_tpu/ops/corr.py:107-461): the operands store features, not the
volume (`OnDemandCorr`: f1 (B, H*W, C) float32 and f2 pooled per level), and
every lookup rebuilds each query chunk's rows (B*chunk, hl, wl) per level
with `_corr_rows`, the code build_corr_pyramid runs, then reads the windows
through the lookup kernels (`lookup_corr_kernel`): #1 at radius 4 over 4
levels (full RAFT and GMA at their defaults), #2 at every other radius and
level count (RAFT-small's radius 3 among them). Peak memory is one chunk's
rows. JAX's choice between a
"bqyx" and a "bqk" einsum for the rows (and the environment variables that
set it and OD_AUTO_BYTES) is a TPU layout choice: here the rows are
row-major (Q, hl, wl) either way, and nothing is read from the environment.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from accflow_tpu_torch.nn.layers import tf32
from accflow_tpu_torch.nn.remat import remat_wrap
from accflow_tpu_torch.ops.corr_bd_cuda import y_contract
from accflow_tpu_torch.ops.sampling import bilinear_sample, bilinear_sample_backward
from accflow_tpu_torch.utils.profiling import span

# corr_lookup spellings (accflow_tpu/ops/corr.py:116-134): the live ones the
# all-levels lookup serves; the experimental ones behind the "experimental:"
# prefix, dispatched as JAX's RAFT step dispatches them
# (accflow_tpu/models/raft.py:575-657): the flat lookups, whose
# (B, H, W, L*(2r+1)^2) windows feed convc1 as one input, and the split
# lookups, whose per-level (B, H, W, 2r+1, 2r+1) windows the motion encoder contracts
# level by level (forward_split) or stacked (forward_stacked, the "_cat"
# spellings). A split spelling built on lookup_corr_split_v2 names its level
# impls (SPLIT_V2_LEVELS; "fused_mix:<l0,l1,l2,l3>" spells them out).
FUSED_LOOKUPS = ("fused", "mm", "pallas_fused")
FLAT_LOOKUPS = ("pallas", "rows", "patch", "gather")
SPLIT_LOOKUPS = ("fusedv", "fused_cat", "packed", "packed2", "fused_vy", "fused_vy_cat",
                 "fused_bd", "fused_bd2")
STACKED_LOOKUPS = ("fused_cat", "fused_vy_cat")
SPLIT_V2_LEVELS = {"fused_vy": ("vpu_y",), "fused_vy_cat": ("vpu_y",),
                   "fused_bd": ("bd", "mm"), "fused_bd2": ("bd", "bd", "mm")}
LEVEL_IMPLS = ("mm", "bd", "rows", "rows_gx", "vpu_y")
MIX = "fused_mix:"


def is_ondemand(spelling: str) -> bool:
    """True for the volume-free lookup's spelling "ondemand[:chunk]"."""
    return spelling.split(":", 1)[0] == "ondemand"


def normalize_corr_lookup(spelling: str) -> str:
    """The port's lookup for a `corr_lookup` spelling: "fused" for fused,
    mm and pallas_fused (one function in JAX, one kernel here: kernel #1),
    "auto" for auto (resolve_auto_lookup picks per shape), the spelling
    itself for ondemand[:chunk] (whose suffix is checked here: ValueError
    for a suffix that is not a positive int, as JAX raises at build time),
    and for an experimental spelling the name after its "experimental:"
    prefix: a FLAT_LOOKUPS or SPLIT_LOOKUPS name, or "fused_mix:<impls>"
    with level impls from LEVEL_IMPLS. As in JAX, an experimental variant
    needs its prefix (ValueError without), and a live spelling may carry
    it. An unknown experimental spelling, or a mix with an unknown level
    impl, raises ValueError here, where JAX raises at run time
    (accflow_tpu/ops/corr.py:692,948)."""
    if spelling.startswith("experimental:"):
        impl = spelling.split(":", 1)[1]
        if impl in FLAT_LOOKUPS or impl in SPLIT_LOOKUPS:
            return impl
        if impl.startswith(MIX):
            mix_levels(impl)
            return impl
        if impl in FUSED_LOOKUPS or impl == "auto" or is_ondemand(impl):
            return normalize_corr_lookup(impl)
        raise ValueError(
            f"unknown corr_lookup={spelling!r}; the experimental spellings: "
            + " | ".join(f"experimental:{k}" for k in FLAT_LOOKUPS + SPLIT_LOOKUPS)
            + f" | experimental:{MIX}<l0,l1,l2,l3> (level impls {' | '.join(LEVEL_IMPLS)})")
    if spelling in FUSED_LOOKUPS:
        return "fused"
    if spelling == "auto":
        return spelling
    if is_ondemand(spelling):
        ondemand_chunk(spelling)
        return spelling
    raise ValueError(
        f"corr_lookup={spelling!r} is an adjudicated experimental variant, not a "
        f"supported impl: spell it 'experimental:{spelling}' to opt in. Supported: "
        "fused | mm | ondemand[:chunk] | auto | pallas_fused")


def mix_levels(impl: str) -> tuple:
    """The level impls of "fused_mix:<l0,l1,...>" as a tuple (a list
    shorter than the levels repeats its last entry in
    lookup_corr_split_v2); ValueError for one not in LEVEL_IMPLS."""
    levels = tuple(impl[len(MIX):].split(","))
    bad = [k for k in levels if k not in LEVEL_IMPLS]
    if bad:
        raise ValueError(f"corr_lookup experimental:{impl}: unknown level impl {bad[0]!r} "
                         f"(level impls: {' | '.join(LEVEL_IMPLS)})")
    return levels


def split_level_impls(impl: str, num_levels: int = 4):
    """The per-level impls of lookup_corr_split_v2 for a normalized
    spelling built on it (SPLIT_V2_LEVELS, or a fused_mix), the last entry
    repeated to `num_levels`; None for every other spelling."""
    levels = mix_levels(impl) if impl.startswith(MIX) else SPLIT_V2_LEVELS.get(impl)
    if levels is None:
        return None
    return tuple(levels[min(i, len(levels) - 1)] for i in range(num_levels))


# Stored-volume budget of corr_lookup="auto" (and of GMA's attn_chunk=-1):
# beyond it "auto" picks the volume-free lookup. JAX's 4 GiB was sized for
# a 16 GB chip (accflow_tpu/ops/corr.py:136-143). This one is the largest
# stored pyramid whose whole peak, the float32 transient of level 0
# included, stays within 3/4 of an H100's memory, from the peaks that
# chip_smoke.py (phase 16c) measured for FlowPipeline.long_range (acc+raft,
# bf16, 7 frames: 11 pairs) with "fused" on an NVIDIA H100 80GB HBM3 at
# 700.00 W (79.18 GiB): 13.476 GiB at 1280x720 (a stored pyramid V of
# 5.635 GiB) and 66.033 GiB at 1920x1080 (V 28.479 GiB). The line through
# them, peak = 2.3007 V + 0.511 GiB, reaches 3/4 of the card at V = 25.589
# GiB; rounded down to 25 GiB. So "auto" stores the pyramid at 720p and
# takes the volume-free lookup from 1080p up (PERF.md).
AUTO_VOLUME_BYTES = 25 << 30

# Live-rows budget of the AUTO ondemand chunk: float32 bytes of one
# chunk's rebuilt rows over all levels, across the batch (JAX's value,
# accflow_tpu/ops/corr.py:218-223). Up to it the lookup runs one chunk.
OD_AUTO_BYTES = 4 << 30


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
    "fused" while stored_volume_bytes fits AUTO_VOLUME_BYTES, the
    volume-free "ondemand" beyond it (the budget alone decides; nothing
    falls back on an out-of-memory error). Other spellings pass through. A
    symbolic batch (an export with a symbolic batch) cannot be sized:
    ValueError, as in JAX."""
    if spelling != "auto":
        return spelling
    if not isinstance(batch, int):
        raise ValueError(
            "corr_lookup='auto' needs a concrete batch to size the stored volume, "
            f"got symbolic {batch!r}: pick an explicit impl ('fused', 'ondemand', ...) "
            "for an export with a symbolic batch")
    nbytes = stored_volume_bytes(batch, h8, w8, num_levels, dtype)
    return "fused" if nbytes <= AUTO_VOLUME_BYTES else "ondemand"


def ondemand_chunk(spelling: str, default: int = 0) -> int:
    """The ":chunk" suffix of an ondemand spelling; `default` (0, AUTO:
    sized per shape by _auto_chunk) for a bare "ondemand". ValueError for a
    suffix that is not an int or not positive (a chunk of 1 would serialise
    the lookup per query)."""
    if ":" not in spelling:
        return default
    suffix = spelling.split(":", 1)[1]
    try:
        chunk = int(suffix)
    except ValueError:
        raise ValueError(f"bad ondemand chunk suffix {suffix!r} in corr_lookup={spelling!r}; "
                         "expected 'ondemand' or 'ondemand:<int>'") from None
    if chunk <= 0:
        raise ValueError(f"ondemand chunk must be positive, got {chunk} in "
                         f"corr_lookup={spelling!r}")
    return chunk


def _divisor_chunk(total: int, chunk: int) -> int:
    """The largest divisor of `total` that is <= the requested chunk
    (accflow_tpu/ops/corr.py:210-215)."""
    chunk = max(1, min(int(chunk), total))
    while total % chunk:
        chunk -= 1
    return chunk


def _auto_chunk(b: int, q: int, key_elems: int) -> int:
    """The largest divisor of q whose float32 rows (b * chunk * key_elems)
    fit OD_AUTO_BYTES, and at least 256 queries."""
    fit = OD_AUTO_BYTES // max(4 * b * key_elems, 1)
    return _divisor_chunk(q, max(int(fit), 256))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x2/stride-2 average pool over H, W of (B, C, H, W); an odd
    last row/column is dropped, and a size-1 axis pools to size 0."""
    b, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :, : 2 * h2, : 2 * w2].reshape(b, c, h2, 2, w2, 2)
    return x.mean(dim=(3, 5))


def _corr_rows(f1: torch.Tensor, f2: torch.Tensor, inv_sqrt_c: float, dtype) -> torch.Tensor:
    """One level's rows for queries f1 (B, Q, C) float32 against keys f2
    (B, C, hl, wl) float32: <f1, f2> / sqrt(C) as a float32 torch.bmm under
    the caller's TF32 setting, scaled after the product, then cast to
    `dtype` -> (B*Q, hl, wl). The stored pyramid and the volume-free
    lookup's chunks both build their rows here. Where no gradient is
    recorded the scale is applied in place (the same rounding), so that
    the float32 transient is one product, not two."""
    b, c, hl, wl = f2.shape
    corr = torch.bmm(f1, f2.reshape(b, c, hl * wl))
    corr = corr * inv_sqrt_c if corr.requires_grad else corr.mul_(inv_sqrt_c)
    return corr.reshape(b * f1.shape[1], hl, wl).to(dtype)


def _pooled_keys(fmap2: torch.Tensor, num_levels: int) -> list:
    """fmap2 (B, C, H, W) in float32, then average-pooled 2x per level."""
    f2 = fmap2.float()
    levels = [f2]
    for _ in range(num_levels - 1):
        levels.append(avg_pool2(levels[-1]))
    return levels


def _bf16_valued(fmap1, fmap2) -> bool:
    """With bfloat16 features the float32 products are exact under TF32 (10
    mantissa bits hold the 7 of bf16), so TF32 is allowed: the counterpart
    of JAX's corr_precision="default". With float32 features it is off."""
    return fmap1.dtype == torch.bfloat16 and fmap2.dtype == torch.bfloat16


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4, dtype=torch.float32):
    """fmap1, fmap2 (B, C, H, W) -> list of num_levels (B*H*W, hl, wl) maps.
    fmap1 may hold fewer rows than fmap2 (on the spatial axis, a rank's
    query rows against the whole target map: Q = B*H1*W); so may
    build_corr_on_demand's.

    The products run in float32 (_corr_rows), TF32 allowed for bfloat16
    features only (_bf16_valued). `dtype` is the stored levels' type."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.float().reshape(b, c, h * w).transpose(1, 2)  # (B, HW, C)
    with tf32(_bf16_valued(fmap1, fmap2)):
        return [_corr_rows(f1, f2, 1.0 / math.sqrt(c), dtype)
                for f2 in _pooled_keys(fmap2, num_levels)]


class OnDemandCorr(NamedTuple):
    """The volume-free lookup's operands: features, not the volume
    (accflow_tpu/ops/corr.py::OnDemandCorr, and OnDemandChunks once chunk
    is set). f1 (B, H1*W1, C) float32 queries, unscaled; f2_levels per
    level the pooled keys (B, C, hl, wl) float32 (JAX keeps (B, hl*wl, C):
    the port's row product takes them channels first, as
    build_corr_pyramid does); h1, w1 the query map; dtype the rows' type
    before the lookup (the stored levels' type); tf32 whether the row
    products may run in TF32 (bfloat16 features); chunk the queries per
    chunk, fixed once outside the GRU loop by prepare_ondemand_chunks, or 0
    while unset. A chunk's queries are a view of f1,
    f1[:, i*chunk:(i+1)*chunk], which torch.bmm takes as it is: where JAX
    hoists a chunk-major copy of f1 out of its loop, nothing is copied."""

    f1: torch.Tensor
    f2_levels: tuple
    h1: int
    w1: int
    dtype: torch.dtype = torch.float32
    tf32: bool = False
    chunk: int = 0


def build_corr_on_demand(fmap1, fmap2, num_levels: int = 4, dtype=torch.float32) -> OnDemandCorr:
    """fmap1, fmap2 (B, C, H, W) -> OnDemandCorr: f1 in float32 (as
    build_corr_pyramid lays it out) and the pooled keys, with no product
    yet (it moves into every lookup)."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.float().reshape(b, c, h * w).transpose(1, 2)
    return OnDemandCorr(f1, tuple(_pooled_keys(fmap2, num_levels)), h, w, dtype,
                        _bf16_valued(fmap1, fmap2))


def prepare_ondemand_chunks(od: OnDemandCorr, chunk: int) -> OnDemandCorr:
    """od with its chunk set: `chunk` queries (0: AUTO, _auto_chunk),
    rounded down to a divisor of H1*W1."""
    b, q, _ = od.f1.shape
    if chunk == 0:
        chunk = _auto_chunk(b, q, sum(f2.shape[-2] * f2.shape[-1] for f2 in od.f2_levels))
    return od._replace(chunk=_divisor_chunk(q, chunk))


def build_corr_operands(fmap1, fmap2, num_levels: int, spelling: str, dtype=torch.float32):
    """What a resolved `corr_lookup` spelling consumes: the volume-free
    lookup's operands with their chunk set (OnDemandCorr) for
    "ondemand[:chunk]", the stored pyramid (a list of levels) for every
    other. `dtype` is the levels' type, or the rows' before the
    lookup. The pyramid's build is the span "corr.build"
    (utils/profiling.py); the volume-free lookup's rows are that span in
    each chunk of each lookup (lookup_corr_on_demand)."""
    if is_ondemand(spelling):
        return prepare_ondemand_chunks(build_corr_on_demand(fmap1, fmap2, num_levels, dtype),
                                       ondemand_chunk(spelling))
    with span("corr.build"):
        return build_corr_pyramid(fmap1, fmap2, num_levels, dtype)


def lookup_corr_kernel(levels, coords: torch.Tensor, radius: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The window lookup on a stored pyramid through the hand kernels, keyed
    on (radius, levels): kernel #1 (ops/corr_cuda.py::lookup_corr_fused) at
    radius 4 over 4 levels, full RAFT's and GMA's default; kernel #2
    (ops/corr_level_cuda.py::lookup_corr_level) at every other radius and
    level count, each pair in a build of its own. levels: L (Q, hl, wl);
    coords (Q, 2) float32 -> (Q, L*(2r+1)^2) in `out_dtype`. On CPU tensors
    the kernels' plain versions; with a card, always a kernel (a build or
    launch failure raises)."""
    # The kernels' wrappers import this module (their plain versions).
    from accflow_tpu_torch.ops.corr_cuda import LEVELS, RADIUS, lookup_corr_fused
    from accflow_tpu_torch.ops.corr_level_cuda import lookup_corr_level

    if radius == RADIUS and len(levels) == LEVELS:
        return lookup_corr_fused(levels, coords, radius, out_dtype=out_dtype)
    return lookup_corr_level(levels, coords, radius, out_dtype=out_dtype)


def lookup_corr_on_demand(od, coords: torch.Tensor, radius: int = 4, chunk: int = 0,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The windows of lookup_corr_plain without a stored volume: coords
    (B, H1, W1, 2) float32 in level-0 pixels -> (B, H1, W1, L*(2r+1)^2) in
    `out_dtype`. For each chunk of queries (the same chunk of every image)
    the rows (B*chunk, hl, wl) per level are rebuilt (_corr_rows, what
    build_corr_pyramid stores, cast to od.dtype) and read by the lookup
    kernel (lookup_corr_kernel): #1 (ops/corr_cuda.py) at radius 4 over 4
    levels, #2 (ops/corr_level_cuda.py) at every other radius and level
    count; on CPU tensors their plain versions. Under autograd the
    gradient flows through the kernels' backward into the rows and through
    the products into f1 and the pooled keys; with more than one chunk
    each chunk's body is recomputed in the backward pass (nn.remat, as JAX
    checkpoints its lax.map body), so the backward stores no volume either.
    The loop over chunks has static shapes and no host sync (a CUDA graph
    captures it).

    od: OnDemandCorr; its own chunk holds once set (prepare_ondemand_chunks),
    else `chunk` queries per chunk (0: AUTO, one chunk while the float32
    rows fit OD_AUTO_BYTES; rounded down to a divisor of H1*W1)."""
    if not od.chunk:
        od = prepare_ondemand_chunks(od, chunk)
    b, h, w, _ = coords.shape
    chunk, c = od.chunk, od.f1.shape[-1]
    nch = h * w // chunk
    inv_sqrt_c = 1.0 / math.sqrt(c)

    def one_chunk(f1c, cc):
        with span("corr.build"), tf32(od.tf32):
            rows = [_corr_rows(f1c, f2, inv_sqrt_c, od.dtype) for f2 in od.f2_levels]
        return lookup_corr_kernel(rows, cc, radius, out_dtype=out_dtype)

    cf = coords.reshape(b, h * w, 2).float()
    if nch == 1:
        return one_chunk(od.f1, cf.reshape(b * h * w, 2)).view(b, h, w, -1)
    one_chunk = remat_wrap(one_chunk, "full")
    cs = cf.view(b, nch, chunk, 2).transpose(0, 1).contiguous()  # (nch, B, chunk, 2)
    outs = [one_chunk(od.f1[:, i * chunk:(i + 1) * chunk], cs[i].view(b * chunk, 2))
            for i in range(nch)]
    out = torch.stack(outs).view(nch, b, chunk, -1).transpose(0, 1)
    return out.reshape(b, h, w, -1)


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
    align_corners=True with zeros outside along one axis
    (accflow_tpu/ops/corr.py:695 `_window_weights`)."""
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


def _contract_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with a float32 result whatever the operands' type:
    JAX's einsum with preferred_element_type=float32 where its output is
    not rounded to the level's type. Both operands go in as float32 (TF32
    off); the products of bfloat16 values are exact there, so this is the
    bfloat16 product summed in float32, in another order than XLA's."""
    with tf32(False):
        return torch.bmm(a.float(), b.float())


def _rows_lerp(corr3: torch.Tensor, cy: torch.Tensor, radius: int) -> torch.Tensor:
    """The y half of a window from a row gather (accflow_tpu/ops/corr.py:
    983-993, 814-823): the 2r+2 rows floor(cy)-r .. floor(cy)+r+1 of each
    query's map (Q, hl, wl), zero outside it, in float32, lerped by cy's
    fraction -> (Q, 2r+1 (b), wl) float32. Every tap of a window shares that
    fraction, so this equals the y tent contraction."""
    q, hl, wl = corr3.shape
    num = 2 * radius + 1
    dy = torch.arange(-radius, radius + 2, dtype=torch.float32, device=cy.device)
    y0 = torch.floor(cy)
    fy = (cy - y0)[:, None, None]
    py = y0[:, None] + dy  # (Q, 2r+2)
    yvalid = (py >= 0) & (py <= hl - 1)
    iy = py.clamp(0, hl - 1).long()
    rows = torch.gather(corr3, 1, iy[:, :, None].expand(q, num + 1, wl))
    rows = (rows * yvalid[:, :, None].to(rows.dtype)).float()
    return (1.0 - fy) * rows[:, :num] + fy * rows[:, 1:]


def _level_window_rows(corr3, cf, scale: float, radius: int, x_mode: str = "mxu"):
    """One level's window from a row gather (accflow_tpu/ops/corr.py:
    772-831): _rows_lerp, then the x tent contraction in the level's dtype
    ("mxu", the weights and tmp rounded to it, as _level_window_mm) or a
    gather of 2r+2 columns of tmp lerped by x's fraction in float32
    ("gather", level impl rows_gx) -> (Q, a, b)."""
    q, hl, wl = corr3.shape
    num = 2 * radius + 1
    cx = cf[:, 0] / scale
    tmp = _rows_lerp(corr3, cf[:, 1] / scale, radius)  # (Q, b, wl) float32
    if x_mode == "mxu":
        delta = torch.linspace(-radius, radius, num, dtype=torch.float32, device=cf.device)
        wx = window_weights(cx[:, None] + delta, wl)
        return _contract(wx.to(corr3.dtype), tmp.to(corr3.dtype).transpose(1, 2))
    dx = torch.arange(-radius, radius + 2, dtype=torch.float32, device=cf.device)
    x0 = torch.floor(cx)
    fx = (cx - x0)[:, None, None]
    px = x0[:, None] + dx  # (Q, 2r+2)
    xvalid = (px >= 0) & (px <= wl - 1)
    ix = px.clamp(0, wl - 1).long()
    cols = torch.gather(tmp, 2, ix[:, None, :].expand(q, num, num + 1))
    cols = cols * xvalid[:, None, :].to(cols.dtype)
    return ((1.0 - fx) * cols[:, :, :num] + fx * cols[:, :, 1:]).transpose(1, 2)


def _level_window_vpu_y(corr3, cf, scale: float, radius: int) -> torch.Tensor:
    """One level's window with the y tent contraction summed in float32
    (accflow_tpu/ops/corr.py:854-883): tmp = sum_y wy . corr3, wy rounded to
    the level's dtype, then the x contraction as in _level_window_mm. JAX
    writes tmp as a broadcast product reduced over y, which XLA fuses into
    one pass; eager PyTorch would materialise the (Q, 9, hl, wl) float32
    product (13.3 GB at the CVO-6 clip's level 0). The same sums come from a
    float32 batched product with TF32 off (_contract_f32: bfloat16 products
    are exact in float32), at the cost of one float32 copy of a bfloat16
    level, (Q, hl, wl), per call."""
    wx, wy = _tents(corr3, cf, scale, radius)
    tmp = _contract_f32(wy.to(corr3.dtype), corr3)  # (Q, b, wl) float32
    return _contract(wx.to(corr3.dtype), tmp.to(corr3.dtype).transpose(1, 2))


def _level_window_vpu_x(corr3, cf, scale: float, radius: int) -> torch.Tensor:
    """One level's window with the x contraction as 2r+1 multiply-and-sum
    passes in float32 (lookup_corr_split's x_contraction="vpu",
    accflow_tpu/ops/corr.py:606-616): tmp = wy . corr3 summed in float32 and
    not rounded, wx rounded to the level's dtype, each pass a's row
    out[:, a] = sum_x tmp * wx[:, a] -> (Q, a, b) float32."""
    num = 2 * radius + 1
    wx, wy = _tents(corr3, cf, scale, radius)
    t = _contract_f32(wy.to(corr3.dtype), corr3)  # (Q, b, wl) float32
    wxf = wx.to(corr3.dtype).float()
    return torch.stack([(t * wxf[:, a:a + 1, :]).sum(dim=-1) for a in range(num)], dim=1)


def lookup_corr_split_v2(levels, coords: torch.Tensor, radius: int = 4,
                         level_impl=("bd", "mm", "mm", "mm"),
                         compute_dtype=torch.float32) -> list:
    """levels: list of (Q, hl, wl) maps; coords (B, H, W, 2) in level-0
    pixels, Q = B*H*W. level_impl[i] (one of LEVEL_IMPLS; the last repeats)
    picks level i's formulation: "mm" the two tent contractions, "bd" the y
    one through kernel #3, "vpu_y" the y one summed in float32, "rows" and
    "rows_gx" a row gather finished by the x tent contraction or by a
    column gather. Returns one (B, H, W, 2r+1, 2r+1) window per level,
    indexed [a (x offset), b (y offset)]: in the levels' dtype where the x
    contraction is a product (bfloat16 levels: float32 sums rounded once),
    float32 for rows_gx (accflow_tpu/ops/corr.py::lookup_corr_split_v2,
    :916-950). compute_dtype float32 is JAX's precision "highest" (kernel
    #3 takes float32 operands), else bfloat16 operands."""
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
        elif impl == "vpu_y":
            out = _level_window_vpu_y(level, cf, 2.0 ** i, radius)
        elif impl in ("rows", "rows_gx"):
            out = _level_window_rows(level, cf, 2.0 ** i, radius,
                                     "mxu" if impl == "rows" else "gather")
        else:
            raise ValueError(f"unknown level impl {impl!r} (level impls: "
                             f"{', '.join(LEVEL_IMPLS)})")
        outs.append(out.reshape(b, h, w, num, num))
    return outs


def lookup_corr_split(levels, coords: torch.Tensor, radius: int = 4,
                      x_contraction: str = "mxu") -> list:
    """The split windows from the two tent contractions on every level
    (accflow_tpu/ops/corr.py:575-622): one (B, H, W, 2r+1, 2r+1) window per
    level, [a, b]. x_contraction "mxu" is _level_window_mm (a window in the
    levels' dtype), "vpu" _level_window_vpu_x (float32). JAX's "fused"
    default runs "mxu"; the port's "fused" is kernel #1, and this serves
    experimental:fused_cat ("mxu") and experimental:fusedv ("vpu")."""
    if x_contraction not in ("mxu", "vpu"):
        raise ValueError(f"x_contraction must be 'mxu' or 'vpu', got {x_contraction!r}")
    b, h, w, _ = coords.shape
    num = 2 * radius + 1
    cf = coords.reshape(b * h * w, 2).float()
    window = _level_window_mm if x_contraction == "mxu" else _level_window_vpu_x
    return [window(level, cf, 2.0 ** i, radius).reshape(b, h, w, num, num)
            for i, level in enumerate(levels)]


def lookup_corr_split_packed(levels, coords: torch.Tensor, radius: int = 4,
                             start: int = 1) -> list:
    """lookup_corr_split ("mxu") with levels start.. packed into one map
    (accflow_tpu/ops/corr.py:495-574): those levels concatenated in y and
    zero-padded in x to the first packed level's width, (Q, sum hl, wp);
    each level's y tents masked to its own rows and offset by them, its x
    tents over wp columns (taps in the padding multiply zeros, the zeros
    outside a map). Both contractions run once over the packed levels, in
    the levels' dtype as in _level_window_mm. Returns the windows of levels
    < start, each (B, H, W, 2r+1, 2r+1), and then the packed levels' windows
    (B, H, W, L - start, 2r+1, 2r+1) in the levels' dtype. The packed copy
    is built per call, as JAX builds it in its step."""
    b, h, w, _ = coords.shape
    num = 2 * radius + 1
    q = b * h * w
    cf = coords.reshape(q, 2).float()
    outs = lookup_corr_split(levels[:start], coords, radius)
    small = levels[start:]
    nl, wp = len(small), small[0].shape[-1]
    offs, rows, off = [], [], 0
    for lvl in small:
        offs.append(off)
        rows.append(torch.nn.functional.pad(lvl, (0, wp - lvl.shape[-1])))
        off += lvl.shape[-2]
    packed = torch.cat(rows, dim=1)  # (Q, sum hl, wp)
    delta = torch.linspace(-radius, radius, num, dtype=torch.float32, device=cf.device)
    ys = torch.arange(off, dtype=torch.float32, device=cf.device)
    wys, wxs = [], []
    for li, lvl in enumerate(small):
        scale = 2.0 ** (li + start)
        wy = window_weights(cf[:, 1:2] / scale + delta + float(offs[li]), off)
        wys.append(wy * ((ys >= offs[li]) & (ys < offs[li] + lvl.shape[-2])))
        wxs.append(window_weights(cf[:, 0:1] / scale + delta, wp))
    wy_p = torch.stack(wys, dim=1).to(packed.dtype).view(q, nl * num, off)
    wx_p = torch.stack(wxs, dim=1).to(packed.dtype).view(q * nl, num, wp)
    tmp = _contract(wy_p, packed)  # (Q, L'*b, wp)
    out = _contract(wx_p, tmp.view(q * nl, num, wp).transpose(1, 2))  # (Q*L', a, b)
    return outs + [out.view(b, h, w, nl, num, num)]


def lookup_corr_rows(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The flat windows from a row gather (accflow_tpu/ops/corr.py:953-995):
    per level _rows_lerp, then the x tent contraction in float32 (TF32
    off), levels concatenated -> (B, H, W, L*(2r+1)^2) float32, channel
    a*(2r+1) + b as lookup_corr_plain's."""
    b, h, w, _ = coords.shape
    num = 2 * radius + 1
    cf = coords.reshape(b * h * w, 2).float()
    delta = torch.linspace(-radius, radius, num, dtype=torch.float32, device=cf.device)
    outs = []
    for i, level in enumerate(levels):
        tmp = _rows_lerp(level, cf[:, 1] / (2.0 ** i), radius)  # (Q, b, wl)
        wx = window_weights(cf[:, 0:1] / (2.0 ** i) + delta, level.shape[-1])  # (Q, a, wl)
        with tf32(False):
            outs.append(torch.bmm(wx, tmp.transpose(1, 2)).reshape(b, h, w, num * num))
    return torch.cat(outs, dim=-1)


def lookup_corr_patch(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The flat windows from one (2r+2)^2 patch per query and level
    (accflow_tpu/ops/corr.py:707-769): the patch around (floor x, floor y),
    zero outside the map, blended from its four (2r+1)^2 corner sub-grids
    with the shared fractions in float32, in JAX's order -> (B, H, W,
    L*(2r+1)^2) float32."""
    b, h, w, _ = coords.shape
    num = 2 * radius + 1
    side = num + 1
    q = b * h * w
    cf = coords.reshape(q, 2).float()
    d = torch.arange(-radius, radius + 2, dtype=torch.float32, device=cf.device)
    outs = []
    for i, level in enumerate(levels):
        hl, wl = level.shape[-2:]
        cx, cy = cf[:, 0] / (2.0 ** i), cf[:, 1] / (2.0 ** i)
        x0, y0 = torch.floor(cx), torch.floor(cy)
        fx, fy = (cx - x0)[:, None, None], (cy - y0)[:, None, None]
        py, px = y0[:, None] + d, x0[:, None] + d  # (Q, side)
        valid = ((py[:, :, None] >= 0) & (py[:, :, None] <= hl - 1)
                 & (px[:, None, :] >= 0) & (px[:, None, :] <= wl - 1))
        idx = (py.clamp(0, hl - 1).long()[:, :, None] * wl
               + px.clamp(0, wl - 1).long()[:, None, :]).view(q, side * side)
        patch = torch.gather(level.reshape(q, hl * wl), 1, idx).view(q, side, side)
        patch = (patch * valid.to(patch.dtype)).float()  # rows y, columns x
        blend = ((1 - fy) * (1 - fx) * patch[:, :num, :num]
                 + (1 - fy) * fx * patch[:, :num, 1:]
                 + fy * (1 - fx) * patch[:, 1:, :num]
                 + fy * fx * patch[:, 1:, 1:])  # (Q, b, a)
        outs.append(blend.transpose(1, 2).reshape(b, h, w, num * num))
    return torch.cat(outs, dim=-1)


def lookup_corr_gather(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The (2r+1)^2-tap bilinear gather (accflow_tpu/ops/corr.py:464-492) is
    lookup_corr_plain, the plain version of kernels #1 and #2: here on
    (B, H, W, 2) coords -> (B, H, W, L*(2r+1)^2) float32."""
    b, h, w, _ = coords.shape
    return lookup_corr_plain(levels, coords.reshape(b * h * w, 2), radius).view(b, h, w, -1)


def lookup_corr_pallas(levels, coords: torch.Tensor, radius: int = 4, stream_dtype=None,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """experimental:pallas (accflow_tpu/ops/corr_pallas.py:466): the levels
    cast to `stream_dtype` (None: as they are; JAX streams bfloat16 under
    precision "default" and the storage dtype under "highest") and read by
    kernel #2 (ops/corr_level_cuda.py, any radius and level count; its plain
    version on CPU tensors) -> (B, H, W, L*(2r+1)^2) in `out_dtype`."""
    from accflow_tpu_torch.ops.corr_level_cuda import lookup_corr_level

    if stream_dtype is not None:
        levels = [lvl.to(stream_dtype) for lvl in levels]
    b, h, w, _ = coords.shape
    cf = coords.reshape(b * h * w, 2).float().contiguous()
    return lookup_corr_level(levels, cf, radius, out_dtype=out_dtype).view(b, h, w, -1)


def lookup_flat(impl: str, levels, coords: torch.Tensor, radius: int,
                compute_dtype=torch.float32) -> torch.Tensor:
    """A flat experimental lookup (FLAT_LOOKUPS) on a stored pyramid, as
    JAX's `lookup` dispatches it (accflow_tpu/ops/corr.py:677-692): coords
    (B, H, W, 2) -> (B, H, W, L*(2r+1)^2) in compute_dtype. "pallas" streams
    bfloat16 levels unless the compute dtype is float32."""
    if impl == "pallas":
        stream = None if compute_dtype == torch.float32 else torch.bfloat16
        return lookup_corr_pallas(levels, coords, radius, stream, out_dtype=compute_dtype)
    fn = {"rows": lookup_corr_rows, "patch": lookup_corr_patch, "gather": lookup_corr_gather}
    if impl not in fn:
        raise ValueError(f"{impl!r} is not a flat lookup ({' | '.join(FLAT_LOOKUPS)})")
    return fn[impl](levels, coords, radius).to(compute_dtype)


def split_windows(impl: str, levels, coords: torch.Tensor, radius: int,
                  compute_dtype=torch.float32) -> list:
    """A split lookup's windows (SPLIT_LOOKUPS or a fused_mix) in
    compute_dtype, as JAX's RAFT step computes them
    (accflow_tpu/models/raft.py:600-633): lookup_corr_split_v2 with the
    spelling's level impls, lookup_corr_split_packed for packed[2],
    lookup_corr_split for fusedv ("vpu") and fused_cat ("mxu")."""
    level_impl = split_level_impls(impl, len(levels))
    if level_impl is not None:
        parts = lookup_corr_split_v2(levels, coords, radius, level_impl, compute_dtype)
    elif impl in ("packed", "packed2"):
        parts = lookup_corr_split_packed(levels, coords, radius, 1 if impl == "packed" else 2)
    elif impl in ("fusedv", "fused_cat"):
        parts = lookup_corr_split(levels, coords, radius, "vpu" if impl == "fusedv" else "mxu")
    else:
        raise ValueError(f"{impl!r} is not a split lookup")
    return [p.to(compute_dtype) for p in parts]
