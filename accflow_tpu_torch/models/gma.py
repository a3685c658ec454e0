"""GMA (global motion aggregation) optical-flow estimator (inference),
counterpart of accflow_tpu/models/gma.py (reference networks/gma/).

GMA is full-width RAFT plus one attention over the context features:
- Attention: q, k from one bias-free 1x1 conv on the context `inp`,
  similarity (q . k) / sqrt(dim_head) over the flattened H*W axis,
  softmax -> (N, heads, HW, HW). Built once per pair (once per source frame
  in the pair-batched entry points) and reused every iteration. Branches:
  content-only (the default, every released checkpoint), position-only and
  position + content (RelPosEmb's decomposed relative-position score).
- Aggregate: v = bias-free 1x1 conv on the motion features, out = attn @ v,
  added back with a learned scalar gamma (zero at init, so a fresh model's
  global branch adds nothing).
- GMAUpdateBlock: RAFT's update block whose GRU input is [inp, motion,
  aggregated motion] (128 * 3 channels).

The GRU loop, the lookups (kernel #1 for "fused" and "auto", kernel #3 under
experimental:fused_bd[2]) and the upsampling are raft.py's (raft_iterate),
given the aggregation as its hook; the encodes are raft.py's as well.

Numerics (JAX's, accflow_tpu/models/gma.py:228-330): the similarity is
float32; with bfloat16-valued q and k TF32 is exact and allowed (as
ops/corr.py::build_corr_pyramid), with float32 compute TF32 is off. The
softmax reduces in float32 and the stored matrix takes the compute dtype;
aggregate casts it to v's dtype before the product, whose cuBLAS bfloat16
GEMM reduces in float32. The relative-position score is float32, TF32 off.
These GEMMs are outside any TPU kernel in JAX, so cuBLAS runs them here.

attn_chunk > 0 keeps q and k instead of the (HW, HW) matrix and recomputes
softmax(q_c k^T) v per chunk of query rows at every aggregate (a Python loop
over chunks of plain matmuls): each row's softmax sees every key, so it
equals the dense path row for row in O(chunk * HW) memory. -1 (auto) picks
dense while the attention and the stored pyramid fit ops/corr.py's budget,
chunks of 1024 (rounded down to a divisor of HW) beyond.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

import accflow_tpu_torch.ops.corr as corr_ops
from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models.encoders import BasicEncoder
from accflow_tpu_torch.models.raft import (
    BasicUpdateBlock,
    RAFTConfig,
    _as_images,
    _encode_pairs,
    gather_pairs,
    raft_encode_frame,
    raft_iterate,
)
from accflow_tpu_torch.nn.layers import Conv2d, Embedding, init_weights, tf32
from accflow_tpu_torch.ops.corr import (
    _divisor_chunk,
    _float32_reduction,
    build_corr_pyramid,
    normalize_corr_lookup,
    resolve_auto_lookup,
    stored_volume_bytes,
)
from accflow_tpu_torch.ops.corr_cuda import LEVELS, RADIUS


@dataclasses.dataclass(frozen=True)
class GMAConfig:
    """The JAX package's GMAConfig at full width (hidden and context 128,
    radius 4, 4 levels). corr_lookup as RAFTConfig's; attn_chunk 0 stores
    the dense attention, > 0 chunks it, -1 resolves per shape (module
    docstring; the positional branches have no chunked form, so a positive
    chunk raises there and auto stays dense). JAX's TPU-only knobs
    (scan_unroll, scan_remat, stem_s2d) and its corr_volume_dtype are not
    carried over, as in RAFTConfig: the stored levels take the compute
    dtype."""

    iters: int = 12
    compute_dtype: str = "bfloat16"
    corr_lookup: str = "fused"
    num_heads: int = 1
    dim_head: int = 128
    position_only: bool = False
    position_and_content: bool = False
    max_pos_size: int = 160
    attn_chunk: int = 0

    corr_levels = LEVELS  # class constants: the lookup kernels are built for 4
    corr_radius = RADIUS  # levels at radius 4
    hidden_dim = 128
    context_dim = 128
    small = False  # raft_iterate's switch: GMA runs full RAFT's loop

    split_levels = RAFTConfig.split_levels
    dtype = RAFTConfig.dtype
    corr_planes = RAFTConfig.corr_planes

    def __post_init__(self):
        normalize_corr_lookup(self.corr_lookup)
        if self.attn_chunk > 0 and self.positional:
            raise ValueError(
                "attn_chunk > 0 (chunked attention) supports the content-only branch, "
                "the one every released checkpoint uses")

    @property
    def positional(self) -> bool:
        return self.position_only or self.position_and_content


class RelPosEmb(nn.Module):
    """Two (2 * max_pos_size - 1, dim_head) tables under the reference
    names rel_height / rel_width (networks/gma/modules.py:6-18; its
    rel_ind buffer is recomputed, not stored)."""

    def __init__(self, max_pos_size: int, dim_head: int):
        super().__init__()
        n = 2 * max_pos_size - 1
        self.rel_height = Embedding(n, dim_head)
        self.rel_width = Embedding(n, dim_head)
        self.max_pos_size = max_pos_size


class Attention(nn.Module):
    def __init__(self, cfg: GMAConfig):
        super().__init__()
        self.to_qk = Conv2d(cfg.context_dim, 2 * cfg.num_heads * cfg.dim_head, 1, bias=False)
        self.pos_emb = RelPosEmb(cfg.max_pos_size, cfg.dim_head)


class Aggregate(nn.Module):
    def __init__(self, cfg: GMAConfig, dim: int = 128):
        super().__init__()
        inner = cfg.num_heads * cfg.dim_head
        self.to_v = Conv2d(dim, inner, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = Conv2d(inner, dim, 1, bias=False) if dim != inner else None
        self.num_heads = cfg.num_heads

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator  # gamma starts at zero, as the reference's
        self.gamma.zero_()


class GMAUpdateBlock(BasicUpdateBlock):
    def __init__(self, cfg: GMAConfig):
        super().__init__(cfg, gru_input=128 + 2 * cfg.hidden_dim)
        self.aggregator = Aggregate(cfg, dim=128)


class GMA(nn.Module):
    def __init__(self, cfg: GMAConfig = GMAConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        self.update_block = GMAUpdateBlock(cfg)
        self.att = Attention(cfg)


def init_gma(cfg: GMAConfig = GMAConfig(), seed: int = 0, device=None) -> GMA:
    """GMA with weights drawn from `seed` (gamma zero), in eval mode on
    `device` (default cuda; raises without a GPU unless device="cpu")."""
    dev = resolve_device(device)
    return init_weights(GMA(cfg), seed).to(dev).eval()


class AttnOperands(NamedTuple):
    """Chunked attention (attn_chunk > 0): q and k as float32
    (N, heads, HW, dh), unscaled, and the rows per chunk (a divisor of HW)."""

    q: torch.Tensor
    k: torch.Tensor
    chunk: int


def resolve_auto_attn_chunk(attn_chunk: int, batch: int, heads: int, h8: int, w8: int,
                            reserved_bytes: int = 0, compute_dtype=torch.bfloat16,
                            positional: bool = False) -> int:
    """attn_chunk=-1 (auto) at this shape: 0 (dense) while the float32
    similarity and the stored matrix (4 + the compute dtype's bytes per
    element) plus `reserved_bytes` (the stored pyramid, which shares the
    budget and comes first) fit ops/corr.py's AUTO_VOLUME_BYTES, else 1024.
    Non-negative values pass through; the positional branches stay dense
    (accflow_tpu/models/gma.py:184-217). A symbolic batch raises ValueError."""
    if attn_chunk >= 0:
        return attn_chunk
    if positional:
        return 0
    if not isinstance(batch, int):
        raise ValueError(
            "attn_chunk=-1 (auto) needs a concrete batch to size the attention matrix, "
            f"got symbolic {batch!r}: pick 0 (dense) or > 0 (chunked) for an export "
            "with a symbolic batch")
    hw = h8 * w8
    attn_bytes = batch * heads * hw * hw * (4 + compute_dtype.itemsize)
    return 0 if attn_bytes + reserved_bytes <= corr_ops.AUTO_VOLUME_BYTES else 1024


def _attn_chunk(cfg: GMAConfig, batch: int, h8: int, w8: int) -> int:
    """cfg.attn_chunk for `batch` pairs at this shape, auto resolved beside
    the stored pyramid."""
    return resolve_auto_attn_chunk(
        cfg.attn_chunk, batch, cfg.num_heads, h8, w8,
        reserved_bytes=stored_volume_bytes(batch, h8, w8, cfg.corr_levels, cfg.dtype),
        compute_dtype=cfg.dtype, positional=cfg.positional)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, heads*dh, H, W) -> (N, heads, H*W, dh), channels split heads-major
    (the reference's (h d) layout)."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, heads, c // heads).transpose(1, 2)


def _similarity(q: torch.Tensor, k: torch.Tensor, tf32_exact: bool) -> torch.Tensor:
    """(q . k) / sqrt(dh) for float32 q (N, heads, Q, dh), k (N, heads, K, dh)
    -> (N, heads, Q, K) float32, the scale applied in the GEMM's epilogue
    (JAX scales q first: one float32 rounding apart). tf32_exact: q and k
    hold bfloat16 values, for which TF32 is exact, so it is allowed."""
    n, heads, nq, dh = q.shape
    q3, k3 = q.reshape(n * heads, nq, dh), k.reshape(n * heads, -1, dh)
    with tf32(tf32_exact):
        sim = torch.baddbmm(q3.new_zeros(()), q3, k3.transpose(1, 2), beta=0.0,
                            alpha=dh ** -0.5)
    return sim.view(n, heads, nq, -1)


def rel_pos_score(pos_emb: RelPosEmb, q: torch.Tensor) -> torch.Tensor:
    """Decomposed relative-position similarity (modules.py:20-31): q
    (N, heads, H, W, dh) scaled float32 queries -> (N, heads, H*W, H*W),
    score[x, y, u, v] = q[x, y] . rel_height[u - x + m - 1]
    + q[x, y] . rel_width[v - y + m - 1], float32 with TF32 off."""
    n, heads, h, w, _ = q.shape
    m = pos_emb.max_pos_size

    def rel(size):
        ar = torch.arange(size, device=q.device)
        return ar[None, :] - ar[:, None] + m - 1

    with tf32(False):
        hs = torch.einsum("nhxyd,xud->nhxyu", q, pos_emb.rel_height.weight[rel(h)])
        ws = torch.einsum("nhxyd,yvd->nhxyv", q, pos_emb.rel_width.weight[rel(w)])
    return (hs[..., :, None] + ws[..., None, :]).reshape(n, heads, h * w, h * w)


def attention(model: GMA, inp: torch.Tensor, chunk: int = 0):
    """The attention of context features inp (N, C, H, W), compute dtype:
    the dense softmaxed (N, heads, HW, HW) matrix in the compute dtype, or
    AttnOperands for chunk > 0."""
    cfg = model.cfg
    n, _, h, w = inp.shape
    heads, dh = cfg.num_heads, cfg.dim_head
    qk = model.att.to_qk(inp)
    exact = qk.dtype == torch.bfloat16
    q, k = (_heads(x, heads).float() for x in qk.split(heads * dh, dim=1))
    if chunk > 0:
        return AttnOperands(q, k, _divisor_chunk(h * w, chunk))
    if cfg.positional:
        sim = rel_pos_score(model.att.pos_emb, q.view(n, heads, h, w, dh) * dh ** -0.5)
        if cfg.position_and_content:
            sim = sim + _similarity(q, k, exact)
    else:
        sim = _similarity(q, k, exact)
    attn = torch.softmax(sim, dim=-1)
    del sim
    return attn.to(cfg.dtype)


def _aggregate_chunked(attn: AttnOperands, v: torch.Tensor) -> torch.Tensor:
    """softmax(q_c . k / sqrt(dh)) v for each chunk q_c of attn.chunk query
    rows, each row's softmax over every key: the dense path's rows in
    O(chunk * HW) memory. v (N, heads, HW, dh) -> (N, heads, HW, dh)."""
    exact = v.dtype == torch.bfloat16
    outs = []
    for q in attn.q.split(attn.chunk, dim=2):
        rows = torch.softmax(_similarity(q, attn.k, exact), dim=-1).to(v.dtype)
        outs.append(torch.matmul(rows, v))
    return torch.cat(outs, dim=2)


def aggregate(agg: Aggregate, attn, motion: torch.Tensor) -> torch.Tensor:
    """motion (N, 128, H, W) + gamma * (attention applied to v = to_v(motion)),
    in motion's dtype. attn: attention()'s dense matrix or AttnOperands."""
    n, _, h, w = motion.shape
    v = _heads(agg.to_v(motion), agg.num_heads)
    with _float32_reduction():
        if isinstance(attn, AttnOperands):
            out = _aggregate_chunked(attn, v)
        else:
            out = torch.matmul(attn.to(v.dtype), v)
    out = out.transpose(1, 2).reshape(n, h, w, -1).permute(0, 3, 1, 2)
    if agg.project is not None:
        out = agg.project(out)
    return motion + agg.gamma.to(motion.dtype) * out


def _gather_attn(attn, sel, n: int):
    """attention() of the unique source frames -> the pairs' (P-major)."""
    if isinstance(attn, AttnOperands):
        return AttnOperands(gather_pairs(attn.q, sel, n), gather_pairs(attn.k, sel, n),
                            attn.chunk)
    return gather_pairs(attn, sel, n)


def gma_iterate(model: GMA, levels, net, inp, attn, iters: int, final_only: bool,
                flow_init: Optional[torch.Tensor] = None) -> dict:
    """raft_iterate with the aggregation of `attn` in every iteration."""
    agg = model.update_block.aggregator
    return raft_iterate(model, levels, net, inp, iters, final_only, flow_init,
                        aggregate=lambda motion: aggregate(agg, attn, motion))


def _pairs(model: GMA, frames, src_idx, dst_idx, iters, final_only, flow_init=None):
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    _, n, h, w, _ = frames.shape
    chunk = _attn_chunk(cfg, len(src_idx) * n, h // 8, w // 8)
    with tf32(False):
        levels, net_u, inp_u, sel = _encode_pairs(model, frames, src_idx, dst_idx)
        attn = _gather_attn(attention(model, inp_u, chunk), sel, n)
        return gma_iterate(model, levels, gather_pairs(net_u, sel, n),
                           gather_pairs(inp_u, sel, n), attn, iters, final_only, flow_init)


@torch.no_grad()
def gma_forward(model: GMA, image1, image2, iters: Optional[int] = None, flow_init=None,
                final_only: bool = False) -> dict:
    """Flow image1 -> image2, the contract of raft_forward: images
    (N, H, W, 3); flow_init an optional (N, H/8, W/8, 2) warm start. Returns
    flow_up (N, H, W, 2) float32, flow_low and, unless final_only, the
    per-iteration `predictions`."""
    dev = next(model.parameters()).device
    frames = torch.stack([_as_images(image1, dev), _as_images(image2, dev)])
    return _pairs(model, frames, (0,), (1,), iters, final_only, flow_init)


@torch.no_grad()
def gma_pairs_forward(model: GMA, frames, src_idx, dst_idx, iters: Optional[int] = None,
                      final_only: bool = True) -> torch.Tensor:
    """Flows of many (src, dst) pairs with deduplicated encodes, the
    contract of raft_pairs_forward; each source frame also gets one
    attention. Returns flow_up (P*N, H, W, 2), P-major."""
    dev = next(model.parameters()).device
    return _pairs(model, _as_images(frames, dev), src_idx, dst_idx, iters,
                  final_only)["flow_up"]


# Cacheable per-frame features for streaming: GMA's encodes are RAFT's
# (the fnet map and the cnet state); the attention is built per query.
gma_encode_frame = raft_encode_frame


@torch.no_grad()
def gma_flow_pairs_from_features(model: GMA, src: dict, dst_fmaps,
                                 iters: Optional[int] = None, flow_init=None,
                                 final_only: bool = True) -> torch.Tensor:
    """Pair flows src -> each of the P dst maps from precomputed features,
    the contract of raft_flow_pairs_from_features. The attention depends on
    the source's context only, so it is built once and shared by the P
    pairs. Returns flow_up (P*N, H, W, 2), P-major."""
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    p = len(dst_fmaps)
    n, _, h8, w8 = src["fmap"].shape
    resolve_auto_lookup(cfg.corr_lookup, p * n, h8, w8, cfg.corr_levels, cfg.dtype)
    chunk = _attn_chunk(cfg, p * n, h8, w8)
    with tf32(False):
        levels = build_corr_pyramid(torch.cat([src["fmap"]] * p), torch.cat(list(dst_fmaps)),
                                    cfg.corr_levels, dtype=cfg.dtype)
        attn = _gather_attn(attention(model, src["inp"], chunk), [0] * p, n)
        net = torch.cat([src["net"]] * p)
        inp = torch.cat([src["inp"]] * p)
        return gma_iterate(model, levels, net, inp, attn, iters, final_only,
                           flow_init)["flow_up"]
