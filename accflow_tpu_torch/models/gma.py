"""GMA (global motion aggregation) optical-flow estimator, counterpart of
accflow_tpu/models/gma.py (reference networks/gma/).

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

The GRU loop, the lookups (kernel #1 for "fused", "ondemand" and "auto" at
corr_radius 4 over corr_levels 4, kernel #2 at any other pair, and every
experimental spelling as raft.py's docstring lists them: kernel #2 for
experimental:pallas, kernel #3 for a "bd" level) and the upsampling are
raft.py's (raft_iterate),
given the aggregation as its hook; the encodes are raft.py's as well, and
so is the training forward's contract (gma_train_forward: raft.py's
raft_train_forward, with the attention and the aggregate recorded by
autograd as plain torch ops, which JAX computes outside any kernel too).

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
dense while the attention and the stored pyramid (none under the
volume-free ondemand lookup) fit ops/corr.py's budget, chunks of 1024
(rounded down to a divisor of HW) beyond.

The entry points take a `spatial` handle (parallel/mesh.py), as RAFT's
do, the training forward too: frames, features and flows are this rank's
rows. Each rank keeps
its own query rows and gathers the keys once per source frame (to_qk's
output, before the float32 cast) and the values at every aggregate, so it
holds (N, heads, HW_local, HW) rows of the attention, each softmaxed over
every key: exact row for row, with no reduction across ranks. The
relative-position score takes the queries' global rows, and attn_chunk
("auto" included) is resolved at the global shape, its chunks of local
query rows.
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
    check_corr_fields,
    check_trainable_lookup,
    gather_pairs,
    raft_encode_frame,
    raft_iterate,
)
from accflow_tpu_torch.nn.layers import Conv2d, Embedding, init_weights, spatial_sharding, tf32
from accflow_tpu_torch.ops.corr import (
    OnDemandCorr,
    _divisor_chunk,
    _float32_reduction,
    build_corr_operands,
    normalize_corr_lookup,
    resolve_auto_lookup,
    stored_volume_bytes,
)
from accflow_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class GMAConfig:
    """The JAX package's GMAConfig at full width (hidden and context 128).
    corr_lookup, corr_levels, corr_radius (GMA's window radius, `radius`)
    and corr_volume_dtype as RAFTConfig's (None: the stored levels take the
    compute dtype when inferring, float32 when training); attn_chunk 0
    stores the dense attention, > 0 chunks it, -1 resolves per shape
    (module docstring; the positional branches have no chunked form, so a
    positive chunk raises there and auto stays dense). JAX's TPU-only knobs
    (scan_unroll, scan_remat, stem_s2d) are not carried over, as in
    RAFTConfig."""

    iters: int = 12
    compute_dtype: str = "bfloat16"
    corr_lookup: str = "fused"
    num_heads: int = 1
    dim_head: int = 128
    position_only: bool = False
    position_and_content: bool = False
    max_pos_size: int = 160
    attn_chunk: int = 0
    corr_levels: int = 4
    corr_radius: int = 4
    corr_volume_dtype: Optional[str] = None

    hidden_dim = 128
    context_dim = 128
    small = False  # raft_iterate's switch: GMA runs full RAFT's loop

    lookup_impl = RAFTConfig.lookup_impl
    split_levels = RAFTConfig.split_levels
    dtype = RAFTConfig.dtype
    radius = RAFTConfig.radius
    level_dtype = RAFTConfig.level_dtype
    corr_planes = RAFTConfig.corr_planes

    def __post_init__(self):
        normalize_corr_lookup(self.corr_lookup)
        check_corr_fields(self)
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


def _attn_chunk(cfg: GMAConfig, batch: int, h8: int, w8: int, levels) -> int:
    """cfg.attn_chunk for `batch` pairs at this shape, auto resolved beside
    the stored pyramid (sized in its levels' dtype), or beside nothing when
    `levels` are the volume-free lookup's operands
    (accflow_tpu/models/gma.py:394-412)."""
    reserved = 0 if isinstance(levels, OnDemandCorr) else stored_volume_bytes(
        batch, h8, w8, cfg.corr_levels, levels[0].dtype)
    return resolve_auto_attn_chunk(
        cfg.attn_chunk, batch, cfg.num_heads, h8, w8, reserved_bytes=reserved,
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


def rel_pos_score(pos_emb: RelPosEmb, q: torch.Tensor, row0: int = 0,
                  height: Optional[int] = None) -> torch.Tensor:
    """Decomposed relative-position similarity (modules.py:20-31): q
    (N, heads, h, W, dh) scaled float32 queries of rows row0 .. row0 + h - 1
    of a map `height` rows high (default h: the whole map) ->
    (N, heads, h*W, height*W), score[x, y, u, v] = q[x, y] .
    rel_height[u - (row0 + x) + m - 1] + q[x, y] . rel_width[v - y + m - 1],
    float32 with TF32 off."""
    n, heads, h, w, _ = q.shape
    m = pos_emb.max_pos_size
    height = h if height is None else height

    def rel(rows, size):
        return torch.arange(size, device=q.device)[None, :] - rows[:, None] + m - 1

    with tf32(False):
        hs = torch.einsum("nhxyd,xud->nhxyu", q, pos_emb.rel_height.weight[
            rel(torch.arange(row0, row0 + h, device=q.device), height)])
        ws = torch.einsum("nhxyd,yvd->nhxyv", q, pos_emb.rel_width.weight[
            rel(torch.arange(w, device=q.device), w)])
    return (hs[..., :, None] + ws[..., None, :]).reshape(n, heads, h * w, height * w)


def attention(model: GMA, inp: torch.Tensor, chunk: int = 0, spatial=None):
    """The attention of context features inp (N, C, H, W), compute dtype:
    the dense softmaxed (N, heads, HW, HW) matrix in the compute dtype, or
    AttnOperands for chunk > 0. spatial: inp is this rank's rows; the keys
    are gathered (the whole height), and the matrix holds this rank's query
    rows against every key."""
    cfg = model.cfg
    n, _, h, w = inp.shape
    heads, dh = cfg.num_heads, cfg.dim_head
    qk_q, qk_k = model.att.to_qk(inp).split(heads * dh, dim=1)
    exact = qk_q.dtype == torch.bfloat16
    q = _heads(qk_q, heads).float()
    k = _heads(mesh.gather_rows(qk_k, spatial, dim=2), heads).float()
    if chunk > 0:
        return AttnOperands(q, k, _divisor_chunk(h * w, chunk))
    if cfg.positional:
        row0, height = (0, h) if spatial is None else (spatial.row0(h), spatial.height(h))
        sim = rel_pos_score(model.att.pos_emb, q.view(n, heads, h, w, dh) * dh ** -0.5,
                            row0, height)
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
    O(chunk * HW) memory. v (N, heads, HW, dh) -> (N, heads, HW_q, dh), HW_q
    attn.q's rows."""
    exact = v.dtype == torch.bfloat16
    outs = []
    for q in attn.q.split(attn.chunk, dim=2):
        rows = torch.softmax(_similarity(q, attn.k, exact), dim=-1).to(v.dtype)
        outs.append(torch.matmul(rows, v))
    return torch.cat(outs, dim=2)


def aggregate(agg: Aggregate, attn, motion: torch.Tensor, spatial=None) -> torch.Tensor:
    """motion (N, 128, H, W) + gamma * (attention applied to v = to_v(motion)),
    in motion's dtype. attn: attention()'s dense matrix or AttnOperands.
    spatial: motion and the result are this rank's rows, v is gathered."""
    n, _, h, w = motion.shape
    v = _heads(mesh.gather_rows(agg.to_v(motion), spatial, dim=2), agg.num_heads)
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
                flow_init: Optional[torch.Tensor] = None, remat: str = "none",
                spatial=None) -> dict:
    """raft_iterate with the aggregation of `attn` in every iteration."""
    agg = model.update_block.aggregator
    return raft_iterate(model, levels, net, inp, iters, final_only, flow_init,
                        aggregate=lambda motion: aggregate(agg, attn, motion, spatial),
                        remat=remat, spatial=spatial)


def _pairs(model: GMA, frames, src_idx, dst_idx, iters, final_only, flow_init=None,
           train: bool = False, remat: str = "none", spatial=None):
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    _, n, h, w, _ = frames.shape
    mesh.check_rows(h, spatial)
    h8 = h // 8 if spatial is None else spatial.height(h // 8)
    with tf32(False), spatial_sharding(model, spatial):
        levels, net_u, inp_u, sel = _encode_pairs(model, frames, src_idx, dst_idx, train,
                                                  spatial)
        chunk = _attn_chunk(cfg, len(src_idx) * n, h8, w // 8, levels)
        attn = _gather_attn(attention(model, inp_u, chunk, spatial), sel, n)
        return gma_iterate(model, levels, gather_pairs(net_u, sel, n),
                           gather_pairs(inp_u, sel, n), attn, iters, final_only, flow_init,
                           remat, spatial)


def gma_train_forward(model: GMA, image1, image2, iters: Optional[int] = None, flow_init=None,
                      final_only: bool = False, remat: str = "none", spatial=None) -> dict:
    """gma_forward for training, the contract of raft_train_forward; under
    a handle the gathered keys' and values' gradients return to the ranks
    that own their rows."""
    check_trainable_lookup(model.cfg)
    dev = next(model.parameters()).device
    frames = torch.stack([_as_images(image1, dev), _as_images(image2, dev)])
    return _pairs(model, frames, (0,), (1,), iters, final_only, flow_init, train=True,
                  remat=remat, spatial=spatial)


@torch.no_grad()
def gma_forward(model: GMA, image1, image2, iters: Optional[int] = None, flow_init=None,
                final_only: bool = False, spatial=None) -> dict:
    """Flow image1 -> image2, the contract of raft_forward: images
    (N, H, W, 3); flow_init an optional (N, H/8, W/8, 2) warm start. Returns
    flow_up (N, H, W, 2) float32, flow_low and, unless final_only, the
    per-iteration `predictions`. spatial: images, flow_init and the flows
    are this rank's rows."""
    dev = next(model.parameters()).device
    frames = torch.stack([_as_images(image1, dev), _as_images(image2, dev)])
    return _pairs(model, frames, (0,), (1,), iters, final_only, flow_init, spatial=spatial)


@torch.no_grad()
def gma_pairs_forward(model: GMA, frames, src_idx, dst_idx, iters: Optional[int] = None,
                      final_only: bool = True, spatial=None) -> torch.Tensor:
    """Flows of many (src, dst) pairs with deduplicated encodes, the
    contract of raft_pairs_forward; each source frame also gets one
    attention. Returns flow_up (P*N, H, W, 2), P-major. spatial: frames and
    flows are this rank's rows."""
    dev = next(model.parameters()).device
    return _pairs(model, _as_images(frames, dev), src_idx, dst_idx, iters,
                  final_only, spatial=spatial)["flow_up"]


# Cacheable per-frame features for streaming: GMA's encodes are RAFT's
# (the fnet map and the cnet state); the attention is built per query.
gma_encode_frame = raft_encode_frame


@torch.no_grad()
def gma_flow_pairs_from_features(model: GMA, src: dict, dst_fmaps,
                                 iters: Optional[int] = None, flow_init=None,
                                 final_only: bool = True, spatial=None) -> torch.Tensor:
    """Pair flows src -> each of the P dst maps from precomputed features,
    the contract of raft_flow_pairs_from_features. The attention depends on
    the source's context only, so it is built once and shared by the P
    pairs. Returns flow_up (P*N, H, W, 2), P-major. spatial: the features,
    flow_init and the flows are this rank's rows; the dst maps are gathered
    in one collective, and the lookup and attn_chunk resolved at the global
    shape."""
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    p = len(dst_fmaps)
    n, _, h8, w8 = src["fmap"].shape
    mesh.check_rows(8 * h8, spatial)
    h8_all = h8 if spatial is None else spatial.height(h8)
    lookup = resolve_auto_lookup(normalize_corr_lookup(cfg.corr_lookup), p * n, h8_all, w8,
                                 cfg.corr_levels, cfg.level_dtype())
    with tf32(False), spatial_sharding(model, spatial):
        levels = build_corr_operands(torch.cat([src["fmap"]] * p),
                                     mesh.gather_rows(torch.cat(list(dst_fmaps)), spatial, dim=2),
                                     cfg.corr_levels, lookup, dtype=cfg.level_dtype())
        chunk = _attn_chunk(cfg, p * n, h8_all, w8, levels)
        attn = _gather_attn(attention(model, src["inp"], chunk, spatial), [0] * p, n)
        net = torch.cat([src["net"]] * p)
        inp = torch.cat([src["inp"]] * p)
        return gma_iterate(model, levels, net, inp, attn, iters, final_only,
                           flow_init, spatial=spatial)["flow_up"]
