"""RAFT optical-flow estimator (inference), counterpart of
accflow_tpu/models/raft.py, in its two configurations:
- full width (RAFTConfig()): basic encoders (fnet 256 channels, instance
  norm; cnet 128 hidden + 128 context, frozen batch norm), radius 4, 4
  levels, SepConvGRU, convex upsampling;
- RAFT-small (RAFTConfig(small=True)): small encoders (fnet 128, instance
  norm; cnet 96 hidden + 64 context, no norm), radius 3, 4 levels, a 3x3
  ConvGRU, no mask head: flows are upsampled with upflow8.

One iteration: the correlation window lookup gives the motion encoder its
input -> motion encoder -> GRU -> FlowHead. RAFTConfig.corr_lookup picks the
lookup of full RAFT (ops/corr.py::normalize_corr_lookup):
- "fused" (also spelled "mm" or "pallas_fused", one function in JAX): the
  4-level radius-4 kernel (ops/corr_cuda.py), a (Q, 324) input to convc1;
- "auto": "fused" while the stored pyramid fits ops/corr.py's budget
  (resolve_auto_lookup, checked per shape in each entry point; beyond it
  NotImplementedError);
- "experimental:fused_bd" / "experimental:fused_bd2": the split lookup
  (ops/corr.py::lookup_corr_split_v2), level 0 (0 and 1) through the
  y_contract kernel (ops/corr_bd_cuda.py) and the rest through torch.bmm,
  consumed per level by BasicMotionEncoder.forward_split.
RAFT-small always takes the per-level kernel (ops/corr_level_cuda.py), as
JAX maps every fused spelling to one flat lookup there. On the CPU each
kernel is replaced by its plain version. Encoders and the update block run
in the compute dtype; the pyramid products, coordinates and upsampling in
float32, and the stored pyramid levels in the compute dtype.

Images are (N, H, W, 3) in [-1, 1]; flows (N, H, W, 2) in (x, y) order.
Feature maps inside are NCHW, kept channels_last in memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models.encoders import BasicEncoder, SmallEncoder
from accflow_tpu_torch.nn.layers import Conv2d, conv2d, init_weights, tf32
from accflow_tpu_torch.ops.corr import (
    SPLIT_LOOKUPS,
    build_corr_pyramid,
    lookup_corr_split_v2,
    normalize_corr_lookup,
    resolve_auto_lookup,
)
from accflow_tpu_torch.ops.corr_cuda import LEVELS, RADIUS, lookup_corr_fused
from accflow_tpu_torch.ops.corr_level_cuda import lookup_corr_level
from accflow_tpu_torch.ops.grids import coords_grid, upflow8
from accflow_tpu_torch.ops.upsample import convex_upsample


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """The JAX package's RAFTConfig: full width, or RAFT-small with
    small=True, from which the widths and the radius follow. corr_lookup
    selects full RAFT's lookup (module docstring; an unported spelling
    raises here). Its TPU-only knobs (scan_unroll, scan_remat, stem_s2d)
    are not carried over.

    JAX's corr_volume_dtype is a numerics choice, and the port makes it
    differently: JAX stores the pyramid levels in float32 by default
    (accflow_tpu/models/raft.py:64-67), the port in the compute dtype
    (build_corr_pyramid's dtype in _pairs and
    raft_flow_pairs_from_features). Under bfloat16 compute this barely
    moves the flow: on the CPU, full RAFT at batch 2, 12 iterations, the
    port's max |bf16 - JAX float32| went from 3.61e-2 (bfloat16 levels) to
    3.80e-2 (float32 levels) at 64^2, and from 3.26e-2 to 3.16e-2 at 96^2,
    against JAX's own bfloat16 error of 5.66e-2 and 6.61e-2 (ROADMAP.md,
    queue 3). tests/test_torch_bf16.py holds the port's bfloat16 flow to
    JAX's own bfloat16 error."""

    iters: int = 12
    compute_dtype: str = "bfloat16"
    small: bool = False
    corr_lookup: str = "fused"

    corr_levels = LEVELS  # a class constant: the lookup kernels are built for 4

    def __post_init__(self):
        normalize_corr_lookup(self.corr_lookup)

    @property
    def split_levels(self):
        """The split lookup's per-level impls ("bd" on the first 1 or 2
        levels, "mm" on the rest), or None for the all-levels kernel."""
        impl = normalize_corr_lookup(self.corr_lookup)
        if self.small or impl not in SPLIT_LOOKUPS:
            return None
        nbd = SPLIT_LOOKUPS[impl]
        return ("bd",) * nbd + ("mm",) * (self.corr_levels - nbd)

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128

    @property
    def corr_radius(self) -> int:
        return 3 if self.small else RADIUS

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W, C) -> (N, C, H, W) in `dtype`, channels_last in memory."""
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3)
        self.convf1 = Conv2d(2, 128, 7)
        self.convf2 = Conv2d(128, 64, 3)
        self.conv = Conv2d(64 + 192, 128 - 2, 3)

    def forward(self, flow, corr):
        """flow (N, 2, H, W), corr (N, corr_planes, H, W) -> (N, 128, H, W)."""
        return self._tail(flow, self.convc1(corr))

    def forward_split(self, flow, corr_levels):
        """forward on the split lookup's per-level windows: corr_levels is a
        list of L (N, H, W, 9, 9) windows [a, b] in the compute dtype. convc1
        is 1x1, so convc1(cat(levels)) = bias + sum_l window_l . W_l, W_l
        being convc1's input channels l*81 .. l*81+80 (a*9 + b order): the
        same weight, split by level. The bias comes first, then each level's
        product, each rounded to the compute dtype
        (accflow_tpu/models/raft.py::basic_motion_encoder_split)."""
        cd = corr_levels[0].dtype
        n, h, w = corr_levels[0].shape[:3]
        wc = self.convc1.weight.view(self.convc1.weight.shape[0], len(corr_levels), -1)
        cor = self.convc1.bias.to(cd)
        for l, part in enumerate(corr_levels):
            cor = cor + part.reshape(n, h, w, -1) @ wc[:, l].t().to(cd)
        cor = cor.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self._tail(flow, cor)

    def _tail(self, flow, cor):
        """The layers after convc1, on its pre-activation output `cor`."""
        cor = torch.relu(self.convc2(torch.relu(cor)))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """Separable (1x5 then 5x1) ConvGRU (update.py:33-60)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cat = hidden_dim + input_dim
        for ax, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{ax}", Conv2d(cat, hidden_dim, k))
        self.hidden_dim = hidden_dim

    def fused_step(self, inp: torch.Tensor):
        """A GRU step specialised to the loop-invariant context `inp`.

        The GRU input is cat(inp, varying) and `inp` never changes across
        iterations. A conv is linear in its input channels, so each gate's
        conv over cat(h, inp, varying) splits into three channel slices;
        conv_inp(inp) + bias is computed once here (make_fused_sep_gru,
        accflow_tpu/models/raft.py:159-204), and the per-iteration convs
        are fused across gates (z|r|q over `varying`, z|r over h).
        Returns step(h, varying) -> h."""
        hd, idim, cd = self.hidden_dim, inp.shape[1], inp.dtype
        pre = {}
        for ax in ("1", "2"):
            gates = [getattr(self, f"conv{g}{ax}") for g in "zrq"]
            w_inp = torch.cat([g.weight[:, hd:hd + idim] for g in gates])
            bias = torch.cat([g.bias for g in gates])
            pre[ax] = (
                conv2d(inp, w_inp, bias),
                torch.cat([g.weight[:, hd + idim:] for g in gates]).to(cd),
                torch.cat([g.weight[:, :hd] for g in gates[:2]]).to(cd),
                gates[2].weight[:, :hd].to(cd),
            )

        def step(h, varying):
            for ax in ("1", "2"):
                a_inp, w_var, w_h_zr, w_h_q = pre[ax]
                s = conv2d(varying, w_var) + a_inp
                hzr = conv2d(h, w_h_zr)
                z = torch.sigmoid(hzr[:, :hd] + s[:, :hd])
                r = torch.sigmoid(hzr[:, hd:] + s[:, hd:2 * hd])
                q = torch.tanh(conv2d(r * h, w_h_q) + s[:, 2 * hd:])
                h = (1.0 - z) * h + z * q
            return h

        return step


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3)
        self.conv2 = Conv2d(hidden_dim, 2, 3)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """gru_input: the GRU's input channels beside the hidden state (context
    + motion, 128 + hidden; GMA's update block adds its aggregated motion)."""

    def __init__(self, cfg: RAFTConfig, gru_input: Optional[int] = None):
        super().__init__()
        hd = cfg.hidden_dim
        self.encoder = BasicMotionEncoder(cfg.corr_planes)
        self.gru = SepConvGRU(hd, 128 + hd if gru_input is None else gru_input)
        self.flow_head = FlowHead(hd, 256)
        self.mask = nn.Sequential(Conv2d(128, 256, 3), nn.ReLU(), Conv2d(256, 64 * 9, 1))

    def upsample_mask(self, net):
        """0.25-scaled convex-upsampling mask head (update.py:122-125,135)."""
        return 0.25 * self.mask(net)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 96, 1)
        self.convf1 = Conv2d(2, 64, 7)
        self.convf2 = Conv2d(64, 32, 3)
        self.conv = Conv2d(128, 80, 3)

    def forward(self, flow, corr):
        """flow (N, 2, H, W), corr (N, corr_planes, H, W) -> (N, 82, H, W)."""
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class ConvGRU(nn.Module):
    """3x3 ConvGRU (update.py:19-31)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cat = hidden_dim + input_dim
        self.convz = Conv2d(cat, hidden_dim, 3)
        self.convr = Conv2d(cat, hidden_dim, 3)
        self.convq = Conv2d(cat, hidden_dim, 3)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q


class SmallUpdateBlock(nn.Module):
    """RAFT-small's update block: no mask head (update.py:99-113)."""

    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.encoder = SmallMotionEncoder(cfg.corr_planes)
        self.gru = ConvGRU(cfg.hidden_dim, 82 + cfg.context_dim)
        self.flow_head = FlowHead(cfg.hidden_dim, 128)


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        planes = cfg.hidden_dim + cfg.context_dim
        if cfg.small:
            self.fnet = SmallEncoder(128, "instance")
            self.cnet = SmallEncoder(planes, "none")
            self.update_block = SmallUpdateBlock(cfg)
        else:
            self.fnet = BasicEncoder(256, "instance")
            self.cnet = BasicEncoder(planes, "batch")
            self.update_block = BasicUpdateBlock(cfg)


def init_raft(cfg: RAFTConfig = RAFTConfig(), seed: int = 0, device=None) -> RAFT:
    """RAFT with weights drawn from `seed`, in eval mode on `device`
    (default cuda; raises without a GPU unless device="cpu")."""
    dev = resolve_device(device)
    return init_weights(RAFT(cfg), seed).to(dev).eval()


def raft_cnet(model: RAFT, images: torch.Tensor):
    """Context encoder on NCHW images -> (net, inp) initial state."""
    out = model.cnet(images)
    hd = model.cfg.hidden_dim
    return torch.tanh(out[:, :hd]), torch.relu(out[:, hd:])


def raft_iterate(model: RAFT, levels, net, inp, iters: int, final_only: bool,
                 flow_init: Optional[torch.Tensor] = None, aggregate=None):
    """The GRU refinement loop on a built pyramid. net/inp (N, C, h8, w8)
    in the compute dtype; flow_init an optional (N, h8, w8, 2) warm start,
    added to the coordinate grid in float32. aggregate: GMA's global
    motion, motion (N, 128, h8, w8) -> (N, 128, h8, w8), whose output joins
    the motion features in the GRU's input (models/gma.py::gma_iterate).
    Returns {"flow_up", "flow_low"[, "predictions"]}."""
    cfg, ub = model.cfg, model.update_block
    cd = cfg.dtype
    n, _, h8, w8 = net.shape
    coords0 = coords_grid(n, h8, w8, device=net.device)
    coords1 = coords0.clone()
    if flow_init is not None:
        flow_init = torch.as_tensor(flow_init, dtype=torch.float32, device=net.device)
        coords1 = (coords1 + flow_init).contiguous()
    if cfg.small:
        def lookup(c):  # the kernel writes the compute dtype itself
            return lookup_corr_level(levels, c, cfg.corr_radius, out_dtype=cd)

        def gru_step(h, motion):
            return ub.gru(h, torch.cat([inp, motion], dim=1))

        def upsample(flow, net):
            return upflow8(flow)
    else:
        def lookup(c):  # the kernel writes the compute dtype itself
            return lookup_corr_fused(levels, c, cfg.corr_radius, out_dtype=cd)

        gru_step = ub.gru.fused_step(inp)

        def upsample(flow, net):
            return convex_upsample(flow, ub.upsample_mask(net).permute(0, 2, 3, 1))
    split = cfg.split_levels
    preds = []
    for _ in range(iters):
        flow = coords1 - coords0
        flow_cd = flow.permute(0, 3, 1, 2).to(cd)
        if split is None:
            corr = lookup(coords1.view(-1, 2)).view(n, h8, w8, -1).permute(0, 3, 1, 2)
            motion = ub.encoder(flow_cd, corr)
        else:
            parts = lookup_corr_split_v2(levels, coords1, cfg.corr_radius, split, cd)
            motion = ub.encoder.forward_split(flow_cd, [p.to(cd) for p in parts])
        if aggregate is not None:
            motion = torch.cat([motion, aggregate(motion)], dim=1)
        net = gru_step(net, motion)
        delta = ub.flow_head(net)
        coords1 = (coords1 + delta.float().permute(0, 2, 3, 1)).contiguous()
        if not final_only:
            preds.append(upsample(coords1 - coords0, net))
    out = {"flow_low": coords1 - coords0}
    if final_only:
        out["flow_up"] = upsample(coords1 - coords0, net)
    else:
        out["flow_up"] = preds[-1]
        out["predictions"] = torch.stack(preds)
    return out


def _as_images(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def raft_forward(model: RAFT, image1, image2, iters: Optional[int] = None,
                 flow_init=None, final_only: bool = False):
    """Flow image1 -> image2; images (N, H, W, 3). flow_init: optional
    (N, H/8, W/8, 2) warm start. Returns flow_up (N, H, W, 2) float32,
    flow_low (N, H/8, W/8, 2) and, unless final_only, the per-iteration
    upsampled `predictions`."""
    dev = next(model.parameters()).device
    frames = torch.stack([_as_images(image1, dev), _as_images(image2, dev)])
    return _pairs(model, frames, (0,), (1,), iters, final_only, flow_init)


@torch.no_grad()
def raft_pairs_forward(model: RAFT, frames, src_idx, dst_idx,
                       iters: Optional[int] = None, final_only: bool = True):
    """Flow for many (src, dst) frame pairs with deduplicated encodes.

    frames (K, N, H, W, 3); src_idx/dst_idx equal-length index tuples. Each
    used frame is fnet-encoded once and each source frame cnet-encoded once
    (AccFlow's 11 clip queries cost 7 fnet + 6 cnet encodes, not 22 + 11).
    Returns flow_up (P*N, H, W, 2), pairs stacked P-major."""
    dev = next(model.parameters()).device
    return _pairs(model, _as_images(frames, dev), src_idx, dst_idx, iters,
                  final_only)["flow_up"]


def _pairs(model, frames, src_idx, dst_idx, iters, final_only, flow_init=None):
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    n = frames.shape[1]
    with tf32(False):
        levels, net_u, inp_u, sel = _encode_pairs(model, frames, src_idx, dst_idx)
        return raft_iterate(model, levels, gather_pairs(net_u, sel, n),
                            gather_pairs(inp_u, sel, n), iters, final_only, flow_init)


def _encode_pairs(model, frames, src_idx, dst_idx):
    """The encodes of the pair queries (src_idx[i] -> dst_idx[i]) on frames
    (K, N, H, W, 3), each used frame fnet-encoded once and each source frame
    cnet-encoded once. Returns (levels, net_u, inp_u, sel): the pyramid of
    the P*N pairs (P-major), the cnet state of the S unique source frames
    ((S*N, C, h8, w8) each) and, per pair, the index of its source among
    them (gather_pairs picks the pairs' rows). Checks corr_lookup "auto"
    against the budget at this shape (resolve_auto_lookup)."""
    cfg = model.cfg
    cd = cfg.dtype
    src_idx = tuple(int(i) for i in src_idx)
    dst_idx = tuple(int(i) for i in dst_idx)
    k, n, h, w, _ = frames.shape
    resolve_auto_lookup(cfg.corr_lookup, len(src_idx) * n, h // 8, w // 8,
                        cfg.corr_levels, cd)
    # Frames and per-frame features are picked by concatenating views, not
    # by indexing with Python lists: a list index becomes a host tensor
    # copied to the device at run time, which a CUDA graph cannot capture.
    used = sorted(set(src_idx) | set(dst_idx))
    pos = {f: i for i, f in enumerate(used)}
    fmaps = model.fnet(to_nchw(_select(frames, used).reshape(-1, h, w, 3), cd))
    fmaps = fmaps.view(len(used), n, *fmaps.shape[1:])
    fmap1 = _select(fmaps, [pos[i] for i in src_idx]).flatten(0, 1)
    fmap2 = _select(fmaps, [pos[i] for i in dst_idx]).flatten(0, 1)
    levels = build_corr_pyramid(fmap1, fmap2, cfg.corr_levels, dtype=cd)
    del fmaps, fmap1, fmap2

    src_used = sorted(set(src_idx))
    spos = {f: i for i, f in enumerate(src_used)}
    net_u, inp_u = raft_cnet(model, to_nchw(_select(frames, src_used).reshape(-1, h, w, 3), cd))
    return levels, net_u, inp_u, [spos[i] for i in src_idx]


def gather_pairs(x_u: torch.Tensor, sel, n: int) -> torch.Tensor:
    """Rows of the unique source frames (S*N, ...) -> the pairs' (P*N, ...):
    pair i takes source sel[i]'s N rows."""
    return _select(x_u.view(-1, n, *x_u.shape[1:]), sel).flatten(0, 1)


def _select(x: torch.Tensor, idx) -> torch.Tensor:
    """x[idx] for a list of ints along dim 0, as one stack of views."""
    return torch.stack([x[i] for i in idx])


@torch.no_grad()
def raft_encode_frame(model: RAFT, image) -> dict:
    """Cacheable per-frame features for streaming (streaming.py): the fnet
    map and the cnet (net, inp) state of (N, H, W, 3) frames. Both encoders
    are per-sample (instance norm, frozen batch norm or none), so encoding
    frames apart is exact against the batched encodes of _pairs."""
    cd = model.cfg.dtype
    x = to_nchw(_as_images(image, next(model.parameters()).device), cd)
    with tf32(False):
        fmap = model.fnet(x)
        net, inp = raft_cnet(model, x)
    return {"fmap": fmap, "net": net, "inp": inp}


@torch.no_grad()
def raft_flow_pairs_from_features(model: RAFT, src: dict, dst_fmaps,
                                  iters: Optional[int] = None, flow_init=None,
                                  final_only: bool = True) -> torch.Tensor:
    """Pair flows src -> each of the P dst maps from precomputed features:
    src is raft_encode_frame of the query frames, dst_fmaps a list of P
    cached fnet maps (the streaming step encodes only the new frame).
    flow_init: optional (P*N, H/8, W/8, 2) warm start. Returns flow_up
    (P*N, H, W, 2), P-major."""
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    p = len(dst_fmaps)
    n, _, h8, w8 = src["fmap"].shape
    resolve_auto_lookup(cfg.corr_lookup, p * n, h8, w8, cfg.corr_levels, cfg.dtype)
    with tf32(False):
        levels = build_corr_pyramid(torch.cat([src["fmap"]] * p),
                                    torch.cat(list(dst_fmaps)), cfg.corr_levels,
                                    dtype=cfg.dtype)
        net = torch.cat([src["net"]] * p)
        inp = torch.cat([src["inp"]] * p)
        return raft_iterate(model, levels, net, inp, iters, final_only,
                            flow_init)["flow_up"]
